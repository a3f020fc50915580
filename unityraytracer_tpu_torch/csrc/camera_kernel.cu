// Camera rays: a frame's (or band's, or chunk's) jittered thin-lens primary
// rays, from the frame key to ro and rd, in one launch.
//
// Replaces the camera lines of the JAX package's render.py:render_sample_mega
// (:460-473): the key split, the four jax.random.uniform draws (jitter x, y
// and the lens pair), the ray lattice, u and v, ops/sampling.py's
// sample_unit_disk and camera.py's camera_rays_soa, which XLA fuses into one
// elementwise pass. The port ran them as four threefry launches and ~70
// torch passes over (N,) rows; here each ray is one thread, and nothing but
// ro and rd reaches device memory.
//
// Keys on the card: the kernel takes the frame key's two words. A prologue
// of each block hashes k_jit and k_lens (split(key, 3)[0 | 1], the same hash
// as fold_in(key, 0 | 1)), then their fold_in(., 0 | 1), one thread a key,
// into shared memory, with a barrier after each level; no thread re-derives
// the keys on its own (6 hashes against its 4 draws). The grid is one wave
// of resident blocks walking the rays in a grid-stride loop (lattice.cuh), so
// the prologue is paid once a block.
//
// Ray i, in the order render._camera_rays returns:
// * (s, row, px) from the lattice (render._ray_lattice): 8x16 block order
//   when `blocked`, row-major otherwise; py = H - 1 - (row0 + row);
// * the draws at counter i, or, for rays in pixel order at a size that tiles
//   into 8x16 blocks (`pixel_order`, render._draw_fn), at the pixel's block
//   slot s*h*W + (row/8)*(W/16)*128 + (px/16)*128 + (row%8)*16 + px%16;
// * u = (px + jx) / W * 2 - 1 and v alike with py, jy and H, with IEEE
//   divisions (render.camera_rays_plain divides by a tensor, so that torch's
//   CUDA division does not turn into a product with the reciprocal);
// * the disk sample and the camera op for op as the plain version's torch
//   ops round them: -fmad=false keeps each product and sum rounded on its
//   own, sqrtf and the divisions (__fdiv_rn) are IEEE, cosf and sinf are the
//   CUDA math library's, as in torch's CUDA kernels, and the clamps let NaN
//   through as torch's clamp_min does.
//
// Bound on this card: integer work. Four threefry draws a ray, 52
// integer-ALU SASS instructions each: 2,073,600 rays at 1080p are ~0.026 ms
// at the int32 rate, against 24 bytes a ray written (~0.015 ms) and ~80
// float operations a ray (~0.003 ms).
//
// The rbg mode (rng_impl="rbg", philox.cuh) takes the frame key's four
// words; its prologue derives the same keys with both halves hashed (two
// threads a key), and a thread owns four consecutive rays, whose counters
// (ray indices, or block slots of four neighbouring pixels) share one
// Philox block of each of the four keys: one block serves four draws
// (uniform_kernel.cu says why). ro and rd go out as 16-byte stores where
// n % 4 == 0.

#include <cuda_runtime.h>

#include "lattice.cuh"
#include "philox.cuh"
#include "threefry.cuh"

// float32(2 * 3.14159265): ops/sampling.py's 2.0 * PI as torch rounds the
// Python product.
#define URT_CAM_TWO_PI 0x1.921fb6p+2f
// float32(1e-20) and float32(1e-6), the clamps of ops/vec.py:normalize and
// camera.py:camera_rays_soa.
#define URT_CAM_EPS_NORM 0x1.79ca1p-67f
#define URT_CAM_EPS_COS 0x1.0c6f7ap-20f
#define URT_CAM_THREADS 256

// Mirrors the ctypes structure _build.CameraArgs field for field. It is
// passed to the kernel by value; the camera's numbers are float32 as
// camera.py rounds them.
struct CameraArgs {
  unsigned int k0;  // the frame key: words 0-1 (threefry) or 0-3 (rbg)
  unsigned int k1;
  unsigned int k2;
  unsigned int k3;
  int n;            // rays: spp * h * W
  int h;            // band rows
  int W;            // image width
  int H;            // image height
  int row0;         // first band row
  int blocked;      // 8x16 block order
  int pixel_order;  // draws at the block slots (render._pixel_order)
  float m[12];      // rows 0-2 of cam_to_world, row-major
  float thf;        // tan_half_fov
  float thf_aspect; // float32(tan_half_fov * aspect)
  float focus;      // focus_dist
  float aperture;
  int rbg;          // 1: the rbg streams (philox.cuh), 0: threefry
};

// torch.clamp_min(x, lo): NaN stays NaN.
static __device__ __forceinline__ float urt_clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// ops/vec.py:normalize: a * (1 / sqrt(max(dot(a, a), 1e-20))).
static __device__ __forceinline__ void urt_normalize(float& x, float& y,
                                                     float& z) {
  const float inv = __fdiv_rn(
      1.0f, sqrtf(urt_clamp_min(x * x + y * y + z * z, URT_CAM_EPS_NORM)));
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

// The draws' counter of ray i at (s, row, px): i, or in pixel order its
// 8x16 block slot.
static __device__ __forceinline__ uint64_t urt_camera_counter(
    const CameraArgs& a, int i, int s, int row, int px) {
  return a.pixel_order ? (uint64_t)s * a.h * a.W +
                             (uint64_t)(row / 8) * (a.W / 16) * 128 +
                             (px / 16) * 128 + (row % 8) * 16 + px % 16
                       : (uint64_t)i;
}

// Ray (row, px) of the lattice from its four draws: ro = ray[0..2], rd =
// ray[3..5], op for op as render.camera_rays_plain rounds them.
static __device__ __forceinline__ void urt_camera_ray(const CameraArgs& a,
                                                      int row, int px,
                                                      float jx, float jy,
                                                      float lu1, float lu2,
                                                      float* ray) {
  const float* m = a.m;
  const int py = (a.H - 1) - (a.row0 + row);
  const float u = __fdiv_rn((float)px + jx, (float)a.W) * 2.0f - 1.0f;
  const float v = __fdiv_rn((float)py + jy, (float)a.H) * 2.0f - 1.0f;
  // ops/sampling.py:sample_unit_disk.
  const float r = sqrtf(lu1);
  const float phi = URT_CAM_TWO_PI * lu2;
  const float lens_u = r * cosf(phi);
  const float lens_v = r * sinf(phi);

  // camera.py:camera_rays_soa.
  const float dx = u * a.thf_aspect;
  const float dy = v * a.thf;
  float d0 = m[0] * dx + m[1] * dy + m[2];
  float d1 = m[4] * dx + m[5] * dy + m[6];
  float d2 = m[8] * dx + m[9] * dy + m[10];
  urt_normalize(d0, d1, d2);
  const float cos_fwd = d0 * m[2] + d1 * m[6] + d2 * m[10];
  const float focus_t =
      __fdiv_rn(a.focus, urt_clamp_min(cos_fwd, URT_CAM_EPS_COS));
  const float f0 = m[3] + d0 * focus_t;
  const float f1 = m[7] + d1 * focus_t;
  const float f2 = m[11] + d2 * focus_t;
  const float lu = lens_u * a.aperture;
  const float lv = lens_v * a.aperture;
  const float o0 = m[3] + m[0] * lu + m[1] * lv;
  const float o1 = m[7] + m[4] * lu + m[5] * lv;
  const float o2 = m[11] + m[8] * lu + m[9] * lv;
  d0 = f0 - o0;
  d1 = f1 - o1;
  d2 = f2 - o2;
  urt_normalize(d0, d1, d2);

  ray[0] = o0;
  ray[1] = o1;
  ray[2] = o2;
  ray[3] = d0;
  ray[4] = d1;
  ray[5] = d2;
}

__global__ void __launch_bounds__(URT_CAM_THREADS)
    urt_camera_rays_kernel(CameraArgs a, float* __restrict__ out) {
  // parent[2 * j + word]: split(key, 3)[j] for j = 0 (jitter), 1 (lens);
  // keys[2 * (2 * j + r) + word]: fold_in(parent j, r).
  __shared__ uint32_t parent[4];
  __shared__ uint32_t keys[8];
  const int t = threadIdx.x;
  if (t < 2) urt_fold_in(a.k0, a.k1, t, parent[2 * t], parent[2 * t + 1]);
  __syncthreads();
  if (t < 4)
    urt_fold_in(parent[2 * (t >> 1)], parent[2 * (t >> 1) + 1], t & 1,
                keys[2 * t], keys[2 * t + 1]);
  __syncthreads();

  const size_t n = a.n;
  // Unsigned: i + stride stays below 2^32 for n < 2^31.
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned iu = blockIdx.x * blockDim.x + t; iu < (unsigned)a.n;
       iu += stride) {
    const int i = (int)iu;
    int s, row, px;
    urt_ray_lattice(i, a.h, a.W, a.blocked, s, row, px);
    const uint64_t c = urt_camera_counter(a, i, s, row, px);
    const float jx = urt_uniform_at(keys[0], keys[1], c);
    const float jy = urt_uniform_at(keys[2], keys[3], c);
    const float lu1 = urt_uniform_at(keys[4], keys[5], c);
    const float lu2 = urt_uniform_at(keys[6], keys[7], c);

    float ray[6];
    urt_camera_ray(a, row, px, jx, jy, lu1, lu2, ray);
    for (int k = 0; k < 6; ++k) out[k * n + i] = ray[k];
  }
}

// The rbg rays: the same keys, counters and camera as
// urt_camera_rays_kernel, four rays a thread.
__global__ void __launch_bounds__(URT_CAM_THREADS)
    urt_camera_rays_rbg_kernel(CameraArgs a, float* __restrict__ out) {
  // parent[4 * j + word]: split(key, 3)[j]; keys[4 * (2 * j + r) + word]:
  // fold_in(parent j, r); thread t hashes half t & 1 of key t >> 1.
  __shared__ uint32_t parent[8];
  __shared__ uint32_t keys[16];
  const int t = threadIdx.x;
  if (t < 4)
    urt_fold_in(t & 1 ? a.k2 : a.k0, t & 1 ? a.k3 : a.k1, t >> 1,
                parent[2 * t], parent[2 * t + 1]);
  __syncthreads();
  if (t < 8) {
    const uint32_t* src = parent + 4 * (t >> 2) + 2 * (t & 1);
    urt_fold_in(src[0], src[1], (t >> 1) & 1, keys[2 * t], keys[2 * t + 1]);
  }
  __syncthreads();

  const size_t n = a.n;
  const bool vec = (a.n & 3) == 0;
  const unsigned nq = ((unsigned)a.n + 3) >> 2;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned q = blockIdx.x * blockDim.x + t; q < nq; q += stride) {
    const int i0 = 4 * (int)q;
    const int nv = min(4, a.n - i0);
    int s[4], row[4], px[4];
    urt_ray_lattice4(i0, nv, a.h, a.W, a.blocked, s, row, px);
    uint64_t c[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      c[r] = urt_camera_counter(a, i0 + (r < nv ? r : 0), s[r], row[r], px[r]);
    float u[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) urt_rbg_uniform4(keys + 4 * k, c, nv, u[k]);
    float ray[6][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float one[6];
      urt_camera_ray(a, row[r], px[r], u[0][r], u[1][r], u[2][r], u[3][r],
                     one);
#pragma unroll
      for (int k = 0; k < 6; ++k) ray[k][r] = one[k];
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) urt_store4(out + k * n + i0, ray[k], nv, vec);
  }
}

// out: (6, n) float32, rows ro x, y, z and rd x, y, z.
extern "C" int urt_camera_rays(const CameraArgs* a, float* out,
                               cudaStream_t stream) {
  static int wave[URT_MAX_CARDS] = {}, wave_rbg[URT_MAX_CARDS] = {};
  if (a->n > 0 && a->rbg) {
    const int blocks =
        urt_wave_blocks(urt_camera_rays_rbg_kernel, URT_CAM_THREADS,
                        ((long long)a->n + 3) / 4, wave_rbg);
    urt_camera_rays_rbg_kernel<<<blocks, URT_CAM_THREADS, 0, stream>>>(*a,
                                                                       out);
  } else if (a->n > 0) {
    const int blocks =
        urt_wave_blocks(urt_camera_rays_kernel, URT_CAM_THREADS, a->n, wave);
    urt_camera_rays_kernel<<<blocks, URT_CAM_THREADS, 0, stream>>>(*a, out);
  }
  return (int)cudaGetLastError();
}
