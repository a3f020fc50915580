// Sky tap: for each ray, its two sky draws, the stochastic texel pick, the
// RGBE fetch and decode, and the compose into the radiance, in one launch.
//
// Replaces the JAX package's two env kernels, ops/pallas_env.py:_env_kernel8
// (the packed words, impls "int8x8" and "bf16x8") and :_env_kernel (the
// (H, 4W) byte-plane table, impl "bf16"), both launched through
// sample_skybox_rgbe_mxu by render.py:_env_tap, together with what XLA runs
// around them: the two sky uniforms of render_sample_mega (render.py:507-509),
// the texel pick (_equirect_coords and the corner choice,
// pallas_env.py:235-237) and the compose radiance + sky_e * sky
// (render.py:531-532). The TPU kernels turn the per-ray gather into one-hot
// matrix products because a TPU gathers serially; a GPU gathers natively, so
// the fetch is a plain load, and everything around it moves into the same
// thread instead of some forty elementwise passes over (N,) rows in HBM.
//
// One thread per ray:
// * counter c: i; or ray_index[i] (the split's compact buffer holds rays of
//   the full-width frame, and each keeps its own draws); or, for a bounce
//   loop whose rays run in pixel order at a size that tiles into 8x16 blocks
//   (render._draw_fn's to_pixel_order), ray i's block slot, computed here
//   from the lattice (h, W, spp) rather than passed as an index row;
// * u1, u2 = threefry uniforms of the keys fold_in(fold_in(k_bounce,
//   bounces), 0 | 1) at counter c, the keys passed by value;
// * the pick of ops/shade.py:_equirect_coords and pick_texel, op for op:
//   the divisions are IEEE divisions, as the plain version's divisions by a
//   float32 tensor are (-fmad=false keeps every product and sum rounded on
//   its own), negations stay negations so signed zeros reach atan2f as they
//   do in torch, and the integer remainder takes the divisor's sign;
// * the fetch and the decode byte * scale[e] through the 256-entry table of
//   ops/shade.py (2^(e-136) as the JAX package evaluates it; 0 for e == 0),
//   so both fetch modes give the same bits;
// * rad[k] = rad[k] + sky_e[k] * tap[k], in place: sky_e and sky_d are
//   read, only the radiance rows are written.
//
// Bound on this card: memory. 48 bytes a ray (radiance, sky throughput and
// sky direction read, radiance written) against two threefry draws, ~160
// int32 operations; the sky map (512 KB packed for the 256x512 bench sky)
// stays in L2. Nothing is written but the radiance.
//
// The rbg mode (rng_impl="rbg", philox.cuh) takes two 4-word keys. The
// counters of four neighbouring rays (i, or the block slots of four
// neighbouring pixels) share one Philox block of each key, so one block
// serves four draws (uniform_kernel.cu says why): the four lanes of a quad
// make the two blocks once and share the words by shuffles, and the tap
// stays one ray a thread. (Four rays a thread, with 16-byte row accesses,
// ran slower than the threefry tap on the H100: the tap is bound by its
// bytes, and a quarter of the threads hid its fetches less.)

#include <cuda_runtime.h>

#include "philox.cuh"
#include "threefry.cuh"

// float32(3.14159265) and float32(2.0 * 3.14159265): ops/sampling.py:PI as
// the plain version's 0-dim float32 divisors hold it.
#define URT_SKY_PI 0x1.921fb6p+1f
#define URT_SKY_TWO_PI 0x1.921fb6p+2f

struct SkyRows {
  float* rad[3];
  const float* e[3];
  const float* d[3];
};

// The packed (H*W,) int32 words: e << 24 | r << 16 | g << 8 | b.
struct PackedFetch {
  static __device__ __forceinline__ void fetch(const void* table,
                                               const float* scale, int w,
                                               int yn, int xn, float& r,
                                               float& g, float& b) {
    const unsigned int word =
        ((const unsigned int*)table)[(size_t)yn * w + xn];
    const float sc = scale[word >> 24];
    r = (float)((word >> 16) & 0xFFu) * sc;
    g = (float)((word >> 8) & 0xFFu) * sc;
    b = (float)(word & 0xFFu) * sc;
  }
};

// The (H, 4W) uint8 byte planes r, g, b, e side by side
// (ops/cuda_env.py:byte_planes).
struct PlanesFetch {
  static __device__ __forceinline__ void fetch(const void* table,
                                               const float* scale, int w,
                                               int yn, int xn, float& r,
                                               float& g, float& b) {
    const unsigned char* t =
        (const unsigned char*)table + (size_t)yn * 4 * w + xn;
    const float sc = scale[t[3 * (size_t)w]];
    r = (float)t[0] * sc;
    g = (float)t[w] * sc;
    b = (float)t[2 * (size_t)w] * sc;
  }
};

// Ray i's counter: i, ray_index[i], or its block slot in a pixel-order
// lattice of lat_h x lat_w pixels (lat_w > 0).
static __device__ __forceinline__ uint64_t urt_sky_counter(
    int i, const long long* __restrict__ ray_index, int lat_h, int lat_w) {
  if (ray_index != nullptr) return (uint64_t)ray_index[i];
  if (lat_w <= 0) return (uint64_t)i;
  const long long hw = (long long)lat_h * lat_w;
  const long long s = i / hw;
  const int rem = (int)(i - s * hw);
  const int row = rem / lat_w, px = rem - row * lat_w;
  return (uint64_t)(s * hw + (long long)(row >> 3) * 8 * lat_w +
                    (px >> 4) * 128 + (row & 7) * 16 + (px & 15));
}

// The texel that direction (dx, dy, dz) picks with draws u1, u2, fetched
// and decoded into tap[0..2].
template <class Fetch>
static __device__ __forceinline__ void urt_sky_pick_fetch(
    const void* table, const float* scale, int H, int W, float dx, float dy,
    float dz, float u1, float u2, float* tap) {
  // torch.clamp passes NaN through; so does this.
  float y = dy;
  y = y < -1.0f ? -1.0f : (y > 1.0f ? 1.0f : y);
  const float row01 = __fdiv_rn(acosf(y), URT_SKY_PI);
  const float nz = -dz;
  const float col = fmodf(__fdiv_rn(-atan2f(dx, nz), URT_SKY_TWO_PI), 1.0f);
  const float col01 = col < 0.0f ? col + 1.0f : col;
  const float fy = row01 * (float)H - 0.5f;
  const float fx = col01 * (float)W - 0.5f;
  const float y0f = floorf(fy), x0f = floorf(fx);
  const int yi = (int)y0f, xi = (int)x0f;
  const int y0 = min(max(yi, 0), H - 1);
  const int y1 = min(max(yi + 1, 0), H - 1);
  const int x0 = (xi % W + W) % W;
  const int x1 = ((xi + 1) % W + W) % W;
  const int yn = u1 < fy - y0f ? y1 : y0;
  const int xn = u2 < fx - x0f ? x1 : x0;
  Fetch::fetch(table, scale, W, yn, xn, tap[0], tap[1], tap[2]);
}

template <class Fetch>
__global__ void urt_sky_tap_kernel(SkyRows rows,
                                   const void* __restrict__ table,
                                   const float* __restrict__ scale, int H,
                                   int W, uint32_t k0, uint32_t k1,
                                   uint32_t k2, uint32_t k3,
                                   const long long* __restrict__ ray_index,
                                   int lat_h, int lat_w, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint64_t c = urt_sky_counter(i, ray_index, lat_h, lat_w);
  const float u1 = urt_uniform_at(k0, k1, c);
  const float u2 = urt_uniform_at(k2, k3, c);
  float tap[3];
  urt_sky_pick_fetch<Fetch>(table, scale, H, W, rows.d[0][i], rows.d[1][i],
                            rows.d[2][i], u1, u2, tap);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    rows.rad[k][i] = rows.rad[k][i] + rows.e[k][i] * tap[k];
}

// The two rbg keys, four words each.
struct SkyKeys {
  uint32_t k[8];
};

// The rbg tap: the same counters, pick, fetch and compose as
// urt_sky_tap_kernel, one ray a thread. Lane k of each aligned quad makes
// key k & 1's Philox block at the quad's first counter, and the quad hands
// the words round with shuffles; a lane whose counter lies in another block
// (a ray_index row) makes its own two. Lanes past n take part in the
// shuffles and leave after them.
template <class Fetch>
__global__ void urt_sky_tap_rbg_kernel(SkyRows rows,
                                       const void* __restrict__ table,
                                       const float* __restrict__ scale, int H,
                                       int W, SkyKeys keys,
                                       const long long* __restrict__ ray_index,
                                       int lat_h, int lat_w, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const uint64_t c = urt_sky_counter(live ? i : n - 1, ray_index, lat_h,
                                     lat_w);
  const int lane = threadIdx.x & 31, base = lane & ~3;
  const uint64_t c0 = __shfl_sync(0xFFFFFFFFu, c, base);
  const bool odd = lane & 1;
  const uint32_t kq[4] = {odd ? keys.k[4] : keys.k[0],
                          odd ? keys.k[5] : keys.k[1],
                          odd ? keys.k[6] : keys.k[2],
                          odd ? keys.k[7] : keys.k[3]};
  const uint4 b = urt_rbg_block(kq, c0);
  const uint32_t w = (uint32_t)c & 3u;
  uint32_t bits1 = 0u, bits2 = 0u;
#pragma unroll
  for (uint32_t t = 0; t < 4; ++t) {
    const uint32_t word = urt_word(b, t);
    const uint32_t v1 = __shfl_sync(0xFFFFFFFFu, word, base);
    const uint32_t v2 = __shfl_sync(0xFFFFFFFFu, word, base + 1);
    if (w == t) {
      bits1 = v1;
      bits2 = v2;
    }
  }
  if ((c >> 2) != (c0 >> 2)) {
    bits1 = urt_word(urt_rbg_block(keys.k, c), w);
    bits2 = urt_word(urt_rbg_block(keys.k + 4, c), w);
  }
  if (!live) return;
  float tap[3];
  urt_sky_pick_fetch<Fetch>(table, scale, H, W, rows.d[0][i], rows.d[1][i],
                            rows.d[2][i], urt_unit(bits1), urt_unit(bits2),
                            tap);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    rows.rad[k][i] = rows.rad[k][i] + rows.e[k][i] * tap[k];
}

// planes != 0: table is the byte-plane table, else the packed words.
// ray_index may be null; lat_w > 0 selects the block-slot counter. The keys:
// k0, k1 and k2, k3 under threefry (k4-k7 unread); k0-k3 and k4-k7 under
// rbg.
extern "C" int urt_sky_tap(float* rad0, float* rad1, float* rad2,
                           const float* e0, const float* e1, const float* e2,
                           const float* d0, const float* d1, const float* d2,
                           const void* table, int planes, const float* scale,
                           int H, int W, unsigned int k0, unsigned int k1,
                           unsigned int k2, unsigned int k3, unsigned int k4,
                           unsigned int k5, unsigned int k6, unsigned int k7,
                           int rbg, const long long* ray_index, int lat_h,
                           int lat_w, int n, cudaStream_t stream) {
  if (n > 0 && rbg) {
    const SkyRows rows = {{rad0, rad1, rad2}, {e0, e1, e2}, {d0, d1, d2}};
    const SkyKeys keys = {{k0, k1, k2, k3, k4, k5, k6, k7}};
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    if (planes)
      urt_sky_tap_rbg_kernel<PlanesFetch><<<blocks, threads, 0, stream>>>(
          rows, table, scale, H, W, keys, ray_index, lat_h, lat_w, n);
    else
      urt_sky_tap_rbg_kernel<PackedFetch><<<blocks, threads, 0, stream>>>(
          rows, table, scale, H, W, keys, ray_index, lat_h, lat_w, n);
  } else if (n > 0) {
    const SkyRows rows = {{rad0, rad1, rad2}, {e0, e1, e2}, {d0, d1, d2}};
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    if (planes)
      urt_sky_tap_kernel<PlanesFetch><<<blocks, threads, 0, stream>>>(
          rows, table, scale, H, W, k0, k1, k2, k3, ray_index, lat_h, lat_w,
          n);
    else
      urt_sky_tap_kernel<PackedFetch><<<blocks, threads, 0, stream>>>(
          rows, table, scale, H, W, k0, k1, k2, k3, ray_index, lat_h, lat_w,
          n);
  }
  return (int)cudaGetLastError();
}
