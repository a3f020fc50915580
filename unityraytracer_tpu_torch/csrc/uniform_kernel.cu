// Threefry uniform draws: one (n,) row, and the path kernel's whole
// (nb, 5, N) buffer of per-bounce uniform rows in one launch.
//
// Replaces the jax.random.uniform draws of the JAX package's
// render.py:render_sample_mega (camera jitter and lens :465-470, the
// bounce_rows of :495-514, the sky tap :507-509), which XLA fuses into
// elementwise passes around the Pallas path kernel. The JAX package computes
// log2 u1, cos 2 pi u2 and sin 2 pi u2 outside its kernel because Mosaic's
// pow/sin/cos lowerings are slow on the TPU; the port keeps the path
// kernel's (nb, 5, N) interface, so the bounce split's gathers stay as they
// are, and makes the buffer here, where the plain version (rng.uniform_plain
// and render.bounce_rows_plain) spends one int64 torch pass per threefry
// operation: ~30 launches of ~40 passes each per frame.
//
// Bound on this card: integer work. Each draw is 20 rounds of add, rotate
// (one funnel shift) and xor plus the key schedule, ~85 int32 operations,
// and the H100 issues int32 operations at half its float32 rate; a
// (8, 5, 2,073,600) buffer takes ~60M draws and writes 332 MB, ~0.3 ms of
// integer work against ~0.1 ms of bytes. The design: one thread per ray, all
// of that ray's bounces, counters and keys in registers and the kernel's
// parameter space (no key table in device memory, no host-to-device copy),
// each row written once, coalesced across the warp.
//
// Rows per bounce b (render.bounce_rows_plain): u_r; log2(max(u1, 1e-12));
// cos and sin of float32(2 * 3.14159265) * u2; the roulette draw for
// rr_lo <= b < rr_hi, else 1. u_r, u1 and u2 sit at counter i. The roulette
// draw of ray i sits at the pixel-order counter s*h*W + row*W + px, or with
// rr_step at s*Hg*Wg + ((row0 + row) / 8)*Wg + px / 128, where (s, row, px)
// is ray i's sample, band row and column in 8x16 block order (blocked) or
// row-major (render._ray_lattice).

#include <cuda_runtime.h>

#include "threefry.cuh"

#define URT_MAX_BOUNCES 32
// float32(2 * 3.14159265), the product torch forms with the Python scalar.
#define URT_TWO_PI 0x1.921fb6p+2f

// Mirrors the ctypes structure _build.BounceArgs field for field. It is
// passed to the kernel by value.
struct BounceArgs {
  // keys[(b * 4 + row) * 2 + word]: fold_in(fold_in(k_bounce, b), row)
  unsigned int keys[URT_MAX_BOUNCES * 4 * 2];
  int n;       // rays: spp * h * W
  int nb;      // bounces
  int h;       // band rows
  int W;       // image width
  int row0;    // first band row
  int Hg;      // ceil(height / 8): roulette groups down the whole image
  int Wg;      // ceil(W / 128)
  int blocked;
  int rr_step;
  int rr_lo;   // roulette drawn for rr_lo <= b < rr_hi
  int rr_hi;
};

__global__ void urt_uniform_kernel(uint32_t k0, uint32_t k1,
                                   float* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = urt_uniform_at(k0, k1, (uint64_t)i);
}

__global__ void urt_bounce_rows_kernel(BounceArgs a, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int hw = a.h * a.W;
  const int s = i / hw;
  int px, row;
  if (a.blocked) {
    const int w16 = a.W / 16;
    px = (i / 128) % w16 * 16 + i % 16;
    row = (i / (128 * w16)) % (a.h / 8) * 8 + (i / 16) % 8;
  } else {
    px = i % a.W;
    row = (i / a.W) % a.h;
  }
  const uint64_t c_rr =
      a.rr_step ? (uint64_t)s * a.Hg * a.Wg +
                      (uint64_t)((a.row0 + row) / 8) * a.Wg + px / 128
                : (uint64_t)s * hw + (uint64_t)row * a.W + px;
  const size_t n = a.n;
  for (int b = 0; b < a.nb; ++b) {
    // Indexed in place, not through a pointer: the keys stay in the
    // parameter space and no thread copies the struct to local memory.
    const int k = b * 8;
    float* o = out + (size_t)b * 5 * n + i;
    o[0] = urt_uniform_at(a.keys[k], a.keys[k + 1], (uint64_t)i);
    const float u1 = urt_uniform_at(a.keys[k + 2], a.keys[k + 3], (uint64_t)i);
    o[n] = log2f(fmaxf(u1, 1e-12f));
    const float phi =
        URT_TWO_PI * urt_uniform_at(a.keys[k + 4], a.keys[k + 5], (uint64_t)i);
    o[2 * n] = cosf(phi);
    o[3 * n] = sinf(phi);
    o[4 * n] = (b >= a.rr_lo && b < a.rr_hi)
                   ? urt_uniform_at(a.keys[k + 6], a.keys[k + 7], c_rr)
                   : 1.0f;
  }
}

extern "C" int urt_uniform(unsigned int k0, unsigned int k1, float* out,
                           long long n, cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    const long long want = (n + threads - 1) / threads;
    const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
    urt_uniform_kernel<<<blocks, threads, 0, stream>>>(k0, k1, out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int urt_bounce_rows(const BounceArgs* a, float* out,
                               cudaStream_t stream) {
  if (a->n > 0 && a->nb > 0) {
    const int threads = 256;
    urt_bounce_rows_kernel<<<(a->n + threads - 1) / threads, threads, 0,
                             stream>>>(*a, out);
  }
  return (int)cudaGetLastError();
}
