// Threefry uniform draws: one (n,) row, and the path kernel's whole
// (nb, 5, N) buffer of per-bounce uniform rows in one launch.
//
// Replaces the jax.random.uniform draws of the JAX package's
// render.py:render_sample_mega (camera jitter and lens :465-470, which
// camera_kernel.cu draws on the megakernel frame; the bounce_rows of
// :495-514; the sky tap :507-509), which XLA fuses into
// elementwise passes around the Pallas path kernel. The JAX package computes
// log2 u1, cos 2 pi u2 and sin 2 pi u2 outside its kernel because Mosaic's
// pow/sin/cos lowerings are slow on the TPU; the port keeps the path
// kernel's (nb, 5, N) interface, so the bounce split's gathers stay as they
// are, and makes the buffer here, where the plain version (rng.uniform_plain
// and render.bounce_rows_plain) spends one int64 torch pass per threefry
// operation: ~30 launches of ~40 passes each per frame.
//
// Bound on this card: integer work. Each draw is 20 rounds of add, rotate
// (one funnel shift) and xor plus the key schedule, 52 integer-ALU SASS
// instructions, and the H100 issues int32 operations at half its float32
// rate; a (8, 5, 2,073,600) buffer takes ~60M draws and writes 332 MB,
// ~0.19 ms of integer work against ~0.1 ms of bytes. The design: one thread
// per ray, all of that ray's bounces, its counters in registers, each row
// written once, coalesced across the warp.
//
// The keys are derived here, not on the host: the kernel takes k_bounce's two
// words, and a prologue of each block hashes the nb bounce keys
// fold_in(k_bounce, b) (one thread each), then the 4 * nb row keys
// fold_in(kb, row) (one thread each), into shared memory, with a barrier
// after each level. The host hashes nothing for the rows (hashing their
// 5 * nb keys in Python cost the host more than the kernel's run). The grid
// is one wave of resident blocks (lattice.cuh) walking the rays in a
// grid-stride loop, so the prologue's 5 * nb hashes are paid once a block:
// at 1080p x 8, ~800 blocks x 40 hashes against ~60M draws, 0.05%.
//
// Rows per bounce b (render.bounce_rows_plain): u_r; log2(max(u1, 1e-12));
// cos and sin of float32(2 * 3.14159265) * u2; the roulette draw for
// rr_lo <= b < rr_hi, else 1. u_r, u1 and u2 sit at counter i. The roulette
// draw of ray i sits at the pixel-order counter s*h*W + row*W + px, or with
// rr_step at s*Hg*Wg + ((row0 + row) / 8)*Wg + px / 128, where (s, row, px)
// is ray i's sample, band row and column in 8x16 block order (blocked) or
// row-major (render._ray_lattice).

#include <cuda_runtime.h>

#include "lattice.cuh"
#include "threefry.cuh"

#define URT_MAX_BOUNCES 32
// float32(2 * 3.14159265), the product torch forms with the Python scalar.
#define URT_TWO_PI 0x1.921fb6p+2f

// Mirrors the ctypes structure _build.BounceArgs field for field. It is
// passed to the kernel by value.
struct BounceArgs {
  unsigned int k0;  // k_bounce
  unsigned int k1;
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

// Threads a block of urt_bounce_rows: the prologue gives one thread to
// each of the 4 * URT_MAX_BOUNCES row keys.
#define URT_ROWS_THREADS 256
static_assert(URT_ROWS_THREADS >= 4 * URT_MAX_BOUNCES,
              "one prologue thread a row key");

__global__ void urt_uniform_kernel(uint32_t k0, uint32_t k1,
                                   float* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = urt_uniform_at(k0, k1, (uint64_t)i);
}

__global__ void __launch_bounds__(URT_ROWS_THREADS)
    urt_bounce_rows_kernel(BounceArgs a, float* __restrict__ out) {
  // kb[2 * b + word]: fold_in(k_bounce, b); keys[(b * 4 + row) * 2 + word]:
  // fold_in(kb, row), the keys of rng.bounce_keys.
  __shared__ uint32_t kb[URT_MAX_BOUNCES * 2];
  __shared__ uint32_t keys[URT_MAX_BOUNCES * 4 * 2];
  const int t = threadIdx.x;
  if (t < a.nb) urt_fold_in(a.k0, a.k1, t, kb[2 * t], kb[2 * t + 1]);
  __syncthreads();
  if (t < 4 * a.nb)
    urt_fold_in(kb[2 * (t >> 2)], kb[2 * (t >> 2) + 1], t & 3, keys[2 * t],
                keys[2 * t + 1]);
  __syncthreads();

  const int hw = a.h * a.W;
  const size_t n = a.n;
  // Unsigned: i + stride stays below 2^32 for n < 2^31.
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned iu = blockIdx.x * blockDim.x + t; iu < (unsigned)a.n;
       iu += stride) {
    const int i = (int)iu;
    int s, row, px;
    urt_ray_lattice(i, a.h, a.W, a.blocked, s, row, px);
    const uint64_t c_rr =
        a.rr_step ? (uint64_t)s * a.Hg * a.Wg +
                        (uint64_t)((a.row0 + row) / 8) * a.Wg + px / 128
                  : (uint64_t)s * hw + (uint64_t)row * a.W + px;
    for (int b = 0; b < a.nb; ++b) {
      const uint32_t* k = keys + b * 8;
      float* o = out + (size_t)b * 5 * n + i;
      o[0] = urt_uniform_at(k[0], k[1], (uint64_t)i);
      const float u1 = urt_uniform_at(k[2], k[3], (uint64_t)i);
      o[n] = log2f(fmaxf(u1, 1e-12f));
      const float phi = URT_TWO_PI * urt_uniform_at(k[4], k[5], (uint64_t)i);
      o[2 * n] = cosf(phi);
      o[3 * n] = sinf(phi);
      o[4 * n] = (b >= a.rr_lo && b < a.rr_hi)
                     ? urt_uniform_at(k[6], k[7], c_rr)
                     : 1.0f;
    }
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
  static int wave = 0;
  if (a->n > 0 && a->nb > 0) {
    const int blocks = urt_wave_blocks(urt_bounce_rows_kernel,
                                       URT_ROWS_THREADS, a->n, &wave);
    urt_bounce_rows_kernel<<<blocks, URT_ROWS_THREADS, 0, stream>>>(*a, out);
  }
  return (int)cudaGetLastError();
}
