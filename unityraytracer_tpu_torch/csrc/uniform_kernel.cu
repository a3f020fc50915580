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
//
// The rbg mode (rng_impl="rbg", philox.cuh) draws the same rows from a
// 4-word k_bounce: the prologue derives the same keys with both halves
// hashed (two threads a key), and the draws are Philox4x32-10, whose one
// block holds the words of four consecutive counters. A thread that made a
// block for one word would do four times the work, some 75 integer
// instructions a draw against threefry's 52; so in this mode a thread owns
// four consecutive rays i0 .. i0 + 3 (i0 % 4 == 0), whose u_r, u1 and u2
// sit in one block of each key, and whose roulette counters share one block
// too on the main path's layouts (consecutive 4-aligned pixel counters; one
// 8x128 group's counter under rr_step), with a block of its own for any
// that does not. The rows go out as one 16-byte store a row where n % 4 ==
// 0. A block's ten rounds of two wide products and two three-way XORs serve
// four draws, so this mode's bound is expected to be the rows' bytes (332 MB
// at 1080p x 8, ~0.1 ms at 3.35 TB/s); chip_smoke.py counts a block's SASS.

#include <cuda_runtime.h>

#include "lattice.cuh"
#include "philox.cuh"
#include "threefry.cuh"

#define URT_MAX_BOUNCES 32
// float32(2 * 3.14159265), the product torch forms with the Python scalar.
#define URT_TWO_PI 0x1.921fb6p+2f

// Mirrors the ctypes structure _build.BounceArgs field for field. It is
// passed to the kernel by value.
struct BounceArgs {
  unsigned int k0;  // k_bounce: words 0-1 (threefry) or 0-3 (rbg)
  unsigned int k1;
  unsigned int k2;
  unsigned int k3;
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
  int rbg;     // 1: the rbg streams (philox.cuh), 0: threefry
};

// Threads a block of urt_bounce_rows: the prologue gives one thread to
// each of the 4 * URT_MAX_BOUNCES row keys, in the rbg mode to each half.
#define URT_ROWS_THREADS 256
static_assert(URT_ROWS_THREADS >= 8 * URT_MAX_BOUNCES,
              "one prologue thread a row key's half");

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

// The rbg row: thread q writes out[4q .. 4q + 3] from Philox block q.
__global__ void urt_uniform_rbg_kernel(uint4 key, float* __restrict__ out,
                                       long long n) {
  const uint32_t k[4] = {key.x, key.y, key.z, key.w};
  const long long nq = (n + 3) >> 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       q < nq; q += stride) {
    const long long i0 = 4 * q;
    const uint4 b = urt_rbg_block(k, (uint64_t)i0);
    const float v[4] = {urt_unit(b.x), urt_unit(b.y), urt_unit(b.z),
                        urt_unit(b.w)};
    const int nv = n - i0 < 4 ? (int)(n - i0) : 4;
    urt_store4(out + i0, v, nv, nv == 4);
  }
}

// The rbg rows: the same rows, keys and counters as urt_bounce_rows_kernel,
// four rays a thread.
__global__ void __launch_bounds__(URT_ROWS_THREADS)
    urt_bounce_rows_rbg_kernel(BounceArgs a, float* __restrict__ out) {
  // kb[4 * b + word]: fold_in(k_bounce, b); keys[(b * 4 + row) * 4 + word]:
  // fold_in(kb, row); thread t hashes half t & 1 of key t >> 1.
  __shared__ uint32_t kb[URT_MAX_BOUNCES * 4];
  __shared__ uint32_t keys[URT_MAX_BOUNCES * 4 * 4];
  const int t = threadIdx.x;
  if (t < 2 * a.nb)
    urt_fold_in(t & 1 ? a.k2 : a.k0, t & 1 ? a.k3 : a.k1, t >> 1, kb[2 * t],
                kb[2 * t + 1]);
  __syncthreads();
  if (t < 8 * a.nb) {
    const uint32_t* src = kb + 4 * (t >> 3) + 2 * (t & 1);
    urt_fold_in(src[0], src[1], (t >> 1) & 3, keys[2 * t], keys[2 * t + 1]);
  }
  __syncthreads();

  const int hw = a.h * a.W;
  const size_t n = a.n;
  const bool vec = (a.n & 3) == 0;
  const unsigned nq = ((unsigned)a.n + 3) >> 2;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned q = blockIdx.x * blockDim.x + t; q < nq; q += stride) {
    const int i0 = 4 * (int)q;
    const int nv = min(4, a.n - i0);
    int s[4], row[4], px[4];
    urt_ray_lattice4(i0, nv, a.h, a.W, a.blocked, s, row, px);
    uint64_t c_rr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      c_rr[r] = a.rr_step
                    ? (uint64_t)s[r] * a.Hg * a.Wg +
                          (uint64_t)((a.row0 + row[r]) / 8) * a.Wg +
                          px[r] / 128
                    : (uint64_t)s[r] * hw + (uint64_t)row[r] * a.W + px[r];
    for (int b = 0; b < a.nb; ++b) {
      const uint32_t* k = keys + b * 16;
      const uint4 w_r = urt_rbg_block(k, (uint64_t)i0);
      const uint4 w_1 = urt_rbg_block(k + 4, (uint64_t)i0);
      const uint4 w_2 = urt_rbg_block(k + 8, (uint64_t)i0);
      float v[5][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        v[0][r] = urt_unit(urt_word(w_r, r));
        v[1][r] = log2f(fmaxf(urt_unit(urt_word(w_1, r)), 1e-12f));
        const float phi = URT_TWO_PI * urt_unit(urt_word(w_2, r));
        v[2][r] = cosf(phi);
        v[3][r] = sinf(phi);
        v[4][r] = 1.0f;
      }
      if (b >= a.rr_lo && b < a.rr_hi)
        urt_rbg_uniform4(k + 12, c_rr, nv, v[4]);
      float* o = out + (size_t)b * 5 * n + i0;
#pragma unroll
      for (int row_ = 0; row_ < 5; ++row_)
        urt_store4(o + row_ * n, v[row_], nv, vec);
    }
  }
}

extern "C" int urt_uniform(unsigned int k0, unsigned int k1, unsigned int k2,
                           unsigned int k3, int rbg, float* out, long long n,
                           cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    const long long items = rbg ? (n + 3) / 4 : n;
    const long long want = (items + threads - 1) / threads;
    const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
    if (rbg)
      urt_uniform_rbg_kernel<<<blocks, threads, 0, stream>>>(
          make_uint4(k0, k1, k2, k3), out, n);
    else
      urt_uniform_kernel<<<blocks, threads, 0, stream>>>(k0, k1, out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int urt_bounce_rows(const BounceArgs* a, float* out,
                               cudaStream_t stream) {
  static int wave[URT_MAX_CARDS] = {}, wave_rbg[URT_MAX_CARDS] = {};
  if (a->n > 0 && a->nb > 0) {
    if (a->rbg) {
      const int blocks =
          urt_wave_blocks(urt_bounce_rows_rbg_kernel, URT_ROWS_THREADS,
                          ((long long)a->n + 3) / 4, wave_rbg);
      urt_bounce_rows_rbg_kernel<<<blocks, URT_ROWS_THREADS, 0, stream>>>(
          *a, out);
    } else {
      const int blocks = urt_wave_blocks(urt_bounce_rows_kernel,
                                         URT_ROWS_THREADS, a->n, wave);
      urt_bounce_rows_kernel<<<blocks, URT_ROWS_THREADS, 0, stream>>>(*a,
                                                                      out);
    }
  }
  return (int)cudaGetLastError();
}
