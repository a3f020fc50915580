// One level of the edge-avoiding a-trous denoiser (utils/denoise.py).
//
// Replaces the JAX package's utils/denoise.py:atrous_denoise (:65-89), which
// has no Pallas kernel: XLA fuses its 25 shifted slices of an edge-padded
// image into dense vector code on the TPU. Written as plain torch ops the
// same level is ~25 taps x ~20 launches over the whole (H, W, 3) image; here
// it is one launch per level.
//
// Each thread computes one pixel of the (H, W, 3) float32 image: for the 25
// taps (dy-major, dx-minor) at offsets (dy, dx) * step it reads the tap's
// color, and its albedo and normal where guides are given, from the row and
// column clamped to the image (the JAX package's edge pad of 2 * step, which
// clamps exactly for these offsets), and accumulates
//   logw = -((e0^2 + e1^2) + e2^2) * inv_c - sum_g ((g0^2 + g1^2) + g2^2) * inv_g
//   w = w_k * expf(logw);  acc += tap * w;  wsum += w
// then writes acc / max(wsum, 1e-12) with an IEEE division. The operations
// are spelt with the round-to-nearest intrinsics, so no multiply-add is
// contracted whatever the flags, and they run in the plain version's order
// (atrous_denoise_plain), which torch evaluates one op at a time.
//
// Bound on this card: at 1080p a level moves ~50 MB (the image read and
// written once) or ~100 MB with both guides, 0.015-0.030 ms at 3.35 TB/s,
// and does 29 (unguided) to 49 (two guides) float operations a tap: 19, 10
// more for each guide, and expf counted as its 10 SASS instructions
// (chip_smoke.py, sass_counts): 0.0224-0.0379 ms at 67 TFLOP/s. The design
// is the simple one: one thread per pixel in 32 x 8 blocks, the taps read
// through the read-only cache, where neighbouring threads share rows of the
// image; no shared-memory tile yet.

#include <cuda_runtime.h>

// Weights of the 5x5 B3-spline kernel, w_k = kTap[dy + 2] * kTap[dx + 2]:
// multiples of 1/256, exact in float32.
__constant__ float kTap[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f,
                              4.0f / 16.0f, 1.0f / 16.0f};

// (a0 - b0)^2 + (a1 - b1)^2, then + (a2 - b2)^2: the plain version's order.
__device__ __forceinline__ float urt_dist2(const float* __restrict__ a,
                                           const float b[3]) {
  const float e0 = __fsub_rn(__ldg(a), b[0]);
  const float e1 = __fsub_rn(__ldg(a + 1), b[1]);
  const float e2 = __fsub_rn(__ldg(a + 2), b[2]);
  return __fadd_rn(__fadd_rn(__fmul_rn(e0, e0), __fmul_rn(e1, e1)),
                   __fmul_rn(e2, e2));
}

// NG guides (0, 1 or 2), in the filter's order.
template <int NG>
__global__ void urt_atrous_kernel(const float* __restrict__ src,
                                  float* __restrict__ dst,
                                  const float* __restrict__ g0,
                                  const float* __restrict__ g1, int H, int W,
                                  int step, float inv_c, float inv_g0,
                                  float inv_g1) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const float* guide[2] = {g0, g1};
  const float inv_g[2] = {inv_g0, inv_g1};
  const size_t p = ((size_t)y * W + x) * 3;
  const float c[3] = {src[p], src[p + 1], src[p + 2]};
  float gc[2][3];
#pragma unroll
  for (int k = 0; k < NG; ++k)
    for (int ch = 0; ch < 3; ++ch) gc[k][ch] = guide[k][p + ch];

  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, wsum = 0.0f;
#pragma unroll
  for (int dy = -2; dy <= 2; ++dy) {
    const int yy = min(max(y + dy * step, 0), H - 1);
#pragma unroll
    for (int dx = -2; dx <= 2; ++dx) {
      const int xx = min(max(x + dx * step, 0), W - 1);
      const size_t q = ((size_t)yy * W + xx) * 3;
      const float s0 = __ldg(src + q), s1 = __ldg(src + q + 1),
                  s2 = __ldg(src + q + 2);
      float logw = __fmul_rn(-urt_dist2(src + q, c), inv_c);
#pragma unroll
      for (int k = 0; k < NG; ++k)
        logw = __fsub_rn(logw,
                         __fmul_rn(urt_dist2(guide[k] + q, gc[k]), inv_g[k]));
      const float w = __fmul_rn(__fmul_rn(kTap[dy + 2], kTap[dx + 2]),
                                expf(logw));
      acc0 = __fadd_rn(acc0, __fmul_rn(s0, w));
      acc1 = __fadd_rn(acc1, __fmul_rn(s1, w));
      acc2 = __fadd_rn(acc2, __fmul_rn(s2, w));
      wsum = __fadd_rn(wsum, w);
    }
  }
  // torch.clamp_min and jnp.maximum keep a NaN; fmaxf would drop it.
  const float den = isnan(wsum) ? wsum : fmaxf(wsum, 1e-12f);
  dst[p] = __fdiv_rn(acc0, den);
  dst[p + 1] = __fdiv_rn(acc1, den);
  dst[p + 2] = __fdiv_rn(acc2, den);
}

// One level: src -> dst (distinct buffers), dilation ``step``. g0/g1 are the
// guides in the filter's order (NULL where absent; g1 only with g0).
extern "C" int urt_atrous(const float* src, float* dst, const float* g0,
                          const float* g1, int H, int W, int step, float inv_c,
                          float inv_g0, float inv_g1, cudaStream_t stream) {
  if (H > 0 && W > 0) {
    const dim3 threads(32, 8);
    const dim3 blocks((W + 31) / 32, (H + 7) / 8);
    if (g1 != nullptr)
      urt_atrous_kernel<2><<<blocks, threads, 0, stream>>>(
          src, dst, g0, g1, H, W, step, inv_c, inv_g0, inv_g1);
    else if (g0 != nullptr)
      urt_atrous_kernel<1><<<blocks, threads, 0, stream>>>(
          src, dst, g0, g1, H, W, step, inv_c, inv_g0, inv_g1);
    else
      urt_atrous_kernel<0><<<blocks, threads, 0, stream>>>(
          src, dst, g0, g1, H, W, step, inv_c, inv_g0, inv_g1);
  }
  return (int)cudaGetLastError();
}
