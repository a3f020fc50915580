// Per-bounce closest-hit kernel.
//
// Replaces the JAX package's ops/pallas_trace.py:_trace_kernel as launched by
// _merged_pallas_hit: ground, spheres and BVH triangles merged into one
// complete hit record per ray, dead rays reported as misses. It serves the
// bounce loop of render.py when megakernel=False.
//
// Bound on this card: divergent BVH traversal with L2 and device-memory
// latency on node and triangle reads (closest_hit.cuh says what its tables
// do about it). The 14 output rows are coalesced writes and cost little
// beside it. One thread per ray. With a counts pointer it also writes each
// ray's box and triangle tests ((2, n) int32), as the path kernel does.

#include "closest_hit.cuh"

// out: (14, n) rows t, normal xyz, albedo rgb, specular rgb, emission rgb,
// smoothness; t = FLT_MAX on a miss. prim: (n,) winner (see HitRec).
// counts: (2, n) box and triangle tests, or null.
__global__ void urt_trace_hits_kernel(SceneArgs s, const float* __restrict__ ro,
                                      const float* __restrict__ rd,
                                      const float* __restrict__ alive,
                                      float* __restrict__ out,
                                      int* __restrict__ prim,
                                      int* __restrict__ counts, int n,
                                      int* err) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  HitRec h;
  TravCount cnt = {0, 0};
  if (alive[i] > 0.0f) {
    float o[3] = {ro[i], ro[(size_t)n + i], ro[2 * (size_t)n + i]};
    float d[3] = {rd[i], rd[(size_t)n + i], rd[2 * (size_t)n + i]};
    urt_closest_hit(s, o, d, h, err, cnt);
  } else {
    h.t = URT_F32_MAX;
    h.n[0] = h.n[1] = h.n[2] = 0.0f;
    h.mat = -1;
    h.prim = -1;
  }
  float row[14];
  row[0] = h.t;
#pragma unroll
  for (int k = 0; k < 3; ++k) row[1 + k] = h.n[k];
  if (h.mat >= 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      row[4 + k] = s.mat_albedo[3 * h.mat + k];
      row[7 + k] = s.mat_specular[3 * h.mat + k];
      row[10 + k] = s.mat_emission[3 * h.mat + k];
    }
    row[13] = s.mat_smooth[h.mat];
  } else {
#pragma unroll
    for (int k = 4; k < 14; ++k) row[k] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < 14; ++k) out[(size_t)k * n + i] = row[k];
  prim[i] = h.prim;
  if (counts) {
    counts[i] = cnt.box;
    counts[(size_t)n + i] = cnt.tri;
  }
}

extern "C" int urt_trace_hits(const SceneArgs* s, const float* ro,
                              const float* rd, const float* alive, float* out,
                              int* prim, int* counts, int n, int* err,
                              cudaStream_t stream) {
  if (n > 0) {
    const int threads = 128;
    urt_trace_hits_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
        *s, ro, rd, alive, out, prim, counts, n, err);
  }
  return (int)cudaGetLastError();
}
