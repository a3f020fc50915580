// Per-bounce closest-hit kernel.
//
// Replaces the JAX package's ops/pallas_trace.py:_trace_kernel as launched by
// _merged_pallas_hit: ground, spheres and BVH triangles merged into one
// complete hit record per ray, dead rays reported as misses. It serves the
// bounce loop of render.py when megakernel=False, the AOVs and the shards of
// scene sharding.
//
// Bound on this card: divergent BVH traversal with L2 and device-memory
// latency on node and triangle reads (closest_hit.cuh says what its tables
// do about it). The 14 output rows are coalesced writes and cost little
// beside it. One thread per ray. With a counts pointer it also writes each
// ray's box and triangle tests ((2, n) int32), as the path kernel does.
//
// With bin_rays (the JAX kernel's coherence sort, pallas_trace.py:1157-1172
// and :1200-1201) each block of URT_SORT_W threads is one sort window:
// every thread bins its ray (threads past n and dead rays in the dead bin),
// the block sorts the bins stably in shared memory (ray_sort.cuh), each
// ray's origin, direction and index go to their slot, thread j traces the
// ray in slot j, and the rows, prim and counts are written at the ray's own
// index. Rays of
// one direction octant and origin cell share a warp, and dead rays fill the
// block's last warps, which then skip the traversal. The hits do not depend
// on the order, so the rows equal the unsorted kernel's bit for bit. An
// order pointer gets each ray's slot in its window (tests and chip_smoke.py
// hold it against ops/cuda_trace.bin_destinations).

#include "closest_hit.cuh"

// The 14 rows of hit h (t, normal, albedo, specular, emission, smoothness;
// zeros past t on a miss), its winner and its counts, at ray index i.
static __device__ __forceinline__ void urt_write_hit(
    const SceneArgs& s, const HitRec& h, const TravCount& cnt,
    float* __restrict__ out, int* __restrict__ prim, int* __restrict__ counts,
    int n, int i) {
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

static __device__ __forceinline__ void urt_miss(HitRec& h) {
  h.t = URT_F32_MAX;
  h.n[0] = h.n[1] = h.n[2] = 0.0f;
  h.mat = -1;
  h.prim = -1;
}

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
    urt_miss(h);
  }
  urt_write_hit(s, h, cnt, out, prim, counts, n, i);
}

// The sorted launch: URT_SORT_W threads, one sort window, a block. TRACE =
// false skips the traversal (every ray reported a miss): chip_smoke.py
// times the bin, sort and scatter prologue alone with it. order: (n,) slot
// of each ray in its window, or null. Each thread writes the hit it traced
// at its ray's index, without a second barrier: a version that sent the hit
// back through shared memory for coalesced writes measured slower
// (PERF.md).
template <bool TRACE>
__global__ void __launch_bounds__(URT_SORT_W)
    urt_trace_sorted_kernel(SceneArgs s, const float* __restrict__ ro,
                            const float* __restrict__ rd,
                            const float* __restrict__ alive,
                            float* __restrict__ out, int* __restrict__ prim,
                            int* __restrict__ counts, int* __restrict__ order,
                            int n, int* err) {
  __shared__ SortSmem sm;
  __shared__ float so[3][URT_SORT_W];  // the ray in each slot
  __shared__ float sd[3][URT_SORT_W];
  __shared__ int sidx[URT_SORT_W];  // its index: i if alive, ~i if dead
  const int t = threadIdx.x;
  const int i = blockIdx.x * URT_SORT_W + t;
  float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
  const bool live = i < n && alive[i] > 0.0f;
  if (live) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[k] = ro[(size_t)k * n + i];
      d[k] = rd[(size_t)k * n + i];
    }
  }
  const int dst = urt_bin_dest(
      urt_ray_bin(o, d, live, s.bin_cx, s.bin_cy, s.bin_cz), sm);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    so[k][dst] = o[k];
    sd[k][dst] = d[k];
  }
  sidx[dst] = live ? i : ~i;
  if (order && i < n) order[i] = dst;
  __syncthreads();

  const int j = sidx[t];
  const int ri = j >= 0 ? j : ~j;
  if (ri >= n) return;
  HitRec h;
  TravCount cnt = {0, 0};
  if (TRACE && j >= 0) {
    const float oj[3] = {so[0][t], so[1][t], so[2][t]};
    const float dj[3] = {sd[0][t], sd[1][t], sd[2][t]};
    urt_closest_hit(s, oj, dj, h, err, cnt);
  } else {
    urt_miss(h);
  }
  urt_write_hit(s, h, cnt, out, prim, counts, n, ri);
}

// mode 0: rays in their order (128 threads a block; order must be null);
// 1: sorted in windows of `window` rays; 2: the sorted launch without the
// traversal (timing only). A window other than URT_SORT_W
// (ops/cuda_trace.SORT_WINDOW) returns cudaErrorInvalidValue and launches
// nothing.
extern "C" int urt_trace_hits(const SceneArgs* s, const float* ro,
                              const float* rd, const float* alive, float* out,
                              int* prim, int* counts, int* order, int n,
                              int mode, int window, int* err,
                              cudaStream_t stream) {
  if (mode == 0) {
    if (order) return (int)cudaErrorInvalidValue;
    if (n > 0) {
      const int threads = 128;
      urt_trace_hits_kernel<<<(n + threads - 1) / threads, threads, 0,
                              stream>>>(*s, ro, rd, alive, out, prim, counts,
                                        n, err);
    }
    return (int)cudaGetLastError();
  }
  if ((mode != 1 && mode != 2) || window != URT_SORT_W)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = (n + URT_SORT_W - 1) / URT_SORT_W;
  if (mode == 1)
    urt_trace_sorted_kernel<true><<<blocks, URT_SORT_W, 0, stream>>>(
        *s, ro, rd, alive, out, prim, counts, order, n, err);
  else
    urt_trace_sorted_kernel<false><<<blocks, URT_SORT_W, 0, stream>>>(
        *s, ro, rd, alive, out, prim, counts, order, n, err);
  return (int)cudaGetLastError();
}
