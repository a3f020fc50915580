// The ray coherence sort of the closest-hit and path kernels: a stable
// counting sort of one thread block's rays by bin, in shared memory.
//
// Replaces the sort inside the JAX package's Pallas kernels
// (ops/pallas_trace.py:_ray_bin_ids and :_bin_destinations, used by
// _trace_kernel and ops/pallas_path.py:_path_kernel), scheme "oct_cell". A
// ray's bin is its direction octant times one origin-cell bit per axis
// around the centre of the scene's triangle bounds, oct * 8 + cell; dead
// rays go to the last bin (URT_NBINS - 1, the JAX kernel's 64 bins + dead
// padded to 72). The TPU kernel counts with one-hot rows and prefix sums
// along lanes and permutes with exact one-hot matrix products on the MXU.
// Here a block of URT_SORT_W threads is the sort window
// (ops/cuda_trace.SORT_WINDOW):
//   * each warp counts its lanes per bin with __match_any_sync: a lane's
//     rank is the number of lower lanes of its bin, and the lowest lane of
//     a bin writes the warp's count into a (bin, warp) table;
//   * one exclusive scan of the table in bin-major, warp-minor order gives
//     each (bin, warp) its first slot;
//   * slot = scan[bin][warp] + rank.
// So rays of one bin keep their order (stable), the order is the same at
// every run (no atomics) and equals ops/cuda_trace.bin_destinations'.
// Bound: a few hundred instructions and five block barriers a sort; no
// device memory is touched.

#pragma once

#include <cuda_runtime.h>

#define URT_NBINS 72
// Rays sorted together: the sorted launches' block size
// (ops/cuda_trace.SORT_WINDOW).
#define URT_SORT_W 128

struct SortSmem {
  int table[URT_NBINS * (URT_SORT_W / 32)];  // (bin, warp) counts, then slots
  int warp_sums[URT_SORT_W / 32];
};

// Bin of one ray: oct * 8 + cell, or the dead bin. d > 0 is false for -0.0,
// as in the JAX key; the centre (cx, cy, cz) holds the float32 values the
// JAX kernel compares with.
static __device__ __forceinline__ int urt_ray_bin(const float o[3],
                                                  const float d[3], bool alive,
                                                  float cx, float cy,
                                                  float cz) {
  if (!alive) return URT_NBINS - 1;
  const int oct = (d[0] > 0.0f ? 1 : 0) + (d[1] > 0.0f ? 2 : 0) +
                  (d[2] > 0.0f ? 4 : 0);
  const int cell =
      (o[0] > cx ? 1 : 0) + (o[1] > cy ? 2 : 0) + (o[2] > cz ? 4 : 0);
  return oct * 8 + cell;
}

// The slot of this thread's ray in its block's stable sort by bin. Every
// thread of the block calls it (it holds block barriers).
static __device__ __forceinline__ int urt_bin_dest(int bin, SortSmem& sm) {
  constexpr int W = URT_SORT_W, NW = W / 32;
  constexpr int TOT = URT_NBINS * NW;
  constexpr int K = (TOT + W - 1) / W;  // table entries a thread scans
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < TOT; e += W) sm.table[e] = 0;
  __syncthreads();
  const unsigned peers = __match_any_sync(0xffffffffu, bin);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  if (rank == 0) sm.table[bin * NW + warp] = __popc(peers);
  __syncthreads();

  int v[K], sum = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = tid * K + k;
    v[k] = e < TOT ? sm.table[e] : 0;
    sum += v[k];
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) sm.warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < NW ? sm.warp_sums[lane] : 0;
    int wi = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wi, off);
      if (lane >= off) wi += y;
    }
    if (lane < NW) sm.warp_sums[lane] = wi - w;
  }
  __syncthreads();
  int base = sm.warp_sums[warp] + incl - sum;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = tid * K + k;
    if (e < TOT) sm.table[e] = base;
    base += v[k];
  }
  __syncthreads();
  return sm.table[bin * NW + warp] + rank;
}
