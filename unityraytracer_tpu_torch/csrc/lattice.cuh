// What the kernels that walk a frame's rays share (urt_bounce_rows,
// urt_camera_rays): ray i's place in the lattice, and a grid of one wave of
// resident blocks walking the rays in a grid-stride loop, so that each block
// pays its key prologue once.

#pragma once

#include <cuda_runtime.h>

// Sample s, band row and column px of ray i (render._ray_lattice): 8x16
// pixel-block order when `blocked`, row-major otherwise.
static __device__ __forceinline__ void urt_ray_lattice(int i, int h, int W,
                                                       int blocked, int& s,
                                                       int& row, int& px) {
  s = i / (h * W);
  if (blocked) {
    const int w16 = W / 16;
    px = (i / 128) % w16 * 16 + i % 16;
    row = (i / (128 * w16)) % (h / 8) * 8 + (i / 16) % 8;
  } else {
    px = i % W;
    row = (i / W) % h;
  }
}

// Blocks for n items of `threads` threads: the SMs times the blocks of
// `kernel` an SM holds at once, or fewer when n needs fewer. The occupancy
// is asked on the first call and kept in *cache (one card model a process).
template <typename Kernel>
static int urt_wave_blocks(Kernel kernel, int threads, long long n,
                           int* cache) {
  if (*cache == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  0);
    *cache = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  const long long want = (n + threads - 1) / threads;
  return (int)(want < *cache ? want : *cache);
}
