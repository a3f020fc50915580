// What the kernels that walk a frame's rays share (urt_bounce_rows,
// urt_camera_rays, and their rbg modes, which give a thread four rays):
// ray i's place in the lattice, four rays' stores, and a grid of
// one wave of resident blocks walking the rays in a grid-stride loop, so
// that each block pays its key prologue once.

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

// (s, row, px) of rays i0 .. i0 + 3 (i0 % 4 == 0), of which the first nv
// exist. Where W % 4 == 0 the four share their sample and row and take
// columns px .. px + 3 (in block order W % 16 == 0 and i0 % 16 <= 12);
// otherwise each ray gets its own, and rays past nv repeat ray i0's.
static __device__ __forceinline__ void urt_ray_lattice4(int i0, int nv, int h,
                                                        int W, int blocked,
                                                        int* s, int* row,
                                                        int* px) {
  if ((W & 3) == 0) {
    urt_ray_lattice(i0, h, W, blocked, s[0], row[0], px[0]);
#pragma unroll
    for (int r = 1; r < 4; ++r) {
      s[r] = s[0];
      row[r] = row[0];
      px[r] = px[0] + r;
    }
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      urt_ray_lattice(i0 + (r < nv ? r : 0), h, W, blocked, s[r], row[r],
                      px[r]);
  }
}

// Four consecutive floats of a row at p, of which the first nv exist: one
// 16-byte store where `vec` (p 16-byte aligned and nv == 4), else one float
// at a time.
static __device__ __forceinline__ void urt_store4(float* p, const float* v,
                                                  int nv, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (r < nv) p[r] = v[r];
  }
}

// Cards whose occupancy urt_wave_blocks keeps (one past them is asked at
// every call).
#define URT_MAX_CARDS 64

// Blocks for n items of `threads` threads: the SMs times the blocks of
// `kernel` an SM holds at once, or fewer when n needs fewer. The occupancy
// is asked on the current card's first call and kept in cache[card]; the
// wrappers make the card of the launch's tensors current
// (_build.on_card), so each card keeps its own.
template <typename Kernel>
static int urt_wave_blocks(Kernel kernel, int threads, long long n,
                           int* cache) {
  int dev = 0, fresh = 0;
  cudaGetDevice(&dev);
  int* wave = dev >= 0 && dev < URT_MAX_CARDS ? &cache[dev] : &fresh;
  if (*wave == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  0);
    *wave = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  const long long want = (n + threads - 1) / threads;
  return (int)(want < *wave ? want : *wave);
}
