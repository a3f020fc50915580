// Sky-tap kernel: one packed RGBE texel per ray, decoded.
//
// Replaces the JAX package's ops/pallas_env.py:_env_kernel8 (launched by
// _env_lookup8 through sample_skybox_rgbe_mxu). The TPU kernel turns the
// per-ray gather into one-hot matrix products because a TPU gathers serially;
// a GPU gathers natively, so this is the gather itself: word = plane[yn*W+xn],
// then byte * scale[e] with the 256-entry decode table of ops/shade.py
// (2^(e-136) as the JAX package evaluates it; 0 for e == 0), bit-identical to
// the plain version. The texel pick (equirect angles, stochastic corner) stays
// in torch outside the kernel, as it stays in XLA in the JAX package.
//
// Bound on this card: memory. 12 bytes of ray indices and output per ray,
// a 4-byte gather from a plane that stays in L2 (512 KB for the 256x512 bench
// sky). Nothing to do about it in this first version.

#include <cuda_runtime.h>

__global__ void urt_env_kernel(const int* __restrict__ plane,
                               const float* __restrict__ scale,
                               const int* __restrict__ yn,
                               const int* __restrict__ xn, int w,
                               float* __restrict__ out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned int word = (unsigned int)plane[(size_t)yn[i] * w + xn[i]];
  const float sc = scale[word >> 24];
  out[i] = (float)((word >> 16) & 0xFFu) * sc;
  out[(size_t)n + i] = (float)((word >> 8) & 0xFFu) * sc;
  out[2 * (size_t)n + i] = (float)(word & 0xFFu) * sc;
}

extern "C" int urt_env_lookup(const int* plane, const float* scale,
                              const int* yn, const int* xn, int w, float* out,
                              int n, cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    urt_env_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
        plane, scale, yn, xn, w, out, n);
  }
  return (int)cudaGetLastError();
}
