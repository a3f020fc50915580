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

// Byte-plane sky tap: the same fetch and decode from the (H, 4W) byte-plane
// table, one plane each for r, g, b and e (ops/cuda_env.py:byte_planes).
//
// Replaces the JAX package's ops/pallas_env.py:_env_kernel (launched by
// _env_lookup through sample_skybox_rgbe_mxu with impl="bf16"). The TPU
// kernel contracts a one-hot row matrix with the bf16 table on the MXU and
// picks the column with a one-hot mask; both are exact, so each ray gets the
// four bytes at (yn, p*W + xn). Here one thread per ray reads those four
// bytes and decodes them through the same 256-entry scale table as the
// packed-word kernel above; the (steps, 8, B) padded output of the TPU
// kernel is its own layout and is not carried over: the output is (3, n).
//
// Bound on this card: memory. Four byte reads per ray from a table that
// stays in L2 (512 KB for the 256x512 bench sky), 8 bytes of texel indices
// in and 12 bytes of output per ray. This first version does nothing more.
// CUDA C++ rather than Triton: it is a gather, and it builds into the same
// library as the other kernels.
__global__ void urt_env_planes_kernel(const unsigned char* __restrict__ tab,
                                      const float* __restrict__ scale,
                                      const int* __restrict__ yn,
                                      const int* __restrict__ xn, int w,
                                      float* __restrict__ out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned char* t = tab + (size_t)yn[i] * 4 * w + xn[i];
  const float sc = scale[t[3 * (size_t)w]];
  out[i] = (float)t[0] * sc;
  out[(size_t)n + i] = (float)t[w] * sc;
  out[2 * (size_t)n + i] = (float)t[2 * (size_t)w] * sc;
}

extern "C" int urt_env_lookup_planes(const unsigned char* tab,
                                     const float* scale, const int* yn,
                                     const int* xn, int w, float* out, int n,
                                     cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    urt_env_planes_kernel<<<(n + threads - 1) / threads, threads, 0,
                            stream>>>(tab, scale, yn, xn, w, out, n);
  }
  return (int)cudaGetLastError();
}
