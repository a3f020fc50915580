// Threefry-2x32 on the device, bit for bit rng.py's int64 torch version and
// jax.random's threefry2x32 (20 rounds, jax_threefry_partitionable=True).
//
// uniform(key, i) is the float rng.uniform(key, shape) puts at flat index i:
// the hash of the counter pair (i >> 32, i & 0xFFFFFFFF), its two output
// words XORed, the top 23 bits as the mantissa of a float in [1, 2), minus 1.

#pragma once

#include <cstdint>

static __device__ __forceinline__ uint32_t urt_rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// The rotations and key schedule of rng.py:threefry2x32.
static __device__ __forceinline__ void urt_threefry2x32(uint32_t k0,
                                                        uint32_t k1,
                                                        uint32_t& x0,
                                                        uint32_t& x1) {
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = urt_rotl(x1, kRot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// fold_in(key, data) of rng.py, the hash of the counter pair (0, data); key
// j of split(key, num) is the same hash with data = j.
static __device__ __forceinline__ void urt_fold_in(uint32_t k0, uint32_t k1,
                                                   uint32_t data, uint32_t& o0,
                                                   uint32_t& o1) {
  uint32_t x0 = 0u, x1 = data;
  urt_threefry2x32(k0, k1, x0, x1);
  o0 = x0;
  o1 = x1;
}

static __device__ __forceinline__ float urt_uniform_at(uint32_t k0,
                                                       uint32_t k1,
                                                       uint64_t i) {
  uint32_t x0 = (uint32_t)(i >> 32), x1 = (uint32_t)i;
  urt_threefry2x32(k0, k1, x0, x1);
  const uint32_t bits = x0 ^ x1;
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}
