// The rbg streams on the device, bit for bit rng.py's int64 torch version
// and jax.random under impl="rbg" on XLA:CPU.
//
// An rbg key is four words k[0..3]. Keys are derived with threefry on each
// half: fold_in(k, data) is urt_fold_in (threefry.cuh) of (k[0], k[1]) and
// of (k[2], k[3]), which the kernels' prologues hash on two threads, and
// key j of split(k, num) is fold_in(k, j). Bits are Philox4x32-10 under the
// key (k[0], k[1]) of the 128-bit counter k[2] | k[3] << 32 | k[0] << 64 |
// k[1] << 96 plus i >> 2: flat index i takes word i & 3 of that block, so
// one block serves four consecutive counters. The float is the one
// threefry's bits give: the top 23 bits as the mantissa of a float in
// [1, 2), minus 1.

#pragma once

#include <cstdint>

#include "threefry.cuh"

// Philox4x32-10 (Salmon et al., SC'11): ten rounds of two 32x32 -> 64-bit
// products, the key bumped by the Weyl constants after each.
static __device__ __forceinline__ uint4 urt_philox4x32_10(uint32_t k0,
                                                          uint32_t k1,
                                                          uint4 c) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// The Philox block that holds counter i: the key's 128-bit counter plus
// i >> 2, the carry taken from word to word.
static __device__ __forceinline__ uint4 urt_rbg_block(const uint32_t* k,
                                                      uint64_t i) {
  const uint64_t j = i >> 2;
  const uint64_t lo = (((uint64_t)k[3] << 32) | k[2]) + j;
  const uint64_t hi = (((uint64_t)k[1] << 32) | k[0]) + (lo < j ? 1u : 0u);
  return urt_philox4x32_10(
      k[0], k[1],
      make_uint4((uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi,
                 (uint32_t)(hi >> 32)));
}

static __device__ __forceinline__ uint32_t urt_word(uint4 b, uint32_t w) {
  return w == 0 ? b.x : (w == 1 ? b.y : (w == 2 ? b.z : b.w));
}

static __device__ __forceinline__ float urt_unit(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// The uniforms of key k at four counters c[0..3], of which the first nv are
// wanted: one block for every counter in c[0]'s block, one more for each
// wanted counter outside it (the split's ray_index rows, a roulette group
// that straddles two blocks). Entries past nv repeat entry 0's block.
static __device__ __forceinline__ void urt_rbg_uniform4(const uint32_t* k,
                                                        const uint64_t* c,
                                                        int nv, float* u) {
  const uint4 b0 = urt_rbg_block(k, c[0]);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint4 b = b0;
    if (r > 0 && r < nv && (c[r] >> 2) != (c[0] >> 2))
      b = urt_rbg_block(k, c[r]);
    u[r] = urt_unit(urt_word(b, (uint32_t)c[r] & 3u));
  }
}
