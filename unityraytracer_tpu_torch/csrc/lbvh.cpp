// Native host runtime for unityraytracer_tpu_torch: LBVH radix-tree
// construction and Morton sorting (the JAX package's csrc/lbvh.cpp, kept as
// the port's own copy).
//
// The reference builds its BVH on the host in C# (RayTraceMaster.cs:402-746,
// an O(n^3)-per-level agglomerative pairing); our build is a Karras-2012
// binary radix tree over Morton-sorted keys, O(n log n), parallel-friendly.
// This C++ path exists for large-scene rebuild latency (dynamic scenes
// rebuild per dirty frame); unityraytracer_tpu_torch/native.py builds it
// with g++ at first use and falls back to the numpy builder where that
// fails.
//
// Exposed C ABI (ctypes):
//   urt_radix_tree(keys_sorted, n, out_left, out_right)
//   urt_morton_sort(points01, n, out_codes, out_order)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

inline int clz64(uint64_t x) {
#if defined(__GNUC__) || defined(__clang__)
  return x ? __builtin_clzll(x) : 64;
#else
  int n = 0;
  while (n < 64 && !(x & (1ull << 63))) { x <<= 1; ++n; }
  return n;
#endif
}

// Common-prefix length between keys i and j; -1 outside the range.
inline int delta(const uint64_t* keys, int64_t n, int64_t i, int64_t j) {
  if (j < 0 || j >= n) return -1;
  return clz64(keys[i] ^ keys[j]);
}

inline uint64_t expand_bits(uint64_t v) {
  v = (v | (v << 16)) & 0x030000FFull;
  v = (v | (v << 8)) & 0x0300F00Full;
  v = (v | (v << 4)) & 0x030C30C3ull;
  v = (v | (v << 2)) & 0x09249249ull;
  return v;
}

}  // namespace

extern "C" {

// Karras 2012: binary radix tree over n sorted unique 64-bit keys.
// out_left/out_right have length n-1; child index >= n-1 denotes leaf
// (child - (n-1)), matching the Python builder's node layout.
int urt_radix_tree(const uint64_t* keys, int64_t n,
                   int32_t* out_left, int32_t* out_right) {
  if (n < 2) return 0;
  const int64_t leaf0 = n - 1;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n - 1; ++i) {
    const int d = (delta(keys, n, i, i + 1) > delta(keys, n, i, i - 1)) ? 1 : -1;
    const int dmin = delta(keys, n, i, i - d);
    int64_t lmax = 2;
    while (delta(keys, n, i, i + lmax * d) > dmin) lmax *= 2;
    int64_t l = 0;
    for (int64_t t = lmax / 2; t >= 1; t /= 2) {
      if (delta(keys, n, i, i + (l + t) * d) > dmin) l += t;
    }
    const int64_t j = i + l * d;
    const int dnode = delta(keys, n, i, j);
    int64_t s = 0;
    int64_t t = (l + 1) / 2;
    while (true) {
      if (delta(keys, n, i, i + (s + t) * d) > dnode) s += t;
      if (t == 1) break;
      t = (t + 1) / 2;
    }
    const int64_t gamma = i + s * d + std::min<int64_t>(d, 0);
    const int64_t lo = std::min(i, j);
    const int64_t hi = std::max(i, j);
    out_left[i] = static_cast<int32_t>(lo == gamma ? leaf0 + gamma : gamma);
    out_right[i] =
        static_cast<int32_t>(hi == gamma + 1 ? leaf0 + gamma + 1 : gamma + 1);
  }
  return 0;
}

// 30-bit Morton codes for (n,3) float points in [0,1]^3 + stable argsort.
int urt_morton_sort(const float* pts, int64_t n,
                    uint64_t* out_codes, int64_t* out_order) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    uint64_t q[3];
    for (int a = 0; a < 3; ++a) {
      float v = pts[i * 3 + a] * 1024.0f;
      if (v < 0.0f) v = 0.0f;
      if (v > 1023.0f) v = 1023.0f;
      q[a] = static_cast<uint64_t>(v);
    }
    out_codes[i] =
        (expand_bits(q[0]) << 2) | (expand_bits(q[1]) << 1) | expand_bits(q[2]);
  }
  std::iota(out_order, out_order + n, int64_t{0});
  std::stable_sort(out_order, out_order + n, [&](int64_t a, int64_t b) {
    return out_codes[a] < out_codes[b];
  });
  return 0;
}

}  // extern "C"
