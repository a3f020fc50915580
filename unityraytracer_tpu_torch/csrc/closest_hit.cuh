// Closest-hit device function shared by the per-bounce trace kernel
// (trace_kernel.cu) and the path kernel (path_kernel.cu).
//
// Replaces the hit math inside the JAX package's Pallas kernels:
// the JAX package's ops/pallas_trace.py:_ground_sphere_init (ground plane and
// spheres) and :_trace_block (closest triangle). The TPU version culls pages and
// clusters with lane bitmasks, tests triangles as Pluecker edges and picks
// winners with one-hot matrix products; none of that carries over. Here one
// thread holds one ray and walks the ClusterAccel LBVH (ops/bvh.py) from device
// memory with a small stack, testing triangles with the Moller-Trumbore test of
// ops/intersect.py, in the same operation order, so the plain torch version
// (ops/trace.py) gives the same bits when the build keeps -fmad=false.
//
// Winner rules (those of ops/trace.py:trace_brute):
//   * ground first; a sphere must be strictly nearer; among spheres the first
//     minimum wins (argmin);
//   * a triangle must be strictly nearer than the ground/sphere winner; among
//     triangles the nearest wins and an exact tie goes to the lowest index in
//     accel order (argmin over the accel's triangle array).
//
// Bound on this card: divergent traversal. Threads of a warp visit different
// nodes and leaves, and every node and triangle read is a dependent load from
// L2 or device memory, so the kernel waits on loads, not on arithmetic. The
// design cuts what a ray loads and tests, on the tables that
// ops/cuda_trace.kernel_tables derives from the shared ClusterAccel (whose
// 64-triangle leaves are the TPU's lane width):
//   * an inner node is one 64-byte record holding both children's boxes and
//     codes, so a visit tests both children from one parent read (four
//     16-byte loads instead of twelve scalar box loads and two index loads);
//   * a leaf is split into 8 runs of S/8 triangles, each with its exact box;
//     the leaf's 8 boxes (192 bytes) are slab-tested first and MT97 runs only
//     on the runs the ray meets, nearest first, while the bound shrinks;
//   * a triangle is three float4 loads, v0 and the exact edges e1 = v1 - v0,
//     e2 = v2 - v0, instead of nine scalar loads.
// A box test is conservative (below), so no run holding a hit that can win
// is culled, and the tie rule does not depend on visiting order: the winner
// stays the exhaustive plain version's, bit for bit. The ray coherence sort
// (ray_sort.cuh) lives in the kernels around this function: trace_kernel.cu
// with bin_rays, path_kernel.cu at the bounces of ray_bin_bounces. Not done
// (ROADMAP): persistent threads, wide BVHs.

#pragma once

#include <cuda_runtime.h>

#include "ray_sort.cuh"

#define URT_F32_MAX 3.402823466e+38f
#define URT_STACK 64
#define URT_RUNS 8

// Device pointers and sizes of the scene and its kernel tables. Mirrors the
// ctypes structure in _build.py field for field.
struct SceneArgs {
  const float* sph_center;    // (S, 3)
  const float* sph_radius;    // (S,)
  const int* sph_mat;         // (S,)
  int n_spheres;
  const float* mat_albedo;    // (M, 3)
  const float* mat_specular;  // (M, 3)
  const float* mat_emission;  // (M, 3)
  const float* mat_smooth;    // (M,)
  float ground_enabled;
  int ground_mat;
  const float* root_box;      // (8,) root node: lo xyz, hi xyz, 0, 0
  const int* nodes;           // (max(C-1, 1), 16) inner-node records, float
                              // bits: x of (left lo, left hi, right lo,
                              // right hi), then y, then z, then the child
                              // codes (inner node m, or ~k for leaf k), 0, 0
  const float* leaf_boxes;    // (C, 48): leaf k's run boxes as 12 float4,
                              // float4 (side * 3 + axis) * 2 + half holds
                              // runs 4 * half .. 4 * half + 3 (side 0 lo)
  int n_clusters;             // C
  int cluster_size;           // S, a multiple of 8; leaf k holds triangles
                              // [k*S, (k+1)*S), run r of it [k*S + r*S/8, ..)
  const float* tris;          // (C*S, 12): float4 v0, e1, e2 (w = 0), in
                              // accel order
  const float* tri_n0;        // (C*S, 3)
  const float* tri_n1;
  const float* tri_n2;
  const int* tri_mat;         // (C*S,)
  float bin_cx;               // centre of the scene's triangle bounds, the
  float bin_cy;               // origin-cell split of the ray sort
  float bin_cz;               // (ray_sort.cuh)
};

struct HitRec {
  float t;     // URT_F32_MAX on a miss
  float n[3];  // unit shading normal
  int mat;     // material row, -1 on a miss
  int prim;    // triangle index; C*S for the ground; C*S+1+s for sphere s; -1
};

// Box and triangle tests made by one ray, for the traversal-count output.
struct TravCount {
  int box;
  int tri;
};

// Slab test of the box [lo, hi] against the ray. The far distance is widened
// by 1 + 2*gamma(3) so rounding in the six products never culls a box the
// ray meets (the conservative form of PBRT's ray-box test).
static __device__ __forceinline__ bool urt_slab(float lx, float ly, float lz,
                                                float hx, float hy, float hz,
                                                const float o[3],
                                                const float inv[3],
                                                float bound, float& tnear) {
  const float lo[3] = {lx, ly, lz}, hi[3] = {hx, hy, hz};
  float tmin = -URT_F32_MAX, tmax = URT_F32_MAX;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float t1 = (lo[a] - o[a]) * inv[a];
    float t2 = (hi[a] - o[a]) * inv[a];
    tmin = fmaxf(tmin, fminf(t1, t2));
    tmax = fminf(tmax, fmaxf(t1, t2));
  }
  tmax *= 1.0000004f;
  tnear = tmin;
  return tmax >= tmin && tmax > 0.0f && tmin <= bound;
}

static __device__ __forceinline__ float urt_lane(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Moller-Trumbore with backface culling, ops/intersect.py:intersect_triangles
// operation for operation (the edges come precomputed, the same IEEE
// differences).
static __device__ __forceinline__ bool urt_mt97(const float4* tris, int j,
                                                const float o[3],
                                                const float d[3], float& t,
                                                float& u, float& v) {
  const float4 a = __ldg(tris + 3 * j);
  const float4 e1 = __ldg(tris + 3 * j + 1);
  const float4 e2 = __ldg(tris + 3 * j + 2);
  float px = d[1] * e2.z - d[2] * e2.y;
  float py = d[2] * e2.x - d[0] * e2.z;
  float pz = d[0] * e2.y - d[1] * e2.x;
  float det = e1.x * px + e1.y * py + e1.z * pz;
  if (!(det >= 1e-8f)) return false;
  float inv_det = 1.0f / det;
  float tx = o[0] - a.x, ty = o[1] - a.y, tz = o[2] - a.z;
  u = (tx * px + ty * py + tz * pz) * inv_det;
  float qx = ty * e1.z - tz * e1.y;
  float qy = tz * e1.x - tx * e1.z;
  float qz = tx * e1.y - ty * e1.x;
  v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det;
  t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
  return u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f;
}

static __device__ __forceinline__ float urt_safe_inv(float d) {
  float c = fabsf(d) < 1e-12f ? (d < 0.0f ? -1e-12f : 1e-12f) : d;
  return 1.0f / c;
}

static __device__ __forceinline__ void urt_normalize(float n[3]) {
  float dd = n[0] * n[0] + n[1] * n[1] + n[2] * n[2];
  float inv = 1.0f / sqrtf(fmaxf(dd, 1e-20f));
  n[0] = n[0] * inv;
  n[1] = n[1] * inv;
  n[2] = n[2] * inv;
}

// The triangles of leaf k that can beat the current winner: the leaf's run
// boxes slab-tested against min(tt, tgs), then MT97 on the runs the ray
// meets, nearest box first, each against the bound as it stands.
static __device__ __forceinline__ void urt_leaf(
    const SceneArgs& s, int k, const float o[3], const float d[3],
    const float inv[3], float tgs, float& tt, float& tu, float& tv, int& ti,
    TravCount& cnt) {
  const float4* lb = reinterpret_cast<const float4*>(s.leaf_boxes) + 12 * k;
  const float bound = fminf(tt, tgs);
  float tn[URT_RUNS];
  unsigned int mask = 0u;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float4 lx = __ldg(lb + half), ly = __ldg(lb + 2 + half),
                 lz = __ldg(lb + 4 + half), hx = __ldg(lb + 6 + half),
                 hy = __ldg(lb + 8 + half), hz = __ldg(lb + 10 + half);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (urt_slab(urt_lane(lx, c), urt_lane(ly, c), urt_lane(lz, c),
                   urt_lane(hx, c), urt_lane(hy, c), urt_lane(hz, c), o, inv,
                   bound, tn[half * 4 + c]))
        mask |= 1u << (half * 4 + c);
    }
  }
  cnt.box += URT_RUNS;
  const float4* tris = reinterpret_cast<const float4*>(s.tris);
  const int run = s.cluster_size / URT_RUNS;
  while (mask) {
    int best = -1;
    float bt = 0.0f;
#pragma unroll
    for (int q = 0; q < URT_RUNS; ++q) {
      if (((mask >> q) & 1u) && (best < 0 || tn[q] < bt)) {
        bt = tn[q];
        best = q;
      }
    }
    mask &= ~(1u << best);
    // Nearest first: every run left starts at bt or farther.
    if (bt > fminf(tt, tgs)) break;
    const int j0 = k * s.cluster_size + best * run;
    for (int j = j0; j < j0 + run; ++j) {
      float t, u, v;
      ++cnt.tri;
      if (urt_mt97(tris, j, o, d, t, u, v) && t < tgs &&
          (t < tt || (t == tt && j < ti))) {
        tt = t;
        ti = j;
        tu = u;
        tv = v;
      }
    }
  }
}

// Nearest hit of ray (o, d). On a traversal-stack overflow it sets *err and
// stops; the flag stays set until the host reads it and raises
// (_build.raise_on_overflow), so no node is dropped silently. `cnt` gains
// the box and triangle tests the ray made.
static __device__ void urt_closest_hit(const SceneArgs& s, const float o[3],
                                       const float d[3], HitRec& h, int* err,
                                       TravCount& cnt) {
  // Ground plane y = 0 (intersect_ground).
  float safe_dy = fabsf(d[1]) < 1e-20f ? 1e-20f : d[1];
  float tg = -o[1] / safe_dy;
  if (!(tg > 0.0f) || !(s.ground_enabled > 0.0f)) tg = URT_F32_MAX;

  // Spheres (intersect_spheres).
  float ts = URT_F32_MAX;
  int si = -1;
  for (int k = 0; k < s.n_spheres; ++k) {
    const float* c = s.sph_center + 3 * k;
    float r = s.sph_radius[k];
    float ocx = o[0] - c[0], ocy = o[1] - c[1], ocz = o[2] - c[2];
    float p1 = -(d[0] * ocx + d[1] * ocy + d[2] * ocz);
    float p2sqr = p1 * p1 - (ocx * ocx + ocy * ocy + ocz * ocz) + r * r;
    float p2 = sqrtf(fmaxf(p2sqr, 0.0f));
    float tn = p1 - p2;
    float t = tn > 0.0f ? tn : p1 + p2;
    if (!(p2sqr >= 0.0f && t > 0.0f)) t = URT_F32_MAX;
    if (t < ts) {
      ts = t;
      si = k;
    }
  }
  bool sphere_wins = ts < tg;
  float tgs = sphere_wins ? ts : tg;

  // Triangles: LBVH stack traversal, nearer child popped first. A stack
  // entry is a child code: inner node m >= 0, or ~k for leaf k.
  float inv[3] = {urt_safe_inv(d[0]), urt_safe_inv(d[1]), urt_safe_inv(d[2])};
  float tt = URT_F32_MAX, tu = 0.0f, tv = 0.0f;
  int ti = -1;
  int stack[URT_STACK];
  float stack_t[URT_STACK];
  int sp = 0;
  float tn;
  const float* rb = s.root_box;
  ++cnt.box;
  if (urt_slab(rb[0], rb[1], rb[2], rb[3], rb[4], rb[5], o, inv, tgs, tn)) {
    stack[0] = s.n_clusters > 1 ? 0 : ~0;
    stack_t[0] = tn;
    sp = 1;
  }
  const float4* nodes = reinterpret_cast<const float4*>(s.nodes);
  while (sp > 0) {
    --sp;
    const int code = stack[sp];
    const float bound = fminf(tt, tgs);
    if (stack_t[sp] > bound) continue;
    if (code < 0) {
      urt_leaf(s, ~code, o, d, inv, tgs, tt, tu, tv, ti, cnt);
      continue;
    }
    const float4 X = __ldg(nodes + 4 * code), Y = __ldg(nodes + 4 * code + 1),
                 Z = __ldg(nodes + 4 * code + 2);
    const int4 ch = __ldg(reinterpret_cast<const int4*>(nodes + 4 * code + 3));
    float tl, tr;
    bool hl = urt_slab(X.x, Y.x, Z.x, X.y, Y.y, Z.y, o, inv, bound, tl);
    bool hr = urt_slab(X.z, Y.z, Z.z, X.w, Y.w, Z.w, o, inv, bound, tr);
    cnt.box += 2;
    if (sp + 2 > URT_STACK) {
      atomicOr(err, 1);
      break;
    }
    const int l = ch.x, r = ch.y;
    if (hl && hr) {
      bool left_first = tl <= tr;
      stack[sp] = left_first ? r : l;
      stack_t[sp] = left_first ? tr : tl;
      stack[sp + 1] = left_first ? l : r;
      stack_t[sp + 1] = left_first ? tl : tr;
      sp += 2;
    } else if (hl || hr) {
      stack[sp] = hl ? l : r;
      stack_t[sp] = hl ? tl : tr;
      sp += 1;
    }
  }

  const int n_tris = s.n_clusters * s.cluster_size;
  if (ti >= 0) {
    // Barycentric smooth normal: (n0 * w + n1 * u) + n2 * v, normalized.
    const float* n0 = s.tri_n0 + 3 * ti;
    const float* n1 = s.tri_n1 + 3 * ti;
    const float* n2 = s.tri_n2 + 3 * ti;
    float w = 1.0f - tu - tv;
#pragma unroll
    for (int k = 0; k < 3; ++k) h.n[k] = n0[k] * w + n1[k] * tu + n2[k] * tv;
    urt_normalize(h.n);
    h.t = tt;
    h.mat = s.tri_mat[ti];
    h.prim = ti;
  } else if (sphere_wins) {
    const float* c = s.sph_center + 3 * si;
#pragma unroll
    for (int k = 0; k < 3; ++k) h.n[k] = (o[k] + d[k] * ts) - c[k];
    urt_normalize(h.n);
    h.t = ts;
    h.mat = s.sph_mat[si];
    h.prim = n_tris + 1 + si;
  } else if (tg < URT_F32_MAX) {
    h.n[0] = 0.0f;
    h.n[1] = 1.0f;
    h.n[2] = 0.0f;
    h.t = tg;
    h.mat = s.ground_mat;
    h.prim = n_tris;
  } else {
    h.n[0] = h.n[1] = h.n[2] = 0.0f;
    h.t = URT_F32_MAX;
    h.mat = -1;
    h.prim = -1;
  }
}
