// Closest-hit device function shared by the per-bounce trace kernel
// (trace_kernel.cu) and the path kernel (path_kernel.cu).
//
// Replaces the hit math inside the JAX package's Pallas kernels:
// the JAX package's ops/pallas_trace.py:_ground_sphere_init (ground plane and
// spheres) and :_trace_block (closest triangle). The TPU version culls pages and
// clusters with lane bitmasks, tests triangles as Pluecker edges and picks
// winners with one-hot matrix products; none of that carries over. Here one
// thread holds one ray and walks the ClusterAccel LBVH (ops/bvh.py) from device
// memory with a small stack, testing each leaf cluster's triangles with the
// Moller-Trumbore test of ops/intersect.py, in the same operation order, so the
// plain torch version (ops/trace.py) gives the same bits when the build keeps
// -fmad=false.
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
// device memory (L2 at best). Nothing in this first version addresses it: one
// thread per ray, no ray sorting, no wide nodes, no shared-memory staging.

#pragma once

#include <cuda_runtime.h>

#define URT_F32_MAX 3.402823466e+38f
#define URT_STACK 64

// Device pointers and sizes of the scene and its accel. Mirrors the ctypes
// structure in _build.py field for field.
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
  const float* node_vmin;     // (2C-1, 3)
  const float* node_vmax;     // (2C-1, 3)
  const int* node_left;       // (2C-1,) child node, -1 on leaves
  const int* node_right;      // (2C-1,)
  int n_clusters;             // C; leaf k is node C-1+k
  int cluster_size;           // S; leaf k holds triangles [k*S, (k+1)*S)
  const float* tri_v0;        // (C*S, 3) in accel order
  const float* tri_v1;
  const float* tri_v2;
  const float* tri_n0;
  const float* tri_n1;
  const float* tri_n2;
  const int* tri_mat;         // (C*S,)
};

struct HitRec {
  float t;     // URT_F32_MAX on a miss
  float n[3];  // unit shading normal
  int mat;     // material row, -1 on a miss
  int prim;    // triangle index; C*S for the ground; C*S+1+s for sphere s; -1
};

// Slab test of node `node` against the ray. The far distance is widened by
// 1 + 2*gamma(3) so rounding in the six products never culls a box the ray
// meets (the conservative form of PBRT's ray-box test).
static __device__ __forceinline__ bool urt_box(const SceneArgs& s, int node,
                                        const float o[3], const float inv[3],
                                        float bound, float& tnear) {
  float tmin = -URT_F32_MAX, tmax = URT_F32_MAX;
  const float* lo = s.node_vmin + 3 * node;
  const float* hi = s.node_vmax + 3 * node;
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

// Moller-Trumbore with backface culling, ops/intersect.py:intersect_triangles
// operation for operation.
static __device__ __forceinline__ bool urt_mt97(const SceneArgs& s, int j,
                                         const float o[3], const float d[3],
                                         float& t, float& u, float& v) {
  const float* a = s.tri_v0 + 3 * j;
  const float* b = s.tri_v1 + 3 * j;
  const float* c = s.tri_v2 + 3 * j;
  float e1x = b[0] - a[0], e1y = b[1] - a[1], e1z = b[2] - a[2];
  float e2x = c[0] - a[0], e2y = c[1] - a[1], e2z = c[2] - a[2];
  float px = d[1] * e2z - d[2] * e2y;
  float py = d[2] * e2x - d[0] * e2z;
  float pz = d[0] * e2y - d[1] * e2x;
  float det = e1x * px + e1y * py + e1z * pz;
  if (!(det >= 1e-8f)) return false;
  float inv_det = 1.0f / det;
  float tx = o[0] - a[0], ty = o[1] - a[1], tz = o[2] - a[2];
  u = (tx * px + ty * py + tz * pz) * inv_det;
  float qx = ty * e1z - tz * e1y;
  float qy = tz * e1x - tx * e1z;
  float qz = tx * e1y - ty * e1x;
  v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
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

// Nearest hit of ray (o, d). On a traversal-stack overflow it sets *err and
// stops; the flag stays set until the host reads it and raises
// (_build.raise_on_overflow), so no node is dropped silently.
static __device__ void urt_closest_hit(const SceneArgs& s, const float o[3],
                                const float d[3], HitRec& h, int* err) {
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

  // Triangles: LBVH stack traversal, nearer child popped first.
  float inv[3] = {urt_safe_inv(d[0]), urt_safe_inv(d[1]), urt_safe_inv(d[2])};
  float tt = URT_F32_MAX, tu = 0.0f, tv = 0.0f;
  int ti = -1;
  int stack[URT_STACK];
  float stack_t[URT_STACK];
  int sp = 0;
  float tn;
  if (urt_box(s, 0, o, inv, tgs, tn)) {
    stack[0] = 0;
    stack_t[0] = tn;
    sp = 1;
  }
  const int leaf0 = s.n_clusters - 1;
  while (sp > 0) {
    --sp;
    int node = stack[sp];
    float bound = fminf(tt, tgs);
    if (stack_t[sp] > bound) continue;
    int l = s.node_left[node];
    if (l < 0) {
      int base = (node - leaf0) * s.cluster_size;
      for (int j = base; j < base + s.cluster_size; ++j) {
        float t, u, v;
        if (urt_mt97(s, j, o, d, t, u, v) && t < tgs &&
            (t < tt || (t == tt && j < ti))) {
          tt = t;
          ti = j;
          tu = u;
          tv = v;
        }
      }
    } else {
      int r = s.node_right[node];
      float tl, tr;
      bool hl = urt_box(s, l, o, inv, bound, tl);
      bool hr = urt_box(s, r, o, inv, bound, tr);
      if (sp + 2 > URT_STACK) {
        atomicOr(err, 1);
        break;
      }
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
