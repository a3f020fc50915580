// Full-path kernel: every bounce of every path in one launch.
//
// Replaces the JAX package's ops/pallas_path.py:_path_kernel (launched by
// path_trace). The TPU kernel sweeps a (1024-ray step, bounce) grid in order
// and keeps each step's path state in VMEM scratch. Here one thread owns one
// path: its state (origin, direction, throughput, radiance, sky record) lives
// in registers through all bounces, and a dead path leaves its loop at once
// (the TPU kernel's dead-step skip, per ray instead of per 1024-ray step)
// outside the sort window below.
//
// Per bounce: urt_closest_hit (closest_hit.cuh), then the shade of
// pallas_path.py:238-285 operation for operation — albedo clamp, spec/diffuse
// roulette, alpha = exp2(s^2 * log2 1000), cos(theta) = exp2(log2_u1 /
// (alpha + 1 or 2)), the Frisvad frame, the lobe weights, the hit point moved
// 0.001 along n — then the first-miss sky record and Russian roulette for
// 2 <= b < bounces - 1 with p = clip(max energy, 0.05, 1). The uniforms are
// the five precomputed rows per bounce the JAX package feeds its kernel
// (roulette, log2 u1, cos 2 pi u2, sin 2 pi u2, RR), so both draw the same
// random numbers.
//
// Bound on this card: the traversal inside urt_closest_hit (divergent, with
// L2 and device-memory latency on node and triangle reads; closest_hit.cuh
// says what its tables do about it). Paths also diverge in length, so warps
// idle once most of their rays are dead, and the lanes of a warp walk
// different nodes.
//
// The sort window (RenderConfig.ray_bin_bounces, the JAX kernel's bin_lo..
// bin_hi tested against the global bounce b0 + lb, pallas_path.py:134-158
// with the unsort at :186-189): at each bounce in [lo, hi] every block of
// URT_SORT_W threads (ops/cuda_trace.SORT_WINDOW) sorts its rays stably by bin
// (ray_sort.cuh: direction octant x origin cell, dead rays last), so a
// warp's lanes share a direction octant and dead rays fill whole warps.
// Until bounce hi the loop is uniform across the block: threads past n and
// dead paths take part as dead rays, and __syncthreads_or(alive) ends the
// whole block once nothing in it lives (the JAX kernel's dead-step skip,
// pallas_path.py:98-106); after hi threads leave early again. The design is
// the JAX kernel's: the ray goes to its slot through shared memory, thread j
// traces slot j, and the hit record (t, n, material, the ray's box and
// triangle tests) goes back to the ray's own thread, which shades its own
// path. The hits and the shading of a ray do not depend on which thread
// computes them, so the results are the unsorted kernel's bits. (Moving the
// whole path to the slot's thread instead, and windows of 256 and 512 rays,
// measured slower on the H100; PERF.md has the times.) With lo < 0 the
// launch is the unsorted kernel, with no shared memory and no block barrier.
//
// With a counts pointer the kernel also writes, per ray, the box tests and
// the triangle tests of all its bounces, counted in registers and written
// once (rows 0 and 1 of a (2, n) int32 buffer), which is what the path
// kernel's bound in PERF.md is reckoned from.
//
// With a state pointer the kernel also writes the packed resume state of
// pallas_path.py:324-332 (emit_state), which the bounce split gathers
// into its compact buffer: rows 0-2 origin, 3-5 direction, 6-8 throughput
// after roulette, 9 alive, 10-15 zero. The state is the JAX kernel's for
// every ray, dead ones included. That kernel runs every bounce for every ray
// and treats a dead ray as a miss (pallas_path.py:204, 283): its origin and
// direction stay frozen and its throughput becomes exactly 0 at the next
// bounce. This kernel leaves the loop instead, so it zeroes the throughput
// of a path that ends before its last local bounce (a miss, or a death by
// zero lobe or roulette with bounces still to come, or a ray dead on entry).

#include "closest_hit.cuh"

#define URT_MISS 1.0e30f
#define URT_LOG2_1000 9.965784284662087f

// One bounce of path (o, d, e) at hit h, pallas_path.py:238-285 operation
// for operation: albedo clamp, spec/diffuse roulette, alpha = exp2(s^2 *
// log2 1000), cos(theta) = exp2(log2_u1 / (alpha + 1 or 2)), the Frisvad
// frame, the lobe weights, the hit point moved 0.001 along n, then Russian
// roulette for 2 <= bg < bounces - 1 with p = clip(max energy, 0.05, 1).
// u: the bounce's five uniforms of the ray. A miss records (e, d) for the
// sky tap, ends the path and returns true (o, d and e stay as they are).
static __device__ __forceinline__ bool urt_shade(
    const SceneArgs& s, const HitRec& h, const float u[5], int bg,
    int bounces, int use_rr, float o[3], float d[3], float e[3], float rad[3],
    float se[3], float sd[3], bool& alive) {
  const float t = h.t >= URT_F32_MAX * 0.5f ? URT_MISS * 1.5f : h.t;
  if (t >= URT_MISS) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      se[k] = e[k];
      sd[k] = d[k];
    }
    alive = false;
    return true;
  }
  const float u_r = u[0], log2_u1 = u[1], cos_phi = u[2], sin_phi = u[3];
  const float u_rr = u[4];

  const float* alb_raw = s.mat_albedo + 3 * h.mat;
  const float* spec = s.mat_specular + 3 * h.mat;
  const float* emis = s.mat_emission + 3 * h.mat;
  const float smooth = s.mat_smooth[h.mat];
  const float* n3 = h.n;

  float albedo[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) albedo[k] = fminf(1.0f - spec[k], alb_raw[k]);
  float spec_chance = (spec[0] + spec[1] + spec[2]) / 3.0f;
  float diff_chance = (albedo[0] + albedo[1] + albedo[2]) / 3.0f;
  const float total = spec_chance + diff_chance;
  const float safe_total = total > 0.0f ? total : 1.0f;
  spec_chance = spec_chance / safe_total;
  diff_chance = diff_chance / safe_total;
  const bool is_spec = total > 0.0f && u_r < spec_chance;
  const bool is_diff = total > 0.0f && !is_spec && diff_chance > 0.0f;

  const float d_dot_n = d[0] * n3[0] + d[1] * n3[1] + d[2] * n3[2];
  const float k2 = 2.0f * d_dot_n;
  float axis[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) axis[k] = is_spec ? d[k] - k2 * n3[k] : n3[k];
  const float alpha = exp2f(smooth * smooth * URT_LOG2_1000);
  const float cos_t = exp2f(log2_u1 / (is_spec ? alpha + 1.0f : 2.0f));
  const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));

  // Branchless Frisvad/Pixar frame (ops/sampling.py:tangent_frame).
  const float sg = axis[2] >= 0.0f ? 1.0f : -1.0f;
  const float a_ = -1.0f / (sg + axis[2]);
  const float b_ = axis[0] * axis[1] * a_;
  const float tang[3] = {1.0f + sg * axis[0] * axis[0] * a_, sg * b_,
                         -sg * axis[0]};
  const float binorm[3] = {b_, sg + axis[1] * axis[1] * a_, -axis[1]};
  const float ca = cos_phi * sin_t;
  const float sa = sin_phi * sin_t;
  float nd[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    nd[k] = tang[k] * ca + binorm[k] * sa + axis[k] * cos_t;

  const float f = (alpha + 2.0f) / (alpha + 1.0f);
  const float ndot = n3[0] * nd[0] + n3[1] * nd[1] + n3[2] * nd[2];
  const float w_spec_s =
      fminf(fmaxf(ndot * f, 0.0f), 1.0f) / fmaxf(spec_chance, 1e-8f);
  const float w_diff_d = fmaxf(diff_chance, 1e-8f);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float lobe = is_spec ? spec[k] * w_spec_s
                               : (is_diff ? albedo[k] / w_diff_d : 0.0f);
    const float pos = o[k] + t * d[k];
    rad[k] = rad[k] + e[k] * emis[k];
    e[k] = e[k] * lobe;
    o[k] = pos + n3[k] * 0.001f;
    d[k] = nd[k];
  }
  alive = e[0] > 0.0f || e[1] > 0.0f || e[2] > 0.0f;

  if (use_rr && bg >= 2 && bg < bounces - 1) {
    const float p = fminf(fmaxf(fmaxf(fmaxf(e[0], e[1]), e[2]), 0.05f), 1.0f);
    const bool keep = u_rr < p;
    const float boost = keep ? 1.0f / p : 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) e[k] = e[k] * boost;
    alive = alive && keep;
  }
  return false;
}

// The five uniforms of bounce lb of ray i: rows (lb, 0..4) of uni, n apart.
// The kernels load them before the bounce's traversal, whose latency then
// hides theirs.
static __device__ __forceinline__ void urt_uniforms(
    const float* __restrict__ uni, int n, int lb, int i, float u[5]) {
  const float* r = uni + (size_t)lb * 5 * n + i;
#pragma unroll
  for (int k = 0; k < 5; ++k) u[k] = r[(size_t)k * n];
}

// The outputs of path i. lb_end: the local bounce at which the unsorted
// kernel's loop ends for this path (nb when it runs them all, 0 for a ray
// dead on entry). A path that ended with local bounces to go: the JAX
// kernel's next bounce (a miss for a dead ray) would have set its
// throughput to 0.
static __device__ __forceinline__ void urt_path_write(
    int i, int n, int nb, int lb_end, bool alive, const float o[3],
    const float d[3], const float e_in[3], const float rad[3],
    const float se[3], const float sd[3], const TravCount& cnt,
    float* __restrict__ out, float* __restrict__ state,
    int* __restrict__ counts) {
  float e[3] = {e_in[0], e_in[1], e_in[2]};
  if (!alive && lb_end < nb) e[0] = e[1] = e[2] = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    out[(size_t)k * n + i] = rad[k];
    out[(size_t)(3 + k) * n + i] = se[k];
    out[(size_t)(6 + k) * n + i] = sd[k];
  }
  if (state) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      state[(size_t)k * n + i] = o[k];
      state[(size_t)(3 + k) * n + i] = d[k];
      state[(size_t)(6 + k) * n + i] = e[k];
    }
    state[(size_t)9 * n + i] = alive ? 1.0f : 0.0f;
#pragma unroll
    for (int k = 10; k < 16; ++k) state[(size_t)k * n + i] = 0.0f;
  }
  if (counts) {
    counts[i] = cnt.box;
    counts[(size_t)n + i] = cnt.tri;
  }
}

// ro, rd: (3, n); alive0: (n,) or null (all alive); energy0: (3, n) or null
// (all ones); uni: (nb, 5, n); out: (9, n) rows radiance rgb, sky throughput
// rgb, sky direction xyz; state: (16, n) resume state, or null; counts:
// (2, n) box and triangle tests, or null.
__global__ void urt_path_kernel(SceneArgs s, const float* __restrict__ ro,
                                const float* __restrict__ rd,
                                const float* __restrict__ alive0,
                                const float* __restrict__ energy0,
                                const float* __restrict__ uni,
                                float* __restrict__ out,
                                float* __restrict__ state,
                                int* __restrict__ counts, int n, int b0,
                                int nb, int bounces, int use_rr, int* err) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float o[3], d[3], e[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = ro[(size_t)k * n + i];
    d[k] = rd[(size_t)k * n + i];
    e[k] = energy0 ? energy0[(size_t)k * n + i] : 1.0f;
  }
  bool alive = alive0 ? alive0[i] > 0.0f : true;
  float rad[3] = {0.0f, 0.0f, 0.0f};
  float se[3] = {0.0f, 0.0f, 0.0f};
  float sd[3] = {0.0f, 1.0f, 0.0f};
  TravCount cnt = {0, 0};

  int lb = 0;
  for (; lb < nb && alive; ++lb) {
    float u[5];
    urt_uniforms(uni, n, lb, i, u);
    HitRec h;
    urt_closest_hit(s, o, d, h, err, cnt);
    // A miss breaks out before the increment, so lb < nb holds for it.
    if (urt_shade(s, h, u, b0 + lb, bounces, use_rr, o, d, e, rad, se, sd,
                  alive))
      break;
  }
  urt_path_write(i, n, nb, lb, alive, o, d, e, rad, se, sd, cnt, out, state,
                 counts);
}

// The sorted launch: URT_SORT_W threads a block; bounces b0 + lb in [lo, hi]
// are traced in the block's sorted order.
__global__ void __launch_bounds__(URT_SORT_W) urt_path_sorted_kernel(
    SceneArgs s, const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ alive0, const float* __restrict__ energy0,
    const float* __restrict__ uni, float* __restrict__ out,
    float* __restrict__ state, int* __restrict__ counts, int n, int b0, int nb,
    int bounces, int use_rr, int lo, int hi, int* err) {
  __shared__ SortSmem sm;
  // A slot: the ray (o xyz, d xyz, alive), then its hit (t, n xyz, and
  // the bits of the material, box tests and triangle tests).
  __shared__ float sx[7][URT_SORT_W];
  const int t = threadIdx.x;
  const int i = blockIdx.x * URT_SORT_W + t;
  const bool in = i < n;
  float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
  float e[3] = {0.0f, 0.0f, 0.0f};
  if (in) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[k] = ro[(size_t)k * n + i];
      d[k] = rd[(size_t)k * n + i];
      e[k] = energy0 ? energy0[(size_t)k * n + i] : 1.0f;
    }
  }
  bool alive = in && (alive0 ? alive0[i] > 0.0f : true);
  float rad[3] = {0.0f, 0.0f, 0.0f};
  float se[3] = {0.0f, 0.0f, 0.0f};
  float sd[3] = {0.0f, 1.0f, 0.0f};
  TravCount cnt = {0, 0};
  int lb_end = alive ? nb : 0;
  // The last local bounce with block barriers; dead threads stay until it.
  const int lb_sync = min(hi - b0, nb - 1);

  for (int lb = 0; lb < nb; ++lb) {
    const int bg = b0 + lb;
    const bool sorted = bg >= lo && bg <= hi;
    float u[5];
    if (alive) urt_uniforms(uni, n, lb, i, u);
    // The ray this thread traces: slot t's in a sorted bounce, else its own.
    bool trace = alive;
    int sdst = 0;   // this thread's ray's slot in a sorted bounce
    float oj[3], dj[3];
    if (sorted) {
      if (!__syncthreads_or(alive)) break;
      sdst = urt_bin_dest(
          urt_ray_bin(o, d, alive, s.bin_cx, s.bin_cy, s.bin_cz), sm);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        sx[k][sdst] = o[k];
        sx[3 + k][sdst] = d[k];
      }
      sx[6][sdst] = alive ? 1.0f : 0.0f;
      __syncthreads();
      // Thread t alone reads and then rewrites slot t until the barrier.
      trace = sx[6][t] > 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        oj[k] = sx[k][t];
        dj[k] = sx[3 + k][t];
      }
    } else {
      if (!alive) {
        if (lb > lb_sync) break;
        continue;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        oj[k] = o[k];
        dj[k] = d[k];
      }
    }
    HitRec h;
    TravCount cj = {0, 0};
    if (trace) urt_closest_hit(s, oj, dj, h, err, cj);
    if (sorted) {
      if (trace) {
        sx[0][t] = h.t;
#pragma unroll
        for (int k = 0; k < 3; ++k) sx[1 + k][t] = h.n[k];
        sx[4][t] = __int_as_float(h.mat);
        sx[5][t] = __int_as_float(cj.box);
        sx[6][t] = __int_as_float(cj.tri);
      }
      __syncthreads();
      if (!alive) continue;
      h.t = sx[0][sdst];
#pragma unroll
      for (int k = 0; k < 3; ++k) h.n[k] = sx[1 + k][sdst];
      h.mat = __float_as_int(sx[4][sdst]);
      h.prim = -1;  // not read by the shade
      cj.box = __float_as_int(sx[5][sdst]);
      cj.tri = __float_as_int(sx[6][sdst]);
    }
    cnt.box += cj.box;
    cnt.tri += cj.tri;
    if (urt_shade(s, h, u, bg, bounces, use_rr, o, d, e, rad, se, sd, alive))
      lb_end = lb;
    else if (!alive)
      lb_end = lb + 1;
  }
  if (in)
    urt_path_write(i, n, nb, lb_end, alive, o, d, e, rad, se, sd, cnt, out,
                   state, counts);
}

// lo < 0: the unsorted kernel (128 threads a block). Else bounces b0 + lb in
// [lo, hi] are sorted in windows of `window` rays, which must be URT_SORT_W
// (ops/cuda_trace.SORT_WINDOW); anything else returns cudaErrorInvalidValue
// and launches nothing.
extern "C" int urt_path_trace(const SceneArgs* s, const float* ro,
                              const float* rd, const float* alive0,
                              const float* energy0, const float* uni,
                              float* out, float* state, int* counts, int n,
                              int b0, int nb, int bounces, int use_rr, int lo,
                              int hi, int window, int* err,
                              cudaStream_t stream) {
  if (lo < 0) {
    if (n > 0) {
      const int threads = 128;
      urt_path_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
          *s, ro, rd, alive0, energy0, uni, out, state, counts, n, b0, nb,
          bounces, use_rr, err);
    }
    return (int)cudaGetLastError();
  }
  if (hi < lo || window != URT_SORT_W) return (int)cudaErrorInvalidValue;
  if (n > 0)
    urt_path_sorted_kernel<<<(n + URT_SORT_W - 1) / URT_SORT_W, URT_SORT_W,
                             0, stream>>>(*s, ro, rd, alive0, energy0, uni,
                                          out, state, counts, n, b0, nb,
                                          bounces, use_rr, lo, hi, err);
  return (int)cudaGetLastError();
}
