// Full-path kernel: every bounce of every path in one launch.
//
// Replaces the JAX package's ops/pallas_path.py:_path_kernel (launched by
// path_trace). The TPU kernel sweeps a (1024-ray step, bounce) grid in order
// and keeps each step's path state in VMEM scratch. Here one thread owns one
// path: its state (origin, direction, throughput, radiance, sky record) lives
// in registers through all bounces, and a dead path leaves its loop at once
// (the TPU kernel's dead-step skip, per ray instead of per 1024-ray step).
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
// device-memory latency on node and triangle reads). Paths also diverge in
// length, so warps idle once most of their rays are dead. Nothing in this
// first version addresses either: one thread per ray, no compaction.

#include "closest_hit.cuh"

#define URT_MISS 1.0e30f
#define URT_LOG2_1000 9.965784284662087f

// ro, rd: (3, n); alive0: (n,) or null (all alive); energy0: (3, n) or null
// (all ones); uni: (nb, 5, n); out: (9, n) rows radiance rgb, sky throughput
// rgb, sky direction xyz.
__global__ void urt_path_kernel(SceneArgs s, const float* __restrict__ ro,
                                const float* __restrict__ rd,
                                const float* __restrict__ alive0,
                                const float* __restrict__ energy0,
                                const float* __restrict__ uni,
                                float* __restrict__ out, int n, int b0, int nb,
                                int bounces, int use_rr, int* err) {
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

  for (int lb = 0; lb < nb && alive; ++lb) {
    const int bg = b0 + lb;
    const float* u = uni + (size_t)lb * 5 * n + i;
    const float u_r = u[0];
    const float log2_u1 = u[(size_t)n];
    const float cos_phi = u[2 * (size_t)n];
    const float sin_phi = u[3 * (size_t)n];
    const float u_rr = u[4 * (size_t)n];

    HitRec h;
    urt_closest_hit(s, o, d, h, err);
    float t = h.t >= URT_F32_MAX * 0.5f ? URT_MISS * 1.5f : h.t;
    if (t >= URT_MISS) {
      // First miss of a live path: record its throughput and direction for
      // the sky tap; the path ends (zero energy).
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        se[k] = e[k];
        sd[k] = d[k];
      }
      alive = false;
      break;
    }

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
  }

#pragma unroll
  for (int k = 0; k < 3; ++k) {
    out[(size_t)k * n + i] = rad[k];
    out[(size_t)(3 + k) * n + i] = se[k];
    out[(size_t)(6 + k) * n + i] = sd[k];
  }
}

extern "C" int urt_path_trace(const SceneArgs* s, const float* ro,
                              const float* rd, const float* alive0,
                              const float* energy0, const float* uni,
                              float* out, int n, int b0, int nb, int bounces,
                              int use_rr, int* err, cudaStream_t stream) {
  if (n > 0) {
    const int threads = 128;
    urt_path_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
        *s, ro, rd, alive0, energy0, uni, out, n, b0, nb, bounces, use_rr, err);
  }
  return (int)cudaGetLastError();
}
