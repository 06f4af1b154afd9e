// Device code shared by the fused kernels (mh.cu, ensemble.cu, pt.cu,
// joint.cu, pf.cu): the runtime plan tables, the scorer, the counter RNG
// and the in-kernel priors.
//
// Counterparts in odelib_tpu/ops/pallas_mh.py: _build_plan (the plan, laid
// out as flat tables by ops/cuda_mh.py plan_tables), _make_scorer
// (lognormal, uncensored) with the fixed steppers, _mix/_Rng, and
// _kernel_logpdf for the LogNormal, Normal and Uniform families.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "odelib_gen.cuh"  // rhs(), step_dopri5(), step_rk4(), ODE_S, ODE_P

// The model of the generated header as a type, so the scorer can be
// instantiated per model: a joint fit of different models adds Model1, ...
// to the header (ops/build.py) and lists them all in ODE_MODELS.
struct Model0 {
  static constexpr int S = ODE_S;
  static constexpr int P = ODE_P;
  static __device__ __forceinline__ void rhs(float t, const float* y,
                                             const float* p, float* dy) {
    ::rhs(t, y, p, dy);
  }
  static __device__ __forceinline__ void step_dopri5(float* y,
                                                     const float* sf,
                                                     const float* p) {
    ::step_dopri5(y, sf, p);
  }
  static __device__ __forceinline__ void step_rk4(float* y, const float* sf,
                                                  const float* p) {
    ::step_rk4(y, sf, p);
  }
};
#ifndef ODE_MODELS
#define ODE_MODELS(X) X(0)
#define ODE_PMAX ODE_P
#endif

namespace odelib {

// Header of plan_i (ops/cuda_mh.py plan_tables).
enum : int {
  H_NSTEPS = 0, H_NGRID, H_NOBS, H_NPOST, H_STEPPER,
  H_STEP_GI, H_OBS_PTR, H_OBS_STATE, H_POST_PTR, H_POST_MEM, H_INIT_PIDX,
  H_F_STEPS, H_F_LAB, H_F_DEN, H_F_AB, H_F_Y0
};

struct Plan {
  int n_steps;
  const int* step_gi;
  const int* obs_ptr;
  const int* obs_state;
  const int* post_ptr;
  const int* post_mem;
  const int* init_pidx;
  float sstot;
  const float* steps;  // 8 floats per step
  const float* lab;
  const float* den;    // 2 * log_sigma^2
  const float* ab;
  const float* y0;
};

__device__ __forceinline__ Plan load_plan(const int* __restrict__ pi,
                                          const float* __restrict__ pf) {
  Plan p;
  p.n_steps = pi[H_NSTEPS];
  p.step_gi = pi + pi[H_STEP_GI];
  p.obs_ptr = pi + pi[H_OBS_PTR];
  p.obs_state = pi + pi[H_OBS_STATE];
  p.post_ptr = pi + pi[H_POST_PTR];
  p.post_mem = pi + pi[H_POST_MEM];
  p.init_pidx = pi + pi[H_INIT_PIDX];
  p.sstot = pf[0];
  p.steps = pf + pi[H_F_STEPS];
  p.lab = pf + pi[H_F_LAB];
  p.den = pf + pi[H_F_DEN];
  p.ab = pf + pi[H_F_AB];
  p.y0 = pf + pi[H_F_Y0];
  return p;
}

// v[i] for a runtime i, by an unrolled select so v stays in registers.
template <int N>
__device__ __forceinline__ float pick(const float* v, int i) {
  float r = v[0];
#pragma unroll
  for (int k = 1; k < N; ++k) r = (i == k) ? v[k] : r;
  return r;
}

// Observation terms scored at grid point gi (lognormal, uncensored) for a
// model of S states.
template <int S>
__device__ __forceinline__ void contrib(const Plan& pl, int gi,
                                        const float* y, float& chi,
                                        float& ssres) {
  const int o1 = pl.obs_ptr[gi + 1];
  for (int o = pl.obs_ptr[gi]; o < o1; ++o) {
    const int j = pl.obs_state[o];
    const int m1 = pl.post_ptr[j + 1];
    int m = pl.post_ptr[j];
    float pred = pick<S>(y, pl.post_mem[m]);
    for (++m; m < m1; ++m) pred = pred + pick<S>(y, pl.post_mem[m]);
    // no floor on pred: a blown-up trajectory gives a non-finite chi
    const float d = pl.lab[o] - logf(pred);
    chi = chi + (d * d) / pl.den[o];
    const float e = pred - pl.ab[o];
    ssres = ssres + e * e;
  }
}

// The fixed-step solve of model M over the plan's steps, scored.
template <class M, int STEPPER>
__device__ __forceinline__ void score_model(const Plan& pl,
                                            const float* theta,
                                            float& chi_out, float& rsq_out) {
  float y[M::S];
#pragma unroll
  for (int s = 0; s < M::S; ++s) {
    const int ip = pl.init_pidx[s];
    y[s] = ip >= 0 ? pick<M::P>(theta, ip) : pl.y0[s];
  }
  float chi = 0.0f, ssres = 0.0f;
  contrib<M::S>(pl, 0, y, chi, ssres);
  for (int k = 0; k < pl.n_steps; ++k) {
    const float* sf = pl.steps + 8 * k;
    if (STEPPER == 0) {
      M::step_dopri5(y, sf, theta);
    } else {
      M::step_rk4(y, sf, theta);
    }
    const int gi = pl.step_gi[k];
    if (gi >= 0) contrib<M::S>(pl, gi, y, chi, ssres);
  }
  chi_out = chi;
  rsq_out = 1.0f - ssres / pl.sstot;
}

template <int STEPPER>
__device__ __forceinline__ void score(const Plan& pl, const float* theta,
                                      float& chi_out, float& rsq_out) {
  score_model<Model0, STEPPER>(pl, theta, chi_out, rsq_out);
}

// SplitMix32 finalizer and the counter RNG of odelib_tpu's _Rng.
__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x += 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The (0, 1) uniform of a key and a counter word already mixed, mix(ctr):
// keys that share a counter (a chain's particles) share its mix.
__device__ __forceinline__ float uniform_mixed(uint32_t key, uint32_t mctr) {
  const uint32_t w = mix(key ^ mctr);
  return (float)(int32_t)(w >> 8) * 0x1p-24f + 0x1p-25f;
}

__device__ __forceinline__ float uniform(uint32_t key, uint32_t ctr) {
  return uniform_mixed(key, mix(ctr));
}

// Box-Muller (cos half only) from slots ctr and ctr + 1.
__device__ __forceinline__ float normal(uint32_t key, uint32_t ctr) {
  const float u1 = uniform(key, ctr);
  const float u2 = uniform(key, ctr + 1u);
  return sqrtf(-2.0f * logf(u1)) * cosf(ODELIB_TWO_PI * u2);
}

// Log prior density of one theta slot, from its 5-float table entry
// (ops/priors.py prior_table): family (0 none, 1 LogNormal, 2 Normal,
// 3 Uniform), then loc, scale, s (LogNormal) or the upper edge (Uniform),
// and the normalising constant, each rounded to float32 on the host as
// _kernel_logpdf's Python floats are where they meet the float32 theta.
enum : int { PRIOR_NONE = 0, PRIOR_LOGNORMAL, PRIOR_NORMAL, PRIOR_UNIFORM };
constexpr int PRIOR_WIDTH = 5;

__device__ __forceinline__ float log_prior(const float* e, float x) {
  const int fam = (int)e[0];
  if (fam == PRIOR_LOGNORMAL) {
    const float y = (x - e[1]) / e[2];
    const float ly = logf(fmaxf(y, 1e-37f));
    const float q = ly / e[3];
    return y > 0.0f ? (-0.5f * (q * q) - ly) + e[4] : -INFINITY;
  }
  if (fam == PRIOR_NORMAL) {
    const float z = (x - e[1]) / e[2];
    return -0.5f * z * z + e[4];
  }
  if (fam == PRIOR_UNIFORM) return (x >= e[1] && x <= e[3]) ? e[4] : -INFINITY;
  return 0.0f;
}

}  // namespace odelib
