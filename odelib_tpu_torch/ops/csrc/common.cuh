// Device code shared by the fused kernels (mh.cu, ensemble.cu, pt.cu):
// the runtime plan tables, the scorer and the counter RNG.
//
// Counterparts in odelib_tpu/ops/pallas_mh.py: _build_plan (the plan, laid
// out as flat tables by ops/cuda_mh.py plan_tables), _make_scorer
// (lognormal, uncensored) with the fixed steppers, and _mix/_Rng.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "odelib_gen.cuh"  // rhs(), step_dopri5(), step_rk4(), ODE_S, ODE_P

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

// Observation terms scored at grid point gi (lognormal, uncensored).
__device__ __forceinline__ void contrib(const Plan& pl, int gi,
                                        const float* y, float& chi,
                                        float& ssres) {
  const int o1 = pl.obs_ptr[gi + 1];
  for (int o = pl.obs_ptr[gi]; o < o1; ++o) {
    const int j = pl.obs_state[o];
    const int m1 = pl.post_ptr[j + 1];
    int m = pl.post_ptr[j];
    float pred = pick<ODE_S>(y, pl.post_mem[m]);
    for (++m; m < m1; ++m) pred = pred + pick<ODE_S>(y, pl.post_mem[m]);
    // no floor on pred: a blown-up trajectory gives a non-finite chi
    const float d = pl.lab[o] - logf(pred);
    chi = chi + (d * d) / pl.den[o];
    const float e = pred - pl.ab[o];
    ssres = ssres + e * e;
  }
}

template <int STEPPER>
__device__ __forceinline__ void score(const Plan& pl, const float* theta,
                                      float& chi_out, float& rsq_out) {
  float y[ODE_S];
#pragma unroll
  for (int s = 0; s < ODE_S; ++s) {
    const int ip = pl.init_pidx[s];
    y[s] = ip >= 0 ? pick<ODE_P>(theta, ip) : pl.y0[s];
  }
  float chi = 0.0f, ssres = 0.0f;
  contrib(pl, 0, y, chi, ssres);
  for (int k = 0; k < pl.n_steps; ++k) {
    const float* sf = pl.steps + 8 * k;
    if (STEPPER == 0) {
      step_dopri5(y, sf, theta);
    } else {
      step_rk4(y, sf, theta);
    }
    const int gi = pl.step_gi[k];
    if (gi >= 0) contrib(pl, gi, y, chi, ssres);
  }
  chi_out = chi;
  rsq_out = 1.0f - ssres / pl.sstot;
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

__device__ __forceinline__ float uniform(uint32_t key, uint32_t ctr) {
  const uint32_t w = mix(key ^ mix(ctr));
  return (float)(int32_t)(w >> 8) * 0x1p-24f + 0x1p-25f;
}

// Box-Muller (cos half only) from slots ctr and ctr + 1.
__device__ __forceinline__ float normal(uint32_t key, uint32_t ctr) {
  const float u1 = uniform(key, ctr);
  const float u2 = uniform(key, ctr + 1u);
  return sqrtf(-2.0f * logf(u1)) * cosf(ODELIB_TWO_PI * u2);
}

}  // namespace odelib
