// Fused survey and Metropolis-Hastings kernels for Hopper (sm_90a).
//
// Replaces, in odelib_tpu/ops/pallas_mh.py:
//   survey_kernel  <- _cached_survey_call (public survey_fused)
//   mh_kernel      <- _cached_mh_grid, whole-run mode (public
//                     metropolis_hastings_fused via _cached_mh_run)
//
// What bounds them on the card: neither moves meaningful bytes (the MH
// kernel writes (P+4) floats per chain and recorded iteration; the plan
// tables are a few KB read as broadcasts). Each chain is one long chain of
// dependent float32 operations and transcendental calls: an iteration is a
// full fixed-step solve over the compact observation grid. So the MH run is
// bound by latency and occupancy: the main path's 10,000 chains are about
// 313 warps, 2.4 warps per SM on 132 SMs, far from the 64 warps an SM can
// hold, so each SM's schedulers mostly wait on dependent instructions.
//
// What the design does about it: one thread per chain (or draw), with every
// state, stage and parameter in registers and the whole iteration loop
// inside the thread, so nothing round-trips through memory; 32-thread
// blocks, so the chains spread over every SM instead of filling a few; the
// TPU's (8,128) tiling, VMEM scratch and sequential segment grid do not
// carry over. The plan (step list, per-grid-point observation CSR, y0) is a
// runtime table, so one build serves every dataset and schedule of a
// model: only the RHS, S and P are compiled in (odelib_gen.cuh, generated
// by odelib_tpu_torch/ops/build.py). Records are written chain-minor,
// (R, P, C) and (R, C), so neighbouring threads store to neighbouring
// addresses; burn-in rows are never written. More chains per launch,
// several chains per warp and CUDA graphs are later work.
//
// Numerics: built with -fmad=false and without fast math, so every
// operation rounds like its torch twin (ops/cuda_mh.py) and the JAX
// kernel: same order of the Dopri5/RK4 stage sums, constants rounded to
// float32 on the host, and the same counter RNG words.
#include <cstdint>
#include <cuda_runtime.h>

#include "odelib_gen.cuh"  // rhs(), step_dopri5(), step_rk4(), ODE_S, ODE_P

namespace {

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

template <int STEPPER>
__global__ void survey_kernel(const int* __restrict__ pi,
                              const float* __restrict__ pf,
                              const float* __restrict__ theta,
                              float* __restrict__ chi_out, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const Plan pl = load_plan(pi, pf);
  float th[ODE_P];
#pragma unroll
  for (int p = 0; p < ODE_P; ++p) th[p] = theta[(size_t)p * N + n];
  float chi, rsq;
  score<STEPPER>(pl, th, chi, rsq);
  chi_out[n] = chi;
}

template <int STEPPER>
__global__ void __launch_bounds__(32)
mh_kernel(const int* __restrict__ pi, const float* __restrict__ pf,
          const float* __restrict__ theta0, const float* __restrict__ walk,
          float* __restrict__ th_rec, float* __restrict__ chi_rec,
          float* __restrict__ rsq_rec, float* __restrict__ aic_rec,
          float* __restrict__ ar_rec, int C, int nits, int burnin,
          uint32_t seed, float aic_const) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const Plan pl = load_plan(pi, pf);
  float lt[ODE_P], prop[ODE_P], thp[ODE_P], scale[ODE_P];
  bool walked[ODE_P];
#pragma unroll
  for (int p = 0; p < ODE_P; ++p) {
    thp[p] = theta0[(size_t)p * C + c];
    scale[p] = walk[p];
    walked[p] = walk[ODE_P + p] != 0.0f;
  }
  float chi, rsq;
  score<STEPPER>(pl, thp, chi, rsq);
#pragma unroll
  for (int p = 0; p < ODE_P; ++p) lt[p] = logf(thp[p]);
  float acc = 0.0f;
  // the chain's global index keys its stream: any block layout gives the
  // JAX kernel's words
  const uint32_t key = mix(seed * 0x9E3779B1u + (uint32_t)c);
  for (int it = 1; it < nits; ++it) {
    const uint32_t base = (uint32_t)it * 1024u;
    uint32_t slot = 0;
#pragma unroll
    for (int p = 0; p < ODE_P; ++p) {
      if (walked[p]) {
        const float u1 = uniform(key, base + slot++);
        const float u2 = uniform(key, base + slot++);
        const float n = sqrtf(-2.0f * logf(u1)) * cosf(ODELIB_TWO_PI * u2);
        prop[p] = lt[p] + scale[p] * n;
      } else {
        prop[p] = lt[p];
      }
      thp[p] = expf(prop[p]);
    }
    float chi_new, rsq_new;
    score<STEPPER>(pl, thp, chi_new, rsq_new);
    const float u = uniform(key, base + slot);
    // NaN or -inf log ratio compares false: rejected
    if (expf(chi - chi_new) > u) {
#pragma unroll
      for (int p = 0; p < ODE_P; ++p) lt[p] = prop[p];
      chi = chi_new;
      rsq = rsq_new;
      acc = acc + 1.0f;
    }
    const int r = it - 1 - burnin;
    if (r >= 0) {
      const size_t row = (size_t)r * C + c;
#pragma unroll
      for (int p = 0; p < ODE_P; ++p)
        th_rec[((size_t)r * ODE_P + p) * C + c] = expf(lt[p]);
      chi_rec[row] = chi;
      rsq_rec[row] = rsq;
      aic_rec[row] = 2.0f * chi + aic_const;
      ar_rec[row] = acc / (float)it;
    }
  }
}

}  // namespace

extern "C" {

int odelib_survey(const int* pi, const float* pf, const float* theta,
                  float* chi, int N, int stepper, void* stream) {
  const int block = 128;
  const int grid = (N + block - 1) / block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stepper == 0) {
    survey_kernel<0><<<grid, block, 0, s>>>(pi, pf, theta, chi, N);
  } else {
    survey_kernel<1><<<grid, block, 0, s>>>(pi, pf, theta, chi, N);
  }
  return (int)cudaGetLastError();
}

int odelib_mh(const int* pi, const float* pf, const float* theta0,
              const float* walk, float* th_rec, float* chi_rec,
              float* rsq_rec, float* aic_rec, float* ar_rec, int C,
              int nits, int burnin, unsigned int seed, float aic_const,
              int stepper, void* stream) {
  const int block = 32;
  const int grid = (C + block - 1) / block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stepper == 0) {
    mh_kernel<0><<<grid, block, 0, s>>>(pi, pf, theta0, walk, th_rec,
                                         chi_rec, rsq_rec, aic_rec, ar_rec,
                                         C, nits, burnin, seed, aic_const);
  } else {
    mh_kernel<1><<<grid, block, 0, s>>>(pi, pf, theta0, walk, th_rec,
                                         chi_rec, rsq_rec, aic_rec, ar_rec,
                                         C, nits, burnin, seed, aic_const);
  }
  return (int)cudaGetLastError();
}

const char* odelib_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
