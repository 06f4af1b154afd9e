// Fused parallel-tempering (replica-exchange MH) kernel for Hopper (sm_90a).
//
// Replaces, in odelib_tpu/ops/pallas_pt.py:
//   pt_kernel <- _cached_pt_grid, whole-run mode (public
//                parallel_tempering_fused)
//
// Semantics. Every chain carries a ladder of K rungs (inverse temperatures
// beta_k), all started at the chain's seed point. Per iteration each rung in
// order proposes a log-space random walk of scale rwalk_std sqrt(T_k), is
// scored, and accepts when exp((chi_k - chi_new) beta_k) > u; then each
// adjacent pair k = 0..K-2 draws one uniform (always: the RNG slots are
// static) and swaps when its parity is due, exp(delta) > u and delta is
// finite, delta = (beta_k - beta_{k+1}) (chi_k - chi_{k+1}). Only the T = 1
// rung is recorded, with its walk acceptances and accepted (0,1) swaps.
// Without priors the log-prior planes of the JAX kernel are zero, and
// chi - 0 is chi exactly, so they are left out.
//
// What bounds it on the card: K fixed-step solves per chain and iteration,
// dependent float32 operations, as mh_kernel; bytes are the records only.
// Latency-bound at the main path's 10,000 chains (2.4 warps per SM).
//
// What the design does about it: one thread per chain, the whole run in the
// thread, as mh_kernel. Swaps are exchanges within the thread's own ladder,
// so nothing crosses threads. K is a runtime value up to PT_KMAX; the
// ladder (K x (P + 2) floats) sits in thread-local arrays indexed by the
// rung, i.e. in L1-cached local memory, while the rung being stepped works
// in registers. The rung loop is not unrolled, so the solve is compiled
// once.
//
// Numerics: as mh.cu (-fmad=false, no fast math, constants rounded to
// float32 on the host where the JAX kernel's Python doubles meet float32),
// so it rounds like its torch twin pt_plain (ops/cuda_pt.py).
#include "common.cuh"

#ifndef PT_KMAX  // -DPT_KMAX from ops/build.py, the one place it is set
#error "PT_KMAX (rungs held per chain) must be defined by the build"
#endif

namespace {

using namespace odelib;

// ladder: K*P walk scales f32(rwalk_std sqrt(T_k) mask_p), P walked flags,
// K betas f32(1/T_k), K-1 pair factors f32(beta_k - beta_{k+1}).
template <int STEPPER>
__global__ void __launch_bounds__(32)
pt_kernel(const int* __restrict__ pi, const float* __restrict__ pf,
          const float* __restrict__ theta0, const float* __restrict__ ladder,
          float* __restrict__ th_rec, float* __restrict__ chi_rec,
          float* __restrict__ rsq_rec, float* __restrict__ aic_rec,
          float* __restrict__ ar_rec, float* __restrict__ sw_rec, int C,
          int K, int nits, int burnin, int swap_every, uint32_t seed,
          float aic_const) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const Plan pl = load_plan(pi, pf);
  const float* scale = ladder;
  const float* walked = ladder + K * ODE_P;
  const float* beta = walked + ODE_P;
  const float* dbeta = beta + K;
  float lt[PT_KMAX][ODE_P], chi[PT_KMAX], rsq[PT_KMAX];
  float prop[ODE_P], thp[ODE_P];
#pragma unroll
  for (int p = 0; p < ODE_P; ++p) thp[p] = theta0[(size_t)p * C + c];
  float chi0, rsq0;
  score<STEPPER>(pl, thp, chi0, rsq0);
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int p = 0; p < ODE_P; ++p) lt[k][p] = logf(thp[p]);
    chi[k] = chi0;
    rsq[k] = rsq0;
  }
  float acc = 0.0f, sw = 0.0f;
  const uint32_t key = mix(seed * 0x9E3779B1u + (uint32_t)c);
  for (int it = 1; it < nits; ++it) {
    uint32_t ctr = (uint32_t)it * 1024u;
    // walk phase: every rung in order
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int p = 0; p < ODE_P; ++p) {
        if (walked[p] != 0.0f) {
          prop[p] = lt[k][p] + scale[k * ODE_P + p] * normal(key, ctr);
          ctr += 2u;
        } else {
          prop[p] = lt[k][p];
        }
        thp[p] = expf(prop[p]);
      }
      float chi_new, rsq_new;
      score<STEPPER>(pl, thp, chi_new, rsq_new);
      const float u = uniform(key, ctr++);
      // NaN or -inf log ratio compares false: rejected
      if (expf((chi[k] - chi_new) * beta[k]) > u) {
#pragma unroll
        for (int p = 0; p < ODE_P; ++p) lt[k][p] = prop[p];
        chi[k] = chi_new;
        rsq[k] = rsq_new;
        if (k == 0) acc = acc + 1.0f;
      }
    }
    // swap phase: parity-alternating disjoint adjacent pairs
    const bool do_swap = it % swap_every == 0;
    const int parity = (it / swap_every) % 2;
#pragma unroll 1
    for (int k = 0; k < K - 1; ++k) {
      const float u = uniform(key, ctr++);
      const float delta = dbeta[k] * (chi[k] - chi[k + 1]);
      if (expf(delta) > u && do_swap && parity == k % 2 && isfinite(delta)) {
#pragma unroll
        for (int p = 0; p < ODE_P; ++p) {
          const float t = lt[k][p];
          lt[k][p] = lt[k + 1][p];
          lt[k + 1][p] = t;
        }
        float t = chi[k];
        chi[k] = chi[k + 1];
        chi[k + 1] = t;
        t = rsq[k];
        rsq[k] = rsq[k + 1];
        rsq[k + 1] = t;
        if (k == 0) sw = sw + 1.0f;
      }
    }
    const int r = it - 1 - burnin;
    if (r >= 0) {
      const size_t row = (size_t)r * C + c;
#pragma unroll
      for (int p = 0; p < ODE_P; ++p)
        th_rec[((size_t)r * ODE_P + p) * C + c] = expf(lt[0][p]);
      chi_rec[row] = chi[0];
      rsq_rec[row] = rsq[0];
      aic_rec[row] = 2.0f * chi[0] + aic_const;
      ar_rec[row] = acc / (float)it;
      sw_rec[row] = sw;
    }
  }
}

}  // namespace

extern "C" {

int odelib_pt(const int* pi, const float* pf, const float* theta0,
              const float* ladder, float* th_rec, float* chi_rec,
              float* rsq_rec, float* aic_rec, float* ar_rec, float* sw_rec,
              int C, int K, int nits, int burnin, int swap_every,
              unsigned int seed, float aic_const, int stepper, void* stream) {
  if (K < 2 || K > PT_KMAX || swap_every < 1)
    return (int)cudaErrorInvalidValue;
  const int block = 32;
  const int grid = (C + block - 1) / block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stepper == 0) {
    pt_kernel<0><<<grid, block, 0, s>>>(pi, pf, theta0, ladder, th_rec,
                                         chi_rec, rsq_rec, aic_rec, ar_rec,
                                         sw_rec, C, K, nits, burnin,
                                         swap_every, seed, aic_const);
  } else {
    pt_kernel<1><<<grid, block, 0, s>>>(pi, pf, theta0, ladder, th_rec,
                                         chi_rec, rsq_rec, aic_rec, ar_rec,
                                         sw_rec, C, K, nits, burnin,
                                         swap_every, seed, aic_const);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
