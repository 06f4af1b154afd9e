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
#include "common.cuh"  // Plan, score<STEPPER>, mix, uniform, normal

namespace {

using namespace odelib;

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
        prop[p] = lt[p] + scale[p] * normal(key, base + slot);
        slot += 2;
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
