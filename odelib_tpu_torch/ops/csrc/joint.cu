// Fused joint (multi-experiment) Metropolis-Hastings kernel for Hopper
// (sm_90a).
//
// Replaces, in odelib_tpu/ops/pallas_joint.py:
//   joint_kernel <- _cached_joint_grid, whole-run mode (public
//                   joint_metropolis_hastings_fused)
//
// Semantics. Each chain walks a D-dimensional joint log-theta. Per
// iteration it draws two Box-Muller slots per walked joint dimension, in
// dimension order, scores every experiment k = 0..K-1 on the gathered
// theta[idx_k] with the experiment's own plan (grid, y0, observations) and
// model, sums the parts in k order starting from part 0
// (pallas_joint.py:370-380), then draws the accept uniform: after the
// score, at slot 2W, W the walked dimensions (pallas_joint.py:439-449).
// It accepts when exp(chi - chi_new) > u, so a NaN ratio rejects, and
// records theta, the total chi, the K parts and the running acceptance
// ratio acc / it. Burn-in rows are not written. The RNG is the MH kernel's
// (key mix(seed * 0x9E3779B1 + c) on the global chain index c, counter
// it * 1024 + slot), so no block layout changes a chain's draws.
//
// What bounds it on the card: K dependent fixed-step solves per chain and
// iteration, as mh_kernel does one; the bytes are the records only. At the
// main path's 10,000 chains (2.4 warps per SM) it is bound by latency.
//
// What the design does about it: one thread per chain and the whole run in
// the thread, 32-thread blocks spread over every SM, as mh_kernel. The
// joint state (D log-thetas, the proposal) and the K parts are
// thread-local arrays indexed at run time (L1-cached local memory); each
// experiment's theta is gathered into registers through its idx map inside
// a switch over the experiment's model, so every model of the fit is
// compiled in (ODE_MODELS, generated by ops/build.py) and selected per
// experiment at run time. The plans are the MH kernel's runtime tables,
// concatenated; each experiment reads its own through two offsets.
//
// Numerics: as mh.cu (-fmad=false, no fast math, constants rounded to
// float32 on the host), so it rounds like its torch twin joint_plain
// (ops/cuda_joint.py).
#include "common.cuh"

#if !defined(JOINT_KMAX) || !defined(JOINT_DMAX)
#error "JOINT_KMAX and JOINT_DMAX must be defined by the build (ops/build.py)"
#endif

namespace {

using namespace odelib;

// Experiment table entry: plan_i offset, plan_f offset, model, then the
// experiment's idx map (ODE_PMAX entries, the first Model::P used).
template <int STEPPER>
__device__ __forceinline__ float score_experiment(const int* e,
                                                  const int* pi_all,
                                                  const float* pf_all,
                                                  const float* th) {
  const Plan pl = load_plan(pi_all + e[0], pf_all + e[1]);
  const int* idx = e + 3;
  float chi = 0.0f, rsq = 0.0f;
  switch (e[2]) {
#define ODELIB_JOINT_CASE(i)                                   \
  case i: {                                                    \
    float tk[Model##i::P];                                     \
    for (int j = 0; j < Model##i::P; ++j) tk[j] = th[idx[j]];  \
    score_model<Model##i, STEPPER>(pl, tk, chi, rsq);          \
  } break;
    ODE_MODELS(ODELIB_JOINT_CASE)
#undef ODELIB_JOINT_CASE
    default:
      chi = NAN;
  }
  return chi;
}

template <int STEPPER>
__device__ __forceinline__ float joint_score(const int* exp_tab, int ew,
                                             int K, const int* pi_all,
                                             const float* pf_all,
                                             const float* th, float* parts) {
  float total = 0.0f;
  for (int k = 0; k < K; ++k) {
    parts[k] = score_experiment<STEPPER>(exp_tab + k * ew, pi_all, pf_all,
                                         th);
    total = k ? total + parts[k] : parts[k];
  }
  return total;
}

// walk: D per-dimension scales f32(rwalk_std * mask_d), then D walked flags.
template <int STEPPER>
__global__ void __launch_bounds__(32)
joint_kernel(const int* __restrict__ pi_all, const float* __restrict__ pf_all,
             const int* __restrict__ exp_tab, int ew,
             const float* __restrict__ theta0, const float* __restrict__ walk,
             float* __restrict__ th_rec, float* __restrict__ chi_rec,
             float* __restrict__ parts_rec, float* __restrict__ ar_rec, int C,
             int D, int K, int nits, int burnin, uint32_t seed) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float lt[JOINT_DMAX], prop[JOINT_DMAX], th[JOINT_DMAX];
  float parts[JOINT_KMAX], parts_new[JOINT_KMAX];
  for (int d = 0; d < D; ++d) th[d] = theta0[(size_t)d * C + c];
  float chi = joint_score<STEPPER>(exp_tab, ew, K, pi_all, pf_all, th, parts);
  for (int d = 0; d < D; ++d) lt[d] = logf(th[d]);
  float acc = 0.0f;
  const uint32_t key = mix(seed * 0x9E3779B1u + (uint32_t)c);
  for (int it = 1; it < nits; ++it) {
    const uint32_t base = (uint32_t)it * 1024u;
    uint32_t slot = 0;
    for (int d = 0; d < D; ++d) {
      if (walk[D + d] != 0.0f) {
        prop[d] = lt[d] + walk[d] * normal(key, base + slot);
        slot += 2;
      } else {
        prop[d] = lt[d];
      }
      th[d] = expf(prop[d]);
    }
    const float chi_new = joint_score<STEPPER>(exp_tab, ew, K, pi_all,
                                               pf_all, th, parts_new);
    const float u = uniform(key, base + slot);
    // NaN or -inf log ratio compares false: rejected
    if (expf(chi - chi_new) > u) {
      for (int d = 0; d < D; ++d) lt[d] = prop[d];
      for (int k = 0; k < K; ++k) parts[k] = parts_new[k];
      chi = chi_new;
      acc = acc + 1.0f;
    }
    const int r = it - 1 - burnin;
    if (r >= 0) {
      for (int d = 0; d < D; ++d)
        th_rec[((size_t)r * D + d) * C + c] = expf(lt[d]);
      for (int k = 0; k < K; ++k)
        parts_rec[((size_t)r * K + k) * C + c] = parts[k];
      chi_rec[(size_t)r * C + c] = chi;
      ar_rec[(size_t)r * C + c] = acc / (float)it;
    }
  }
}

}  // namespace

extern "C" {

int odelib_joint(const int* pi_all, const float* pf_all, const int* exp_tab,
                 int ew, const float* theta0, const float* walk,
                 float* th_rec, float* chi_rec, float* parts_rec,
                 float* ar_rec, int C, int D, int K, int nits, int burnin,
                 unsigned int seed, int stepper, void* stream) {
  if (D < 1 || D > JOINT_DMAX || K < 1 || K > JOINT_KMAX || ew < 3 + ODE_PMAX)
    return (int)cudaErrorInvalidValue;
  const int block = 32;
  const int grid = (C + block - 1) / block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stepper == 0) {
    joint_kernel<0><<<grid, block, 0, s>>>(pi_all, pf_all, exp_tab, ew,
                                            theta0, walk, th_rec, chi_rec,
                                            parts_rec, ar_rec, C, D, K, nits,
                                            burnin, seed);
  } else {
    joint_kernel<1><<<grid, block, 0, s>>>(pi_all, pf_all, exp_tab, ew,
                                            theta0, walk, th_rec, chi_rec,
                                            parts_rec, ar_rec, C, D, K, nits,
                                            burnin, seed);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
