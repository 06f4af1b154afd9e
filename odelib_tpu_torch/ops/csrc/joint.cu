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
// ratio acc / it. Burn-in rows are not written. With priors (the PRIORS
// instantiations, pallas_joint.py:365-426) the chain carries the log prior
// lp of its joint theta, one table entry per joint dimension, and accepts
// when exp((chi - chi_new) + (lp_new - lp)) > u: the prior enters the total
// once, not once per experiment part. Every warp evaluates lp_new itself
// from the proposal in shared memory, in dimension order, so all K warps
// hold the same value and make the same decision without another barrier. The RNG is the MH kernel's
// (key mix(seed * 0x9E3779B1 + c) on the global chain index c, counter
// it * 1024 + slot), so no block layout changes a chain's draws.
//
// What bounds it on the card: K fixed-step solves per chain and iteration,
// long chains of dependent float32 operations as in mh_kernel; the bytes
// are the records only. Latency-bound: with a thread per chain (the first
// port) the main path's 10,000 chains were 2.4 warps per SM, each thread
// solving its K experiments one after another.
//
// What the design does about it: a block is K warps and 32 chains; lane l
// is chain blockIdx.x * 32 + l and warp k scores experiment k for the
// block's 32 chains, so the K solves run side by side (the main path's
// K = 2: 4.7 warps per SM, one solve each per iteration). All 32 lanes of a
// warp run one model, so a fit of different models does not diverge inside
// a warp. Per iteration:
//   - the warps draw the proposal, dimension d by warp d mod K, from the
//     closed-form slot of d (two per walked dimension before it), into
//     shared memory, where each chain's log-theta lives too (D x 32 each);
//   - after a block barrier warp k gathers exp(prop[idx_k]) and scores,
//     and writes its part to shared memory;
//   - after a second barrier every warp sums the chain's K parts in k
//     order from part 0, draws the same uniform and makes the same accept
//     decision; warp k keeps part k, and the dimensions it drew.
// Records are spread over the warps (theta's dimension d by warp d mod K,
// part k by warp k, chi and the ratio by warps D and D + 1 mod K), all
// coalesced by chain. The experiment table and, where they fit, the K plans
// (the MH kernel's runtime tables, concatenated) are staged in shared
// memory. Lanes past the last chain score its copy, take part in every
// barrier and store nothing.
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

struct JointArgs {
  const int* pi_all;
  const float* pf_all;
  const int* exp_tab;    // per experiment: plan_i and plan_f offsets, model,
                         // then its idx map (ODE_PMAX entries)
  const float* theta0;
  const float* walk;     // D scales f32(rwalk_std * mask_d), D walked flags
  const float* prior;    // D prior table entries (PRIORS instantiations)
  float* th_rec;
  float* chi_rec;
  float* parts_rec;
  float* ar_rec;
  int ew, C, D, K, nits, burnin;
  int n_i, n_f;          // plan words staged in shared memory (0: none)
  uint32_t seed;
};

// Experiment `model`'s chi at the parameters th(j), j < its P.
template <int STEPPER, class Theta>
__device__ __forceinline__ float score_experiment(const Plan& pl, int model,
                                                  Theta th) {
  float chi = 0.0f, rsq = 0.0f;
  switch (model) {
#define ODELIB_JOINT_CASE(i)                                   \
  case i: {                                                    \
    float tk[Model##i::P];                                     \
    _Pragma("unroll")                                          \
    for (int j = 0; j < Model##i::P; ++j) tk[j] = th(j);       \
    score_model<Model##i, STEPPER>(pl, tk, chi, rsq);          \
  } break;
    ODE_MODELS(ODELIB_JOINT_CASE)
#undef ODELIB_JOINT_CASE
    default:
      chi = NAN;
  }
  return chi;
}

// The log prior of the joint theta th(d), d < D: the dimensions with a
// prior add to a zero start in dimension order.
template <class Theta>
__device__ __forceinline__ float joint_log_prior(const float* prior, int D,
                                                 Theta th) {
  float lp = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float* e = prior + PRIOR_WIDTH * d;
    if ((int)e[0] != PRIOR_NONE) lp = lp + log_prior(e, th(d));
  }
  return lp;
}

// Shared words the block needs besides the plans.
__host__ __device__ constexpr int state_words(int D, int K, int ew) {
  return 2 * D * 32 + K * 32 + D + K * ew;
}

// One block per SM named as the least, so ptxas does not trade registers
// for resident blocks (with the block size alone it held the one-state GBM
// model's builds to 48 registers and spilled 16 bytes).
template <int STEPPER, bool PRIORS>
__global__ void __launch_bounds__(32 * JOINT_KMAX, 1)
joint_kernel(const JointArgs a) {
  extern __shared__ uint32_t smem[];
  const int C = a.C, D = a.D, K = a.K;
  const int lane = threadIdx.x % 32, k = threadIdx.x / 32;
  const int c_own = blockIdx.x * 32 + lane;
  const bool live = c_own < C;
  const int c = live ? c_own : C - 1;
  float* lt = reinterpret_cast<float*>(smem);   // D x 32
  float* prop = lt + D * 32;                     // D x 32
  float* part = prop + D * 32;                   // K x 32
  int* slot = reinterpret_cast<int*>(part + K * 32);   // D: -1 if static
  const int* tab = stage(a.exp_tab, slot + D, K * a.ew);
  const int* pi = a.pi_all;
  const float* pf = a.pf_all;
  if (a.n_i > 0) {
    int* si = slot + D + K * a.ew;
    pi = stage(a.pi_all, si, a.n_i);
    pf = stage(a.pf_all, reinterpret_cast<float*>(si + a.n_i), a.n_f);
  }
  int n_walked = 0;
  for (int d = 0; d < D; ++d) {
    const bool w = a.walk[D + d] != 0.0f;
    if (d % blockDim.x == threadIdx.x) slot[d] = w ? 2 * n_walked : -1;
    n_walked += w;
  }
  __syncthreads();
  const int* e = tab + k * a.ew;
  const Plan pl = load_plan(pi + e[0], pf + e[1]);
  const int model = e[2];
  const int* idx = e + 3;

  float part_k = score_experiment<STEPPER>(pl, model, [&](int j) {
    return a.theta0[(size_t)idx[j] * C + c];
  });
  part[k * 32 + lane] = part_k;
  for (int d = k; d < D; d += K)
    lt[d * 32 + lane] = logf(a.theta0[(size_t)d * C + c]);
  __syncthreads();
  float chi = part[lane];
  for (int kk = 1; kk < K; ++kk) chi = chi + part[kk * 32 + lane];
  float lp = 0.0f;
  if constexpr (PRIORS)
    lp = joint_log_prior(a.prior, D, [&](int d) {
      return a.theta0[(size_t)d * C + c];
    });
  float acc = 0.0f;
  const uint32_t key = mix(a.seed * 0x9E3779B1u + (uint32_t)c);
  for (int it = 1; it < a.nits; ++it) {
    const uint32_t base = (uint32_t)it * 1024u;
    for (int d = k; d < D; d += K) {
      const float l0 = lt[d * 32 + lane];
      prop[d * 32 + lane] =
          slot[d] >= 0 ? l0 + a.walk[d] * normal(key, base + (uint32_t)slot[d])
                       : l0;
    }
    __syncthreads();   // the proposal is drawn
    const float part_new = score_experiment<STEPPER>(pl, model, [&](int j) {
      return expf(prop[idx[j] * 32 + lane]);
    });
    part[k * 32 + lane] = part_new;
    __syncthreads();   // every part is scored
    float chi_new = part[lane];
    for (int kk = 1; kk < K; ++kk) chi_new = chi_new + part[kk * 32 + lane];
    const float u = uniform(key, base + 2u * (uint32_t)n_walked);
    float log_ratio = chi - chi_new;
    float lp_new = 0.0f;
    if constexpr (PRIORS) {
      lp_new = joint_log_prior(a.prior, D, [&](int d) {
        return expf(prop[d * 32 + lane]);
      });
      log_ratio = log_ratio + (lp_new - lp);
    }
    // NaN or -inf log ratio compares false: rejected
    if (expf(log_ratio) > u) {
      for (int d = k; d < D; d += K) lt[d * 32 + lane] = prop[d * 32 + lane];
      part_k = part_new;
      chi = chi_new;
      if constexpr (PRIORS) lp = lp_new;
      acc = acc + 1.0f;
    }
    const int r = it - 1 - a.burnin;
    if (r >= 0 && live) {
      for (int d = k; d < D; d += K)
        a.th_rec[((size_t)r * D + d) * C + c] = expf(lt[d * 32 + lane]);
      a.parts_rec[((size_t)r * K + k) * C + c] = part_k;
      if (k == D % K) a.chi_rec[(size_t)r * C + c] = chi;
      if (k == (D + 1) % K) a.ar_rec[(size_t)r * C + c] = acc / (float)it;
    }
  }
}

}  // namespace

extern "C" {

// prior: D table entries of PRIOR_WIDTH floats, or null for none.
int odelib_joint(const int* pi_all, int n_i, const float* pf_all, int n_f,
                 const int* exp_tab, int ew, const float* theta0,
                 const float* walk, const float* prior, float* th_rec,
                 float* chi_rec, float* parts_rec, float* ar_rec, int C,
                 int D, int K, int nits, int burnin, unsigned int seed,
                 int stepper, void* stream) {
  if (D < 1 || D > JOINT_DMAX || K < 1 || K > JOINT_KMAX || C < 1
      || ew < 3 + ODE_PMAX)
    return (int)cudaErrorInvalidValue;
  size_t smem = sizeof(int) * (size_t)state_words(D, K, ew);
  const size_t plans = sizeof(int) * ((size_t)n_i + (size_t)n_f);
  if (smem + plans <= odelib::SMEM_STAGE_MAX) {
    smem += plans;
  } else {
    n_i = n_f = 0;
  }
  const JointArgs a{pi_all, pf_all, exp_tab, theta0, walk, prior, th_rec,
                    chi_rec, parts_rec, ar_rec, ew, C, D, K, nits, burnin,
                    n_i, n_f, seed};
  const int grid = (C + 31) / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void (*kernel)(const JointArgs) =
      stepper == 0
          ? (prior ? &joint_kernel<0, true> : &joint_kernel<0, false>)
          : (prior ? &joint_kernel<1, true> : &joint_kernel<1, false>);
  kernel<<<grid, 32 * K, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
