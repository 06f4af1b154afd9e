// Fused joint (multi-experiment) Metropolis-Hastings kernel for Hopper
// (sm_90a).
//
// Replaces, in odelib_tpu/ops/pallas_joint.py:
//   joint_kernel <- _cached_joint_grid, whole-run and chunk mode
//                   (public joint_metropolis_hastings_fused;
//                   _cached_joint_run_chunk, _joint_fused_chunked)
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
// from the proposal in shared memory, in dimension order, before the
// barrier that ends the scoring (past it a warp may draw its next
// proposal), so all K warps hold the same value and make the same
// decision without another barrier. The RNG is the MH kernel's
// (key mix(seed * 0x9E3779B1 + c) on the global chain index c, counter
// it * 1024 + slot), so no block layout changes a chain's draws.
//
// Chunk mode (pallas_joint.py:212-345, :389-470): a launch covers the
// proposals it_base + 1 .. it_end - 1 and records iteration it in row
// it - 1 - rec0 (a whole run: it_base = 0, it_end = nits, rec0 = burnin,
// so burn-in rows are not written; a chunk: rec0 = it_base). With
// state_in the D + K + 3 planes of the JAX kernel's state block (D
// log-thetas, the total chi, the K parts, the accept count, the log
// prior: 0 without priors) replace the scoring of theta0; warp k loads
// its dimensions and its part, and a block barrier follows, so every warp
// starts the first proposal from the loaded state. At the end warp k
// writes its dimensions and part to state_out, and the warp that records
// chi the chain's scalars. The counters and acc / it read the global it,
// so a run cut into launches gives one launch's records. The CHUNK
// template flag compiles the state's load and store in; the whole run is
// the false instantiation, the code without chunks.
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
  const float* state_in; // (D + K + 3) x C chain state, or null: score theta0
  float* state_out;      // (D + K + 3) x C chain state at the end, or null
  float* th_rec;
  float* chi_rec;
  float* parts_rec;
  float* ar_rec;
  int ew, C, D, K;
  int it_base, it_end;   // the launch's proposals: it_base + 1 .. it_end - 1
  int rec0;              // row it - 1 - rec0 records iteration it (if >= 0)
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
// model's builds to 48 registers and spilled 16 bytes). CHUNK reads
// it_base and the state in and out.
template <int STEPPER, bool PRIORS, bool CHUNK>
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

  float part_k, chi, lp = 0.0f, acc = 0.0f;
  if (CHUNK && a.state_in) {
    const float* st = a.state_in;
    for (int d = k; d < D; d += K) lt[d * 32 + lane] = st[(size_t)d * C + c];
    part_k = st[(size_t)(D + 1 + k) * C + c];
    chi = st[(size_t)D * C + c];
    acc = st[(size_t)(D + K + 1) * C + c];
    if constexpr (PRIORS) lp = st[(size_t)(D + K + 2) * C + c];
    __syncthreads();   // every warp holds the loaded state
  } else {
    part_k = score_experiment<STEPPER>(pl, model, [&](int j) {
      return a.theta0[(size_t)idx[j] * C + c];
    });
    part[k * 32 + lane] = part_k;
    for (int d = k; d < D; d += K)
      lt[d * 32 + lane] = logf(a.theta0[(size_t)d * C + c]);
    __syncthreads();
    chi = part[lane];
    for (int kk = 1; kk < K; ++kk) chi = chi + part[kk * 32 + lane];
    if constexpr (PRIORS)
      lp = joint_log_prior(a.prior, D, [&](int d) {
        return a.theta0[(size_t)d * C + c];
      });
  }
  const uint32_t key = mix(a.seed * 0x9E3779B1u + (uint32_t)c);
  for (int it = (CHUNK ? a.it_base : 0) + 1; it < a.it_end; ++it) {
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
    // the proposal's log prior reads every dimension of prop: before the
    // barrier, since past it a warp that runs ahead draws the next
    // proposal of its dimensions into prop
    float lp_new = 0.0f;
    if constexpr (PRIORS)
      lp_new = joint_log_prior(a.prior, D, [&](int d) {
        return expf(prop[d * 32 + lane]);
      });
    __syncthreads();   // every part is scored
    float chi_new = part[lane];
    for (int kk = 1; kk < K; ++kk) chi_new = chi_new + part[kk * 32 + lane];
    const float u = uniform(key, base + 2u * (uint32_t)n_walked);
    float log_ratio = chi - chi_new;
    if constexpr (PRIORS) log_ratio = log_ratio + (lp_new - lp);
    // NaN or -inf log ratio compares false: rejected
    if (expf(log_ratio) > u) {
      for (int d = k; d < D; d += K) lt[d * 32 + lane] = prop[d * 32 + lane];
      part_k = part_new;
      chi = chi_new;
      if constexpr (PRIORS) lp = lp_new;
      acc = acc + 1.0f;
    }
    const int r = it - 1 - a.rec0;
    if (r >= 0 && live) {
      for (int d = k; d < D; d += K)
        a.th_rec[((size_t)r * D + d) * C + c] = expf(lt[d * 32 + lane]);
      a.parts_rec[((size_t)r * K + k) * C + c] = part_k;
      if (k == D % K) a.chi_rec[(size_t)r * C + c] = chi;
      if (k == (D + 1) % K) a.ar_rec[(size_t)r * C + c] = acc / (float)it;
    }
  }
  if (CHUNK && a.state_out && live) {
    float* st = a.state_out;
    for (int d = k; d < D; d += K) st[(size_t)d * C + c] = lt[d * 32 + lane];
    st[(size_t)(D + 1 + k) * C + c] = part_k;
    if (k == D % K) {
      st[(size_t)D * C + c] = chi;
      st[(size_t)(D + K + 1) * C + c] = acc;
      st[(size_t)(D + K + 2) * C + c] = lp;
    }
  }
}

}  // namespace

extern "C" {

// prior: D table entries of PRIOR_WIDTH floats, or null for none. The
// launch runs iterations it_base + 1 .. it_end - 1 and records iteration
// it in row it - 1 - rec0 where that is >= 0 (a whole run: it_base = 0,
// it_end = nits, rec0 = burnin; a chunk: rec0 = it_base). state_in (or
// null: score theta0) and state_out (or null) are (D + K + 3) x C.
int odelib_joint(const int* pi_all, int n_i, const float* pf_all, int n_f,
                 const int* exp_tab, int ew, const float* theta0,
                 const float* walk, const float* prior, const float* state_in,
                 float* state_out, float* th_rec, float* chi_rec,
                 float* parts_rec, float* ar_rec, int C, int D, int K,
                 int it_base, int it_end, int rec0, unsigned int seed,
                 int stepper, void* stream) {
  if (D < 1 || D > JOINT_DMAX || K < 1 || K > JOINT_KMAX || C < 1
      || ew < 3 + ODE_PMAX || it_base < 0 || it_end <= it_base)
    return (int)cudaErrorInvalidValue;
  size_t smem = sizeof(int) * (size_t)state_words(D, K, ew);
  const size_t plans = sizeof(int) * ((size_t)n_i + (size_t)n_f);
  if (smem + plans <= odelib::SMEM_STAGE_MAX) {
    smem += plans;
  } else {
    n_i = n_f = 0;
  }
  const JointArgs a{pi_all, pf_all, exp_tab, theta0, walk, prior, state_in,
                    state_out, th_rec, chi_rec, parts_rec, ar_rec, ew, C, D,
                    K, it_base, it_end, rec0, n_i, n_f, seed};
  const int grid = (C + 31) / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // [stepper][priors][chunk]
  void (*const kernels[2][2][2])(const JointArgs) = {
      {{&joint_kernel<0, false, false>, &joint_kernel<0, false, true>},
       {&joint_kernel<0, true, false>, &joint_kernel<0, true, true>}},
      {{&joint_kernel<1, false, false>, &joint_kernel<1, false, true>},
       {&joint_kernel<1, true, false>, &joint_kernel<1, true, true>}}};
  kernels[stepper != 0][prior != nullptr]
         [state_in != nullptr || state_out != nullptr]<<<grid, 32 * K, smem,
                                                          s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
