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
// Fits of more than JOINT_KMAX = 8 experiments or JOINT_DMAX = 64 slots
// (the WIDE instantiations, in a library built with ODE_WIDE,
// ops/build.py; the others compile to the code without it). A
// block of K warps under __launch_bounds__(32 K, 1) would cap every
// instantiation's registers at 65,536 / 32 K (64 at K = 32: the K = 2
// kernel takes 72 and would spill), so the block stays at most JOINT_KMAX
// warps and they loop: with W = min(K, 8) warps, warp w draws dimensions
// w, w + W, ..., scores experiments w, w + W, ... (each experiment's plan
// loaded where it is scored), and writes their records; chi and the ratio
// go to warps D mod W and (D + 1) mod W. The chain's accepted parts live
// in shared memory beside the proposal's (a warp owns several), and the
// total is still summed in k order from part 0 after the second barrier,
// so the records are joint_plain's. The log-theta and proposal planes (2 D
// x 32 floats) sit in shared memory, opting in above 48 KB (at most the
// card's opt-in maximum, 227 KB on the H100); where even that cannot hold
// them, in device memory (2 D x 32 floats a block, allocated on the
// launch's stream), the layout unchanged. The plans are staged as
// without WIDE, where everything fits in 48 KB.
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

// Shared words the block needs besides the plans: the log-theta and
// proposal planes (unless WIDE keeps them in device memory), the
// proposal's parts (and under WIDE the chain's), the slots and the
// experiment table.
__host__ __device__ constexpr int state_words(int D, int K, int ew,
                                              bool wide = false,
                                              bool planes = true) {
  return (planes ? 2 * D * 32 : 0) + (wide ? 2 : 1) * K * 32 + D + K * ew;
}

// One block per SM named as the least, so ptxas does not trade registers
// for resident blocks (with the block size alone it held the one-state GBM
// model's builds to 48 registers and spilled 16 bytes). CHUNK reads
// it_base and the state in and out. WIDE (fits of more than JOINT_KMAX
// experiments or JOINT_DMAX slots, see the header): W = blockDim.x / 32
// warps loop over the experiments and dimensions, the chain's parts in
// shared memory (cur), and planes_g holds the log-theta and proposal
// planes (2 D x 32 floats a block) where they are in device memory, else
// null. Without WIDE, W = K, warp w scores experiment w with its plan
// loaded once, keeps its part in a register, and planes_g is not read.
template <int STEPPER, bool PRIORS, bool CHUNK, bool WIDE>
__global__ void __launch_bounds__(32 * JOINT_KMAX, 1)
joint_kernel(const JointArgs a, float* __restrict__ planes_g) {
  extern __shared__ uint32_t smem[];
  const int C = a.C, D = a.D, K = a.K;
  const int W = WIDE ? (int)blockDim.x / 32 : K;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int c_own = blockIdx.x * 32 + lane;
  const bool live = c_own < C;
  const int c = live ? c_own : C - 1;
  const bool planes_in_smem = !WIDE || planes_g == nullptr;
  float* lt = planes_in_smem ? reinterpret_cast<float*>(smem)
                             : planes_g + (size_t)blockIdx.x * (2 * D * 32);
  float* prop = lt + D * 32;                     // D x 32
  float* part = planes_in_smem ? prop + D * 32   // K x 32: the proposal's
                               : reinterpret_cast<float*>(smem);
  float* cur = part + K * 32;                    // WIDE: K x 32, the chain's
  int* slot = reinterpret_cast<int*>(WIDE ? cur + K * 32 : cur);
  const int* tab = stage(a.exp_tab, slot + D, K * a.ew);   // D: -1 static
  const int* pi = a.pi_all;
  const float* pf = a.pf_all;
  if (a.n_i > 0) {
    int* si = slot + D + K * a.ew;
    pi = stage(a.pi_all, si, a.n_i);
    pf = stage(a.pf_all, reinterpret_cast<float*>(si + a.n_i), a.n_f);
  }
  int n_walked = 0;
  for (int d = 0; d < D; ++d) {
    const bool wk = a.walk[D + d] != 0.0f;
    if (d % blockDim.x == threadIdx.x) slot[d] = wk ? 2 * n_walked : -1;
    n_walked += wk;
  }
  __syncthreads();
  // without WIDE warp w's experiment, loaded once
  const int* e_w = tab + w * a.ew;
  const Plan pl_w = load_plan(pi + e_w[0], pf + e_w[1]);
  const int model_w = e_w[2];
  // experiment k's part at the joint theta th(d): its plan, model and map
  auto score_k = [&](int k, auto th) {
    const int* e = WIDE ? tab + k * a.ew : e_w;
    const Plan pl = WIDE ? load_plan(pi + e[0], pf + e[1]) : pl_w;
    return score_experiment<STEPPER>(pl, WIDE ? e[2] : model_w,
                                     [&](int j) { return th(e[3 + j]); });
  };

  float part_k = 0.0f, chi, lp = 0.0f, acc = 0.0f;   // part_k: not WIDE
  if (CHUNK && a.state_in) {
    const float* st = a.state_in;
    for (int d = w; d < D; d += W) lt[d * 32 + lane] = st[(size_t)d * C + c];
    if constexpr (WIDE) {
      for (int k = w; k < K; k += W)
        cur[k * 32 + lane] = st[(size_t)(D + 1 + k) * C + c];
    } else {
      part_k = st[(size_t)(D + 1 + w) * C + c];
    }
    chi = st[(size_t)D * C + c];
    acc = st[(size_t)(D + K + 1) * C + c];
    if constexpr (PRIORS) lp = st[(size_t)(D + K + 2) * C + c];
    __syncthreads();   // every warp holds the loaded state
  } else {
    auto theta0 = [&](int d) { return a.theta0[(size_t)d * C + c]; };
    if constexpr (WIDE) {
      for (int k = w; k < K; k += W) cur[k * 32 + lane] = score_k(k, theta0);
    } else {
      part_k = score_k(w, theta0);
      part[w * 32 + lane] = part_k;
    }
    for (int d = w; d < D; d += W)
      lt[d * 32 + lane] = logf(a.theta0[(size_t)d * C + c]);
    __syncthreads();
    const float* own = WIDE ? cur : part;
    chi = own[lane];
    for (int kk = 1; kk < K; ++kk) chi = chi + own[kk * 32 + lane];
    if constexpr (PRIORS) lp = joint_log_prior(a.prior, D, theta0);
  }
  const uint32_t key = mix(a.seed * 0x9E3779B1u + (uint32_t)c);
  for (int it = (CHUNK ? a.it_base : 0) + 1; it < a.it_end; ++it) {
    const uint32_t base = (uint32_t)it * 1024u;
    for (int d = w; d < D; d += W) {
      const float l0 = lt[d * 32 + lane];
      prop[d * 32 + lane] =
          slot[d] >= 0 ? l0 + a.walk[d] * normal(key, base + (uint32_t)slot[d])
                       : l0;
    }
    __syncthreads();   // the proposal is drawn
    auto proposed = [&](int d) { return expf(prop[d * 32 + lane]); };
    float part_new = 0.0f;
    if constexpr (WIDE) {
      for (int k = w; k < K; k += W)
        part[k * 32 + lane] = score_k(k, proposed);
    } else {
      part_new = score_k(w, proposed);
      part[w * 32 + lane] = part_new;
    }
    // the proposal's log prior reads every dimension of prop: before the
    // barrier, since past it a warp that runs ahead draws the next
    // proposal of its dimensions into prop
    float lp_new = 0.0f;
    if constexpr (PRIORS) lp_new = joint_log_prior(a.prior, D, proposed);
    __syncthreads();   // every part is scored
    float chi_new = part[lane];
    for (int kk = 1; kk < K; ++kk) chi_new = chi_new + part[kk * 32 + lane];
    const float u = uniform(key, base + 2u * (uint32_t)n_walked);
    float log_ratio = chi - chi_new;
    if constexpr (PRIORS) log_ratio = log_ratio + (lp_new - lp);
    // NaN or -inf log ratio compares false: rejected
    if (expf(log_ratio) > u) {
      for (int d = w; d < D; d += W) lt[d * 32 + lane] = prop[d * 32 + lane];
      if constexpr (WIDE) {
        for (int k = w; k < K; k += W)
          cur[k * 32 + lane] = part[k * 32 + lane];
      } else {
        part_k = part_new;
      }
      chi = chi_new;
      if constexpr (PRIORS) lp = lp_new;
      acc = acc + 1.0f;
    }
    const int r = it - 1 - a.rec0;
    if (r >= 0 && live) {
      for (int d = w; d < D; d += W)
        a.th_rec[((size_t)r * D + d) * C + c] = expf(lt[d * 32 + lane]);
      if constexpr (WIDE) {
        for (int k = w; k < K; k += W)
          a.parts_rec[((size_t)r * K + k) * C + c] = cur[k * 32 + lane];
      } else {
        a.parts_rec[((size_t)r * K + w) * C + c] = part_k;
      }
      if (w == D % W) a.chi_rec[(size_t)r * C + c] = chi;
      if (w == (D + 1) % W) a.ar_rec[(size_t)r * C + c] = acc / (float)it;
    }
  }
  if (CHUNK && a.state_out && live) {
    float* st = a.state_out;
    for (int d = w; d < D; d += W) st[(size_t)d * C + c] = lt[d * 32 + lane];
    if constexpr (WIDE) {
      for (int k = w; k < K; k += W)
        st[(size_t)(D + 1 + k) * C + c] = cur[k * 32 + lane];
    } else {
      st[(size_t)(D + 1 + w) * C + c] = part_k;
    }
    if (w == D % W) {
      st[(size_t)D * C + c] = chi;
      st[(size_t)(D + K + 1) * C + c] = acc;
      st[(size_t)(D + K + 2) * C + c] = lp;
    }
  }
}

#ifdef ODE_WIDE
// Launch joint_kernel's WIDE instantiations: W = min(K, JOINT_KMAX) warps
// a block, the planes in shared memory where the block's words fit the
// card's opt-in maximum (or smem_cap bytes where that is smaller and not
// 0), else in device memory.
int launch_wide(JointArgs a, int stepper, bool priors, bool chunk,
                int smem_cap, cudaStream_t s) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t cap = smem_cap > 0 && smem_cap < optin ? smem_cap : optin;
  const size_t planes = sizeof(float) * 2 * (size_t)a.D * 32;
  size_t smem = sizeof(int) * (size_t)state_words(a.D, a.K, a.ew, true,
                                                  false);
  const bool in_smem = smem + planes <= cap;
  if (in_smem) smem += planes;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  const size_t plans = sizeof(int) * ((size_t)a.n_i + (size_t)a.n_f);
  if (smem + plans <= odelib::SMEM_STAGE_MAX) {
    smem += plans;
  } else {
    a.n_i = a.n_f = 0;
  }
  const int grid = (a.C + 31) / 32;
  const int W = a.K < JOINT_KMAX ? a.K : JOINT_KMAX;
  void (*const kernels[2][2][2])(const JointArgs, float*) = {
      {{&joint_kernel<0, false, false, true>,
        &joint_kernel<0, false, true, true>},
       {&joint_kernel<0, true, false, true>,
        &joint_kernel<0, true, true, true>}},
      {{&joint_kernel<1, false, false, true>,
        &joint_kernel<1, false, true, true>},
       {&joint_kernel<1, true, false, true>,
        &joint_kernel<1, true, true, true>}}};
  const auto kernel = kernels[stepper != 0][priors][chunk];
  if (smem > odelib::SMEM_STAGE_MAX) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  float* planes_g = nullptr;
  if (!in_smem) {
    err = cudaMallocAsync(reinterpret_cast<void**>(&planes_g),
                          planes * grid, s);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, 32 * W, smem, s>>>(a, planes_g);
  err = cudaGetLastError();
  if (planes_g) {
    const cudaError_t e2 = cudaFreeAsync(planes_g, s);
    if (err == cudaSuccess) err = e2;
  }
  return (int)err;
}
#endif  // ODE_WIDE

}  // namespace

extern "C" {

// prior: D table entries of PRIOR_WIDTH floats, or null for none. The
// launch runs iterations it_base + 1 .. it_end - 1 and records iteration
// it in row it - 1 - rec0 where that is >= 0 (a whole run: it_base = 0,
// it_end = nits, rec0 = burnin; a chunk: rec0 = it_base). state_in (or
// null: score theta0) and state_out (or null) are (D + K + 3) x C. More
// than JOINT_KMAX experiments or JOINT_DMAX slots launch the WIDE
// instantiations (a library built with ODE_WIDE; another returns an
// error), their planes in shared memory up to smem_cap bytes (0: the
// card's opt-in maximum).
int odelib_joint(const int* pi_all, int n_i, const float* pf_all, int n_f,
                 const int* exp_tab, int ew, const float* theta0,
                 const float* walk, const float* prior, const float* state_in,
                 float* state_out, float* th_rec, float* chi_rec,
                 float* parts_rec, float* ar_rec, int C, int D, int K,
                 int it_base, int it_end, int rec0, unsigned int seed,
                 int stepper, int smem_cap, void* stream) {
  if (D < 1 || K < 1 || C < 1 || ew < 3 + ODE_PMAX || it_base < 0
      || it_end <= it_base)
    return (int)cudaErrorInvalidValue;
  if (K > JOINT_KMAX || D > JOINT_DMAX) {
#ifdef ODE_WIDE
    const JointArgs a{pi_all, pf_all, exp_tab, theta0, walk, prior,
                      state_in, state_out, th_rec, chi_rec, parts_rec,
                      ar_rec, ew, C, D, K, it_base, it_end, rec0, n_i, n_f,
                      seed};
    return launch_wide(a, stepper, prior != nullptr,
                       state_in != nullptr || state_out != nullptr,
                       smem_cap, static_cast<cudaStream_t>(stream));
#else
    return (int)cudaErrorInvalidValue;
#endif
  }
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
  void (*const kernels[2][2][2])(const JointArgs, float*) = {
      {{&joint_kernel<0, false, false, false>,
        &joint_kernel<0, false, true, false>},
       {&joint_kernel<0, true, false, false>,
        &joint_kernel<0, true, true, false>}},
      {{&joint_kernel<1, false, false, false>,
        &joint_kernel<1, false, true, false>},
       {&joint_kernel<1, true, false, false>,
        &joint_kernel<1, true, true, false>}}};
  kernels[stepper != 0][prior != nullptr]
         [state_in != nullptr || state_out != nullptr]<<<grid, 32 * K, smem,
                                                          s>>>(a, nullptr);
  return (int)cudaGetLastError();
}

}  // extern "C"
