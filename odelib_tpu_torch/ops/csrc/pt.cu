// Fused parallel-tempering (replica-exchange MH) kernel for Hopper (sm_90a).
//
// Replaces, in odelib_tpu/ops/pallas_pt.py:
//   pt_kernel <- _cached_pt_grid, whole-run and chunk mode (public
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
// chi - 0 is chi exactly, so they are left out. With priors (the PRIORS
// instantiations, pallas_pt.py:119,155-177) each rung carries its log
// prior lp: the walk accepts when exp(((chi - chi_new) + (lp_new - lp))
// beta_k) > u, delta is (beta_k - beta_{k+1}) ((chi - lp)_k - (chi -
// lp)_{k+1}), and lp swaps with chi and R^2.
//
// What bounds it on the card: K fixed-step solves per chain and iteration,
// long chains of dependent float32 operations, as mh_kernel; the bytes are
// the records only. With one thread per chain (the first port) the main
// path's 10,000 chains were 2.4 warps per SM, each thread solving its K
// rungs one after another: latency-bound, at K times MH's time.
//
// What the design does about it: one thread per (chain, rung). A chain is a
// group of G lanes, G the next power of two >= K (G <= PT_KMAX = 32); lane
// k < K owns rung k, its log-theta, chi and R^2 in registers (no ladder in
// local memory), and lanes k >= K idle. Blocks are 128 threads, 32/G
// chains per warp, so the main path's 10,000 x 4 rungs are 9.5 warps per
// SM, each thread doing one solve per iteration, as mh_kernel does.
//   - Walk: the rungs' draws come in closed form from the serial loop's
//     counter words: rung k starts at it 1024 + k (2 n_walked + 1) (two
//     slots per walked parameter, then its accept uniform).
//   - Swap: pair k's uniform is slot it 1024 + K (2 n_walked + 1) + k. In
//     the serial loop only pairs of the due parity can swap; those pairs are
//     disjoint, and a pair of the other parity never changes the chi that a
//     due pair reads, so the loop equals every due pair deciding at once:
//     each lane takes the partner of its due pair (if any), both lanes fetch
//     the other's chi by a width-G shuffle, compute the same delta with the
//     lower rung's chi first and the same decision, and on a swap exchange
//     log-theta, chi and R^2 by shuffles (pt_slot_layout and the swap test in
//     tests/test_torch_pt.py hold the layout against pt_plain's draws).
//   - Lane 0 of a group keeps rung 0's accepts and pair 0's swaps and writes
//     the T = 1 records, coalesced by chain.
// The launch bounds name one block per SM as the least, so ptxas does not
// trade registers for more resident blocks (with 128 threads alone it held
// the main path's zero_i kernel to 48 registers and spilled; at 1 it takes
// 93 and spills nothing; two versions are weighed by running the parent's
// and this tree's chip_smoke.py in one card call, the recipe in
// .claude/skills/verify/SKILL.md). The 32-byte frame
// is cosf's slow-path argument reduction (|x| > 105615, never 2 pi u), as
// in mh_kernel.
//
// Ladders of more than 32 rungs (the WIDE instantiations, in a library
// built with ODE_WIDE, ops/build.py): a chain no longer fits a warp. Of the
// two layouts that keep a thread per (chain, rung), a chain spanning
// ceil(K/32) warps of one block and a lane owning several rungs, this is
// the first: a lane owning R rungs would solve them one after another
// (R times the latency, and R ladders of registers), while a chain of G
// lanes over G/32 warps keeps one solve a thread and only adds block
// barriers to the swap phase. A block is max(128, G) threads, and its
// launch bound is a template argument, so ptxas may give a thread
// 65,536 / bound registers: 256 (255 registers) for G <= 256, which is
// every ladder with a walked parameter (the RNG slots allow K (2 n_walked
// + 1) + K - 1 <= 1024), and 512 (128 registers) for G = 512, the
// ladders of 257 to 512 rungs that walk nothing. At a swap every lane
// writes its rung's log-theta, chi, R^2 and log prior to shared memory,
// the block waits, each lane reads its partner's (the pairs that straddle
// a warp and those inside one alike: the barrier is needed for the first,
// and then costs the others nothing), and the block waits again before
// the planes are reused. The decisions are the shuffle layout's: each due
// pair's two lanes read the same two snapshots, so a chain's draws and
// swaps are the serial loop's, draw for draw.
//
// Chunk mode (pallas_pt.py:60-67, :106-115, :134-142, :220-225): a launch
// covers the proposals it_base + 1 .. it_end - 1. The ladder state is the
// JAX kernel's K (P + 3) + 2 planes of C: rung k's log-theta at k P + p,
// its chi at K P + k, R^2 at K P + K + k and log prior (0 without priors)
// at K P + 2 K + k, then the cold rung's accept count and the cold pair's
// swap count. With state_in each lane loads its rung's planes instead of
// scoring theta0; with state_out each live rung writes its planes and lane
// 0 the two counts. The swap parity and swap_every read the global it, so a
// run cut into launches gives the records of one launch, bitwise.
//
// Numerics: as mh.cu (-fmad=false, no fast math, constants rounded to
// float32 on the host where the JAX kernel's Python doubles meet float32),
// so it rounds like its torch twin pt_plain (ops/cuda_pt.py).
#include "common.cuh"

#ifndef PT_KMAX  // -DPT_KMAX from ops/build.py, the one place it is set
#error "PT_KMAX (rungs held per chain) must be defined by the build"
#endif
static_assert(PT_KMAX <= 32 && (PT_KMAX & (PT_KMAX - 1)) == 0,
              "a chain's rungs are one power-of-two group of a warp");

#define PT_BLOCK 128
// the WIDE instantiations' launch bounds: chains of G <= 256 lanes, and of
// G = 512 (the most the RNG slots allow)
#define PT_WIDE_BLOCK 256
#define PT_WIDEST_BLOCK 512
#ifdef ODE_WIDE
#define ODE_WIDE_ONLY(x) x
#else
#define ODE_WIDE_ONLY(x) nullptr
#endif

namespace {

using namespace odelib;

// ladder: K*P walk scales f32(rwalk_std sqrt(T_k) mask_p), P walked flags,
// K betas f32(1/T_k), K-1 pair factors f32(beta_k - beta_{k+1}).
// prior: P table entries (read by the PRIORS instantiations only).
// BOUND: 0 for a chain inside a warp, else the launch bound of a chain over
// warps (PT_WIDE_BLOCK or PT_WIDEST_BLOCK: the WIDE instantiations).
template <int STEPPER, bool PRIORS, int BOUND>
__global__ void __launch_bounds__(BOUND ? BOUND : PT_BLOCK, 1)
pt_kernel(const int* __restrict__ pi, const float* __restrict__ pf,
          const float* __restrict__ theta0, const float* __restrict__ ladder,
          const float* __restrict__ prior,
          const float* __restrict__ state_in, float* __restrict__ state_out,
          float* __restrict__ th_rec, float* __restrict__ chi_rec,
          float* __restrict__ rsq_rec, float* __restrict__ aic_rec,
          float* __restrict__ ar_rec, float* __restrict__ sw_rec, int C,
          int K, int G, int it_base, int it_end, int rec0, int swap_every,
          uint32_t seed, float aic_const) {
  constexpr bool WIDE = BOUND != 0;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int c_own = t / G;
  const int k = t % G;
  // every lane of the warp takes part in the shuffles: lanes past the last
  // chain solve its copy and store nothing
  const bool live = c_own < C;
  const int c = live ? c_own : C - 1;
  const bool rung = k < K;
  const Plan pl = load_plan(pi, pf);
  const float* scale = ladder + (rung ? k : 0) * ODE_P;
  const float* walked = ladder + K * ODE_P;
  const float beta = ladder[K * ODE_P + ODE_P + (rung ? k : 0)];
  const float* dbeta = ladder + K * ODE_P + ODE_P + K;
  int n_walked = 0;
#pragma unroll
  for (int p = 0; p < ODE_P; ++p) n_walked += walked[p] != 0.0f;
  const uint32_t per_rung = 2u * (uint32_t)n_walked + 1u;
  float lt[ODE_P], prop[ODE_P], thp[ODE_P];
  float chi, rsq, acc, sw;
  float lp = 0.0f;   // this rung's log prior
  // the state planes: rung k's log-theta, chi, R^2, log prior, then the
  // cold counts (idle lanes read rung 0's)
  const int kr = rung ? k : 0;
  const size_t P_ = ODE_P, K_ = K;
  if (state_in) {
#pragma unroll
    for (int p = 0; p < ODE_P; ++p) lt[p] = state_in[(kr * P_ + p) * C + c];
    chi = state_in[(K_ * P_ + kr) * C + c];
    rsq = state_in[(K_ * P_ + K_ + kr) * C + c];
    if constexpr (PRIORS) lp = state_in[(K_ * P_ + 2 * K_ + kr) * C + c];
    acc = state_in[(K_ * (P_ + 3)) * C + c];
    sw = state_in[(K_ * (P_ + 3) + 1) * C + c];
  } else {
#pragma unroll
    for (int p = 0; p < ODE_P; ++p) thp[p] = theta0[(size_t)p * C + c];
    score<STEPPER>(pl, thp, chi, rsq);
    if constexpr (PRIORS) lp = log_prior_sum<ODE_P>(prior, thp);
#pragma unroll
    for (int p = 0; p < ODE_P; ++p) lt[p] = logf(thp[p]);
    acc = 0.0f;
    sw = 0.0f;
  }
  const uint32_t key = mix(seed * 0x9E3779B1u + (uint32_t)c);
  for (int it = it_base + 1; it < it_end; ++it) {
    // walk phase: this lane's rung, from its closed-form first slot
    uint32_t ctr = (uint32_t)it * 1024u + (uint32_t)k * per_rung;
#pragma unroll
    for (int p = 0; p < ODE_P; ++p) {
      if (walked[p] != 0.0f) {
        prop[p] = lt[p] + scale[p] * normal(key, ctr);
        ctr += 2u;
      } else {
        prop[p] = lt[p];
      }
      thp[p] = expf(prop[p]);
    }
    float chi_new, rsq_new;
    score<STEPPER>(pl, thp, chi_new, rsq_new);
    const float u = uniform(key, ctr);
    float log_ratio = chi - chi_new;
    float lp_new = 0.0f;
    if constexpr (PRIORS) {
      lp_new = log_prior_sum<ODE_P>(prior, thp);
      log_ratio = log_ratio + (lp_new - lp);
    }
    // NaN or -inf log ratio compares false: rejected
    if (rung && expf(log_ratio * beta) > u) {
#pragma unroll
      for (int p = 0; p < ODE_P; ++p) lt[p] = prop[p];
      chi = chi_new;
      rsq = rsq_new;
      if constexpr (PRIORS) lp = lp_new;
      if (k == 0) acc = acc + 1.0f;
    }
    // swap phase: the due pairs (one parity) are disjoint, so every due
    // pair decides at once; the other parity's draws are never used
    if (it % swap_every == 0) {
      const int parity = (it / swap_every) % 2;
      const int lo = (k % 2 == parity) ? k : k - 1;   // this lane's pair
      const bool paired = rung && lo >= 0 && lo + 1 < K;
      const int partner = paired ? (lo == k ? k + 1 : lo) : k;
      // WIDE: the planes xs of the block's lanes, written before a barrier
      extern __shared__ float xs[];
      const int nb = blockDim.x, me = threadIdx.x, other = me - k + partner;
      if constexpr (WIDE) {
        xs[me] = chi;
        xs[nb + me] = rsq;
        xs[2 * nb + me] = lp;
#pragma unroll
        for (int p = 0; p < ODE_P; ++p) xs[(3 + p) * nb + me] = lt[p];
        __syncthreads();
      }
      // the partner lane's value of plane `plane`
      auto from_partner = [&](float v, int plane) {
        if constexpr (WIDE) {
          return xs[plane * nb + other];
        } else {
          return __shfl_sync(0xFFFFFFFFu, v, partner, G);
        }
      };
      const float chi_o = from_partner(chi, 0);
      const float u_s = uniform(key, (uint32_t)it * 1024u +
                                         (uint32_t)K * per_rung +
                                         (uint32_t)(paired ? lo : 0));
      // the energies chi - lp (chi alone without priors), lower rung first
      float e = chi, e_o = chi_o, lp_o = 0.0f;
      if constexpr (PRIORS) {
        lp_o = from_partner(lp, 2);
        e = chi - lp;
        e_o = chi_o - lp_o;
      }
      const float delta = dbeta[paired ? lo : 0] *
                          (lo == k ? e - e_o : e_o - e);
      const bool swap = paired && expf(delta) > u_s && isfinite(delta);
#pragma unroll
      for (int p = 0; p < ODE_P; ++p) {
        const float o = from_partner(lt[p], 3 + p);
        if (swap) lt[p] = o;
      }
      const float rsq_o = from_partner(rsq, 1);
      if constexpr (WIDE) __syncthreads();   // every lane has read xs
      if (swap) {
        chi = chi_o;
        rsq = rsq_o;
        if constexpr (PRIORS) lp = lp_o;
        if (k == 0) sw = sw + 1.0f;
      }
    }
    const int r = it - 1 - rec0;
    if (r >= 0 && k == 0 && live) {
      const size_t row = (size_t)r * C + c;
#pragma unroll
      for (int p = 0; p < ODE_P; ++p)
        th_rec[((size_t)r * ODE_P + p) * C + c] = expf(lt[p]);
      chi_rec[row] = chi;
      rsq_rec[row] = rsq;
      aic_rec[row] = 2.0f * chi + aic_const;
      ar_rec[row] = acc / (float)it;
      sw_rec[row] = sw;
    }
  }
  if (state_out && rung && live) {
#pragma unroll
    for (int p = 0; p < ODE_P; ++p) state_out[(k * P_ + p) * C + c] = lt[p];
    state_out[(K_ * P_ + k) * C + c] = chi;
    state_out[(K_ * P_ + K_ + k) * C + c] = rsq;
    state_out[(K_ * P_ + 2 * K_ + k) * C + c] = lp;
    if (k == 0) {
      state_out[(K_ * (P_ + 3)) * C + c] = acc;
      state_out[(K_ * (P_ + 3) + 1) * C + c] = sw;
    }
  }
}

}  // namespace

extern "C" {

// prior: P table entries of PRIOR_WIDTH floats, or null for none. The
// launch runs iterations it_base + 1 .. it_end - 1 and records iteration it
// in row it - 1 - rec0 where that is >= 0 (a whole run: it_base = 0,
// it_end = nits, rec0 = burnin; a chunk: rec0 = it_base). state_in (or
// null: score theta0) and state_out (or null) are K (P + 3) + 2 planes of C.
int odelib_pt(const int* pi, const float* pf, const float* theta0,
              const float* ladder, const float* prior, const float* state_in,
              float* state_out, float* th_rec, float* chi_rec,
              float* rsq_rec, float* aic_rec, float* ar_rec, float* sw_rec,
              int C, int K, int it_base, int it_end, int rec0,
              int swap_every, unsigned int seed, float aic_const,
              int stepper, void* stream) {
  if (K < 2 || K > PT_WIDEST_BLOCK || swap_every < 1 || C < 1 || it_base < 0
      || it_end <= it_base)
    return (int)cudaErrorInvalidValue;
  int G = 2;
  while (G < K) G <<= 1;
  const bool wide = K > PT_KMAX;
  const int block = wide && G > PT_BLOCK ? G : PT_BLOCK;
  const int bound = !wide ? 0 : G <= PT_WIDE_BLOCK ? 1 : 2;
  const size_t smem = wide ? sizeof(float) * (3 + ODE_P) * block : 0;
  const long long threads = (long long)C * G;
  const int grid = (int)((threads + block - 1) / block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using Kernel = decltype(&pt_kernel<0, false, 0>);
  // [stepper][priors][bound]; the kvaerno3 row needs ODE_KVAERNO3, the
  // wide entries ODE_WIDE
#define PT_ROW(S, PR)                                                    \
  {&pt_kernel<S, PR, 0>,                                                 \
   ODE_WIDE_ONLY((&pt_kernel<S, PR, PT_WIDE_BLOCK>)),                    \
   ODE_WIDE_ONLY((&pt_kernel<S, PR, PT_WIDEST_BLOCK>))}
#define PT_KV3_ROW(PR)                                                   \
  {ODE_KV3((&pt_kernel<3, PR, 0>)),                                      \
   ODE_WIDE_ONLY(ODE_KV3((&pt_kernel<3, PR, PT_WIDE_BLOCK>))),           \
   ODE_WIDE_ONLY(ODE_KV3((&pt_kernel<3, PR, PT_WIDEST_BLOCK>)))}
  const Kernel kernels[3][2][3] = {
      {PT_ROW(0, false), PT_ROW(0, true)},
      {PT_ROW(1, false), PT_ROW(1, true)},
      {PT_KV3_ROW(false), PT_KV3_ROW(true)}};
#undef PT_ROW
#undef PT_KV3_ROW
  const int row = stepper_row(stepper);
  if (row < 0 || !kernels[row][prior != nullptr][bound])
    return (int)cudaErrorInvalidValue;
  const Kernel kernel = kernels[row][prior != nullptr][bound];
  kernel<<<grid, block, smem, s>>>(pi, pf, theta0, ladder, prior, state_in,
                                   state_out, th_rec, chi_rec, rsq_rec,
                                   aic_rec, ar_rec, sw_rec, C, K, G, it_base,
                                   it_end, rec0, swap_every, seed, aic_const);
  return (int)cudaGetLastError();
}

}  // extern "C"
