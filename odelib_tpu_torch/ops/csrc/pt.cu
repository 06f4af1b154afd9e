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
// long chains of dependent float32 operations, as mh_kernel; the bytes are
// the records only. With one thread per chain (the first port) the main
// path's 10,000 chains were 2.4 warps per SM, each thread solving its K
// rungs one after another: latency-bound, at K times MH's time.
//
// What the design does about it: one thread per (chain, rung). A chain is a
// group of G lanes, G the next power of two >= K (G <= PT_KMAX = 8); lane
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
// 93 and spills nothing, 7 % faster: tools/ab_kernels.py). The 32-byte frame
// is cosf's slow-path argument reduction (|x| > 105615, never 2 pi u), as
// in mh_kernel.
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

namespace {

using namespace odelib;

// ladder: K*P walk scales f32(rwalk_std sqrt(T_k) mask_p), P walked flags,
// K betas f32(1/T_k), K-1 pair factors f32(beta_k - beta_{k+1}).
template <int STEPPER>
__global__ void __launch_bounds__(PT_BLOCK, 1)
pt_kernel(const int* __restrict__ pi, const float* __restrict__ pf,
          const float* __restrict__ theta0, const float* __restrict__ ladder,
          float* __restrict__ th_rec, float* __restrict__ chi_rec,
          float* __restrict__ rsq_rec, float* __restrict__ aic_rec,
          float* __restrict__ ar_rec, float* __restrict__ sw_rec, int C,
          int K, int G, int nits, int burnin, int swap_every, uint32_t seed,
          float aic_const) {
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
#pragma unroll
  for (int p = 0; p < ODE_P; ++p) thp[p] = theta0[(size_t)p * C + c];
  float chi, rsq;
  score<STEPPER>(pl, thp, chi, rsq);
#pragma unroll
  for (int p = 0; p < ODE_P; ++p) lt[p] = logf(thp[p]);
  float acc = 0.0f, sw = 0.0f;
  const uint32_t key = mix(seed * 0x9E3779B1u + (uint32_t)c);
  for (int it = 1; it < nits; ++it) {
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
    // NaN or -inf log ratio compares false: rejected
    if (rung && expf((chi - chi_new) * beta) > u) {
#pragma unroll
      for (int p = 0; p < ODE_P; ++p) lt[p] = prop[p];
      chi = chi_new;
      rsq = rsq_new;
      if (k == 0) acc = acc + 1.0f;
    }
    // swap phase: the due pairs (one parity) are disjoint, so every due
    // pair decides at once; the other parity's draws are never used
    if (it % swap_every == 0) {
      const int parity = (it / swap_every) % 2;
      const int lo = (k % 2 == parity) ? k : k - 1;   // this lane's pair
      const bool paired = rung && lo >= 0 && lo + 1 < K;
      const int partner = paired ? (lo == k ? k + 1 : lo) : k;
      const float chi_o = __shfl_sync(0xFFFFFFFFu, chi, partner, G);
      const float u_s = uniform(key, (uint32_t)it * 1024u +
                                         (uint32_t)K * per_rung +
                                         (uint32_t)(paired ? lo : 0));
      const float delta = dbeta[paired ? lo : 0] *
                          (lo == k ? chi - chi_o : chi_o - chi);
      const bool swap = paired && expf(delta) > u_s && isfinite(delta);
#pragma unroll
      for (int p = 0; p < ODE_P; ++p) {
        const float o = __shfl_sync(0xFFFFFFFFu, lt[p], partner, G);
        if (swap) lt[p] = o;
      }
      const float rsq_o = __shfl_sync(0xFFFFFFFFu, rsq, partner, G);
      if (swap) {
        chi = chi_o;
        rsq = rsq_o;
        if (k == 0) sw = sw + 1.0f;
      }
    }
    const int r = it - 1 - burnin;
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
}

}  // namespace

extern "C" {

int odelib_pt(const int* pi, const float* pf, const float* theta0,
              const float* ladder, float* th_rec, float* chi_rec,
              float* rsq_rec, float* aic_rec, float* ar_rec, float* sw_rec,
              int C, int K, int nits, int burnin, int swap_every,
              unsigned int seed, float aic_const, int stepper, void* stream) {
  if (K < 2 || K > PT_KMAX || swap_every < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  int G = 2;
  while (G < K) G <<= 1;
  const long long threads = (long long)C * G;
  const int grid = (int)((threads + PT_BLOCK - 1) / PT_BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stepper == 0) {
    pt_kernel<0><<<grid, PT_BLOCK, 0, s>>>(
        pi, pf, theta0, ladder, th_rec, chi_rec, rsq_rec, aic_rec, ar_rec,
        sw_rec, C, K, G, nits, burnin, swap_every, seed, aic_const);
  } else {
    pt_kernel<1><<<grid, PT_BLOCK, 0, s>>>(
        pi, pf, theta0, ladder, th_rec, chi_rec, rsq_rec, aic_rec, ar_rec,
        sw_rec, C, K, G, nits, burnin, swap_every, seed, aic_const);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
