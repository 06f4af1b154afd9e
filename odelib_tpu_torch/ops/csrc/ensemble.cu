// Fused Goodman-Weare ensemble (stretch-move) sampler for Hopper (sm_90a).
//
// Replaces, in odelib_tpu/ops/pallas_mh.py:
//   ens_kernel <- _cached_ens_grid, whole-run and chunk mode (public
//                 ensemble_fused)
//
// Semantics. Walker g lies in ensemble e = g / tile; inside it, at row
// (g % tile) / 128 and lane g % 128 of the JAX kernel's (tile/128, 128)
// tile, which splits into two halves of `half` = tile/256 rows. Each
// iteration updates half A (rows [0, half)) and then half B against the
// other half's current state, so B's proposals see A's new positions. The
// partner of the walker at (r', l) of its half is row (r' - r_sub) mod half,
// lane (l - r_lane) mod 128 of the other half (jnp.roll's direction), with
// (r_sub, r_lane) drawn per ensemble and half-update from a scalar stream.
// The geometry is index arithmetic only.
//
// What bounds it on the card: as the MH kernel, each walker's proposal is
// one full fixed-step solve, a long chain of dependent float32 operations;
// the bytes moved (state, partner reads, records) are small. The halves are
// sequential by the algorithm, so the serial loop is 2 (nits - 1) solve
// latencies end to end whatever the width: the main path's 12,288 walkers
// give 6,144 solves per half-update, 1.45 warps per SM. Latency-bound.
//
// What the design does about it: one persistent cooperative launch runs
// the whole run (the first port made one launch per half-update, 1,999 a
// run), and the next A-half is solved beside the current B-half.
//   - Speculation. While half B updates at iteration it, the proposal of an
//     A walker at it + 1 can take only two values: its partner (a B walker,
//     drawn from (it + 1, A)) either rejects at it and stays, or accepts and
//     moves to its own proposal. Both are known when B's update starts: the
//     partner's proposal reads only the partner's position, its own A
//     partner (final at it) and its z draw, all from counter-keyed streams.
//     So a round solves, side by side, B's proposal at it and A's two
//     candidates at it + 1 (partner rejects, partner accepts: the accepting
//     lane recomputes the partner's proposal with the partner's own
//     operations). Each B lane decides and posts its decision (dec, 2 it +
//     accepted); each A walker then waits for its partner's post alone (a
//     spin on one word, no grid barrier), takes the matching candidate
//     without solving again, decides and records. The first round of a
//     launch solves A(it_base + 1) alone (its partner has not moved), the
//     last B(it_end - 1) alone. A launch is it_end - it_base rounds, about
//     half the serial loop's solve latencies, and each round's 3 solves a
//     column keep 4.4 warps an SM busy on the main path, not 1.45.
//   - Same operations, same operands: the candidates, the recomputed
//     partner proposal, the log ratio (n_walked - 1) log z + chi - chi_new
//     [+ lp_new - lp], the accept test and the records are the serial
//     loop's. Only which lane computes them, and when, changes, so the
//     records are bitwise ensemble_plain's (ops/cuda_mh.py; the lane-by-lane
//     emulation in tests/test_torch_ensemble_spec.py).
//   - Layout. A block is 96 threads, three warps over the same 32 columns
//     (column j: walker j of half A and of half B): warp 0 the B lanes,
//     warp 1 the A candidates whose partner rejects (and the selection),
//     warp 2 those whose partner accepts. One role a warp keeps each warp's
//     control flow uniform and leaves no idle lane, where a group of four
//     lanes a column would idle a quarter of its threads. Where the grid
//     holds fewer columns than the W/2 of the run (it is at most what can
//     be co-resident), each thread loops over columns j, j + 32 G, ...
//   - State. Walker state lives in two device buffers of (P + 4) x W
//     floats (log-theta, chi, R^2, accept count, log prior), one for each
//     parity of the iteration: iteration it's state sits in buffer
//     (it_end - 1 - it) & 1, so the launch's last state lands in `state`.
//     A round reads A at it and B at it - 1 and writes B at it and A at
//     it + 1, the other parity, so no lane overwrites what another may
//     still read, and every lane writes its walker's full state each
//     round. One grid barrier a round (an arrival counter and a generation
//     word) makes the round's writes visible to the next; within a round a
//     block barrier hands warp 2's candidates to warp 1. All buffer traffic
//     bypasses L1 (__ldcg/__stcg, volatile for dec), which is not coherent
//     across SMs. The candidates (2 x (P + 3) x W/2: proposal, chi, R^2,
//     log prior) and dec (W/2 words) are device scratch of the launch.
//   - The plan tables are staged into each block's shared memory once
//     (where they fit in 48 KB), so the solve's table reads never leave
//     the SM.
//   - Every thread reaches every barrier, columns or not. The launch is
//     cooperative, so it fails (cudaErrorCooperativeLaunchTooLarge) rather
//     than deadlock where the grid cannot be co-resident; a spinning A lane
//     waits only on B lanes, which wait on nothing within the round.
//   - Many states. At 42 states the dopri5 instantiations take 255
//     registers, so two blocks fit an SM (264 on the card, 8,448 columns a
//     pass): a run wider than that loops over columns, and co-residency,
//     not the solve's latency, then bounds it (PERF.md's 42-state row runs
//     256 walkers, one pass).
//
// With priors (the PRIORS instantiations) the buffer's last row holds each
// walker's log prior, each candidate lane evaluates the log prior of its
// own proposal beside its solve (as mh.cu's lanes do), and the ratio adds
// lp_new - lp (pallas_mh.py:1598,1631-1648); without them it is never
// written.
//
// Chunk mode (pallas_mh.py:1523-1527, :1583-1589, :1684-1688): the state
// is the JAX kernel's chunk state, (P + 4) x W. A launch covers the
// proposals it_base + 1 .. it_end - 1, starting and ending with the lone
// rounds above; with state_in it copies that state in instead of scoring
// the start points, and `state` holds the state after it_end - 1 when the
// launch ends. Both streams (the walkers' draws and the partner offsets)
// are keyed on the global iteration, so a run cut into launches gives the
// records of one launch, bitwise. Still one cooperative launch per chunk.
//
// Numerics: as mh.cu (-fmad=false, no fast math, host-rounded constants),
// so it rounds like its torch twin ensemble_plain (ops/cuda_mh.py).
#include "common.cuh"

#define ENS_COLS 32     // columns a block
#define ENS_BLOCK 96    // its three warps: B, A if B rejects, A if B accepts

namespace {

using namespace odelib;

struct EnsArgs {
  const int* pi;
  const float* pf;
  const float* theta0;
  const float* walk;     // P mask values, then P walked flags
  const float* prior;    // P prior table entries (PRIORS instantiations)
  const float* state_in; // (P + 4) x W state to start from, or null
  float* state;          // (P + 4) x W: log-theta, chi, R^2, accept count,
                         // log prior (PRIORS only); the other parity's
                         // buffer, the candidates and dec follow in work
  float* work;
  unsigned int* bar;     // the grid barrier: arrivals, generation
  float* th_rec;
  float* chi_rec;
  float* rsq_rec;
  float* aic_rec;
  float* ar_rec;
  int W, W0, tile;
  int it_base, it_end;   // the launch's proposals: it_base + 1 .. it_end - 1
  int rec0;              // row it - 1 - rec0 records iteration it (if >= 0)
  int n_i, n_f;          // plan words staged in shared memory (0: none)
  uint32_t seed;
  float am1, a, nw1, aic_const;
};

// Every block of the (cooperative, co-resident) grid waits here until all
// have arrived. Stores before it, fenced, are visible after it to loads
// that bypass L1.
__device__ __forceinline__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g0 = *gen;   // cannot move on before this block arrives
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);          // the last to arrive resets and releases
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g0) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// The partner of walker jj of ensemble e's half hb at iteration it: a
// walker of the other half, at the offset drawn per ensemble and
// half-update (pallas_mh.py's jnp.roll); its global index.
__device__ __forceinline__ int partner(const EnsArgs& a, int e, int jj,
                                       int it, int hb) {
  const int half = a.tile / 256;         // rows per half
  const int rp = jj / 128, l = jj % 128; // row within the half, lane
  const int lo = hb ? half : 0;
  const uint32_t scal_base =
      mix(a.seed * 0x7FEB352Du + (uint32_t)e * (uint32_t)a.tile + 0xE75u);
  const uint32_t sbits =
      mix(scal_base ^ mix((uint32_t)it * 2u + (uint32_t)hb));
  const int r_sub = (int)(sbits % (uint32_t)half);
  const int r_lane = (int)((sbits >> 8) % 128u);
  return e * a.tile + ((half - lo) + (rp - r_sub + half) % half) * 128
         + (l - r_lane + 128) % 128;
}

__device__ __forceinline__ uint32_t walker_key(const EnsArgs& a, int g) {
  return mix(a.seed * 0x9E3779B1u + (uint32_t)g);
}

// The stretch z of walker key's move at (it, hb): slot 2 hb of it.
__device__ __forceinline__ float stretch(const EnsArgs& a, uint32_t key,
                                         int it, int hb) {
  const float u = uniform(key, (uint32_t)it * 1024u + 2u * (uint32_t)hb);
  const float s = 1.0f + a.am1 * u;
  return (s * s) / a.a;
}

// The stretch move of one log-theta slot c towards the partner's pt, by
// omz = 1 - z and the walk scale; a static slot stays.
__device__ __forceinline__ float moved(float c, float pt, float omz,
                                       float scale, bool walked) {
  return walked ? c + (omz * (pt - c)) * scale : c;
}

// The accept test of a proposal that solved to chi_new (and log prior
// lp_new) from a walker at chi (lp): slot 2 hb + 1 of it. NaN or -inf
// compares false: rejected.
template <bool PRIORS>
__device__ __forceinline__ bool accepts(const EnsArgs& a, uint32_t key,
                                        int it, int hb, float z, float chi,
                                        float chi_new, float lp,
                                        float lp_new) {
  float log_ratio = (a.nw1 * logf(z) + chi) - chi_new;
  if constexpr (PRIORS) log_ratio = log_ratio + (lp_new - lp);
  const float uacc =
      uniform(key, (uint32_t)it * 1024u + 2u * (uint32_t)hb + 1u);
  return expf(log_ratio) > uacc;
}

// Store walker g's state (positions lt, chi, R^2, accept count, log prior)
// into the buffer st, and record it as iteration it's row where that is
// recorded.
template <bool PRIORS>
__device__ __forceinline__ void settle(const EnsArgs& a, float* st, int g,
                                       int it, const float* lt, float chi,
                                       float rsq, float acc, float lp) {
  const int W = a.W;
#pragma unroll
  for (int p = 0; p < ODE_P; ++p) __stcg(st + (size_t)p * W + g, lt[p]);
  __stcg(st + (size_t)ODE_P * W + g, chi);
  __stcg(st + (size_t)(ODE_P + 1) * W + g, rsq);
  __stcg(st + (size_t)(ODE_P + 2) * W + g, acc);
  if constexpr (PRIORS) __stcg(st + (size_t)(ODE_P + 3) * W + g, lp);
  const int r = it - 1 - a.rec0;
  if (r >= 0 && g < a.W0) {
    const size_t row = (size_t)r * a.W0 + g;
#pragma unroll
    for (int p = 0; p < ODE_P; ++p)
      a.th_rec[((size_t)r * ODE_P + p) * a.W0 + g] = expf(lt[p]);
    a.chi_rec[row] = chi;
    a.rsq_rec[row] = rsq;
    a.aic_rec[row] = 2.0f * chi + a.aic_const;
    a.ar_rec[row] = acc / (float)it;
  }
}

// PRIORS adds the log prior to the acceptance (pallas_mh.py:1631-1648); the
// false instantiations are the prior-free kernel, its code compiled out.
template <int STEPPER, bool PRIORS>
__global__ void __launch_bounds__(ENS_BLOCK) ens_kernel(const EnsArgs a) {
  extern __shared__ uint32_t smem[];
  const int* pi = a.pi;
  const float* pf = a.pf;
  if (a.n_i > 0) {
    pi = stage(a.pi, reinterpret_cast<int*>(smem), a.n_i);
    pf = stage(a.pf, reinterpret_cast<float*>(smem + a.n_i), a.n_f);
    __syncthreads();
  }
  const Plan pl = load_plan(pi, pf);
  const int W = a.W, tile = a.tile;
  const int hn = tile / 2;               // walkers per half
  const int cols = W / 2;
  const int role = threadIdx.x / ENS_COLS;
  const int T = gridDim.x * ENS_COLS;    // columns a pass of the grid
  const int t = blockIdx.x * ENS_COLS + threadIdx.x % ENS_COLS;
  const int i0 = a.it_base + 1, i1 = a.it_end - 1;
  // the buffer of iteration it's state, by parity; the last is `state`
  auto buf = [&](int it) { return ((i1 - it) & 1) ? a.work : a.state; };
  // candidate c (0: the partner rejects, 1: it accepts) of column j: row q
  float* const cand = a.work + (size_t)(ODE_P + 4) * W;
  auto cand_at = [&](int c, int q, int j) {
    return cand + ((size_t)c * (ODE_P + 3) + q) * cols + j;
  };
  volatile int* const dec =
      reinterpret_cast<volatile int*>(cand + (size_t)2 * (ODE_P + 3) * cols);
  float scale[ODE_P];
  bool walked[ODE_P];
#pragma unroll
  for (int p = 0; p < ODE_P; ++p) {
    scale[p] = a.walk[p];
    walked[p] = a.walk[ODE_P + p] != 0.0f;
  }

  // the start points (or the state the launch resumes), walker j of half
  // `role` (warps 0 and 1), into iteration it_base's buffer; no decision
  // posted yet
  if (role < 2) {
    float* st = buf(a.it_base);
    for (int j = t; j < cols; j += T) {
      const int e = j / hn;
      const int g = e * tile + role * hn + (j - e * hn);
      if (role == 0) dec[j] = -1;
      if (a.state_in) {
        for (int q = 0; q < ODE_P + 4; ++q)
          __stcg(st + (size_t)q * W + g,
                 __ldcg(a.state_in + (size_t)q * W + g));
        continue;
      }
      float th[ODE_P];
#pragma unroll
      for (int p = 0; p < ODE_P; ++p) th[p] = a.theta0[(size_t)p * W + g];
      float chi, rsq;
      score<STEPPER>(pl, th, chi, rsq);
#pragma unroll
      for (int p = 0; p < ODE_P; ++p)
        __stcg(st + (size_t)p * W + g, logf(th[p]));
      __stcg(st + (size_t)ODE_P * W + g, chi);
      __stcg(st + (size_t)(ODE_P + 1) * W + g, rsq);
      __stcg(st + (size_t)(ODE_P + 2) * W + g, 0.0f);
      if constexpr (PRIORS)
        __stcg(st + (size_t)(ODE_P + 3) * W + g,
               log_prior_sum<ODE_P>(a.prior, th));
    }
  }

  // Round r: B's update at r (r >= i0, warp 0) beside A's two candidates
  // at r + 1 (r + 1 <= i1): warp 1's if A's partner rejects at r (in the
  // first round, where the partner does not move, the proposal itself),
  // warp 2's if it accepts. One solve a lane, at one call site.
  for (int r = a.it_base; r <= i1; ++r) {
    grid_barrier(a.bar);   // A at r and B at r - 1 are final
    const float* cur = buf(r);
    // B before its update: at r - 1, or the launch's start in round one
    const float* bprev = r < i0 ? cur : buf(r - 1);
    const bool busy = role == 0 ? r >= i0
                                : r + 1 <= i1 && (role == 1 || r >= i0);
    for (int j = t; busy && j < cols; j += T) {
      const int e = j / hn, jj = j - e * hn;
      float prop[ODE_P], thp[ODE_P], lt[ODE_P];
      float chi = 0.0f, rsq = 0.0f, acc = 0.0f, lp = 0.0f, z;
      int g;
      uint32_t key = 0u;
      if (role == 0) {   // B walker jj's own proposal at r
        g = e * tile + hn + jj;
        const int gp = partner(a, e, jj, r, 1);
        key = walker_key(a, g);
        z = stretch(a, key, r, 1);
        const float omz = 1.0f - z;
#pragma unroll
        for (int p = 0; p < ODE_P; ++p) {
          lt[p] = __ldcg(bprev + (size_t)p * W + g);
          const float pt = walked[p] ? __ldcg(cur + (size_t)p * W + gp)
                                     : 0.0f;
          prop[p] = moved(lt[p], pt, omz, scale[p], walked[p]);
          thp[p] = expf(prop[p]);
        }
        chi = __ldcg(bprev + (size_t)ODE_P * W + g);
        rsq = __ldcg(bprev + (size_t)(ODE_P + 1) * W + g);
        acc = __ldcg(bprev + (size_t)(ODE_P + 2) * W + g);
        // read before the solve, which hides its L2 latency
        if constexpr (PRIORS) lp = __ldcg(bprev + (size_t)(ODE_P + 3) * W + g);
      } else {           // A walker jj's candidate at r + 1
        g = e * tile + jj;
        const int gp = partner(a, e, jj, r + 1, 0);   // a B walker
        z = stretch(a, walker_key(a, g), r + 1, 0);
        const float omz = 1.0f - z;
        int gpp = 0;
        float pomz = 0.0f;
        if (role == 2) {  // the partner's own proposal at r, recomputed
          gpp = partner(a, e, gp - e * tile - hn, r, 1);
          pomz = 1.0f - stretch(a, walker_key(a, gp), r, 1);
        }
#pragma unroll
        for (int p = 0; p < ODE_P; ++p) {
          float pt = 0.0f;
          if (walked[p]) {
            pt = __ldcg(bprev + (size_t)p * W + gp);
            if (role == 2)
              pt = moved(pt, __ldcg(cur + (size_t)p * W + gpp), pomz,
                         scale[p], true);
          }
          prop[p] = moved(__ldcg(cur + (size_t)p * W + g), pt, omz, scale[p],
                          walked[p]);
          thp[p] = expf(prop[p]);
        }
      }
      float chi_new, rsq_new;
      score<STEPPER>(pl, thp, chi_new, rsq_new);
      const float lp_new = PRIORS ? log_prior_sum<ODE_P>(a.prior, thp)
                                  : 0.0f;
      if (role == 0) {
        const bool ok =
            accepts<PRIORS>(a, key, r, 1, z, chi, chi_new, lp, lp_new);
        dec[j] = 2 * r + (int)ok;        // the A lanes wait for this word
        if (ok) {
#pragma unroll
          for (int p = 0; p < ODE_P; ++p) lt[p] = prop[p];
          chi = chi_new;
          rsq = rsq_new;
          acc = acc + 1.0f;
          lp = lp_new;
        }
        settle<PRIORS>(a, buf(r), g, r, lt, chi, rsq, acc, lp);
      } else {
        const int c = role - 1;
#pragma unroll
        for (int p = 0; p < ODE_P; ++p) __stcg(cand_at(c, p, j), prop[p]);
        __stcg(cand_at(c, ODE_P, j), chi_new);
        __stcg(cand_at(c, ODE_P + 1, j), rsq_new);
        if constexpr (PRIORS) __stcg(cand_at(c, ODE_P + 2, j), lp_new);
      }
    }
    __syncthreads();   // warp 2's candidates are in place for warp 1
    if (role == 1 && r + 1 <= i1) {
      // A at r + 1: the candidate its partner's decision at r picks
      float* nxt = buf(r + 1);
      for (int j = t; j < cols; j += T) {
        const int e = j / hn, jj = j - e * hn;
        const int g = e * tile + jj;
        int c = 0;
        if (r >= i0) {
          const int gp = partner(a, e, jj, r + 1, 0);
          const int jp = e * hn + (gp - e * tile - hn);
          int d;
          while ((d = dec[jp]) < 2 * r) {
          }
          c = d - 2 * r;
        }
        const uint32_t key = walker_key(a, g);
        const float z = stretch(a, key, r + 1, 0);
        float lt[ODE_P];
#pragma unroll
        for (int p = 0; p < ODE_P; ++p) lt[p] = __ldcg(cur + (size_t)p * W + g);
        float chi = __ldcg(cur + (size_t)ODE_P * W + g);
        float rsq = __ldcg(cur + (size_t)(ODE_P + 1) * W + g);
        float acc = __ldcg(cur + (size_t)(ODE_P + 2) * W + g);
        float lp = PRIORS ? __ldcg(cur + (size_t)(ODE_P + 3) * W + g) : 0.0f;
        const float chi_new = __ldcg(cand_at(c, ODE_P, j));
        const float lp_new = PRIORS ? __ldcg(cand_at(c, ODE_P + 2, j)) : 0.0f;
        if (accepts<PRIORS>(a, key, r + 1, 0, z, chi, chi_new, lp, lp_new)) {
#pragma unroll
          for (int p = 0; p < ODE_P; ++p) lt[p] = __ldcg(cand_at(c, p, j));
          chi = chi_new;
          rsq = __ldcg(cand_at(c, ODE_P + 1, j));
          acc = acc + 1.0f;
          lp = lp_new;
        }
        settle<PRIORS>(a, nxt, g, r + 1, lt, chi, rsq, acc, lp);
      }
    }
  }
}

template <int STEPPER, bool PRIORS>
int run(EnsArgs a, int blocks, cudaStream_t s) {
  const size_t smem = plan_smem(a.n_i, a.n_f);
  if (smem == 0) a.n_i = a.n_f = 0;
  const int need = (a.W / 2 + ENS_COLS - 1) / ENS_COLS;
  const int grid = blocks < need ? blocks : need;
  cudaError_t err = cudaMemsetAsync(a.bar, 0, 2 * sizeof(unsigned int), s);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&ens_kernel<STEPPER, PRIORS>), grid,
      ENS_BLOCK, args, smem, s);
}

}  // namespace

extern "C" {

// The most blocks of the ensemble kernel (with priors or without) that can
// be co-resident on the current device with a plan of n_i + n_f words: the
// largest grid a cooperative launch of it accepts.
int odelib_ensemble_blocks(int n_i, int n_f, int stepper, int priors,
                           int* blocks) {
  void (*kernels[3][2])(const EnsArgs) = {
      {&ens_kernel<0, false>, &ens_kernel<0, true>},
      {&ens_kernel<1, false>, &ens_kernel<1, true>},
      {ODE_KV3((&ens_kernel<3, false>)), ODE_KV3((&ens_kernel<3, true>))}};
  const int row = stepper_row(stepper);
  if (row < 0 || !kernels[row][priors != 0]) return (int)cudaErrorInvalidValue;
  void (*kernel)(const EnsArgs) = kernels[row][priors != 0];
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, ENS_BLOCK, plan_smem(n_i, n_f));
  *blocks = sms * per_sm;
  return (int)err;
}

// One device launch for the whole run, of at most `blocks` blocks (the
// count odelib_ensemble_blocks gives, or fewer: threads then loop over
// columns). tile must be a positive multiple of 256 dividing W; W0 <= W
// walkers are recorded; bar is two words of device scratch. prior: P
// table entries, or null for none. The launch runs iterations it_base + 1
// .. it_end - 1 and records iteration it in row it - 1 - rec0 where that
// is >= 0 (a whole run: it_base = 0, it_end = nits, rec0 = burnin; a
// chunk: rec0 = it_base). state ((P + 4) x W) ends holding the walkers'
// state; state_in (the same layout; it may be state itself) replaces the
// scoring of theta0, or is null. work is device scratch of
// (P + 4) W + (2 (P + 3) + 1) W/2 words: the other parity's state, the
// candidates and the posted decisions (ops/cuda_mh.py ensemble_launcher).
int odelib_ensemble(const int* pi, int n_i, const float* pf, int n_f,
                    const float* theta0, const float* walk,
                    const float* prior, const float* state_in, float* state,
                    float* work, unsigned int* bar, float* th_rec, float* chi_rec,
                    float* rsq_rec, float* aic_rec, float* ar_rec, int W,
                    int W0, int tile, int it_base, int it_end, int rec0,
                    unsigned int seed, float am1, float a, float nw1,
                    float aic_const, int stepper, int blocks, void* stream) {
  if (tile <= 0 || tile % 256 != 0 || W % tile != 0 || W0 > W || blocks < 1
      || it_base < 0 || it_end <= it_base)
    return (int)cudaErrorInvalidValue;
  const EnsArgs args{pi, pf, theta0, walk, prior, state_in, state, work,
                     bar,
                     th_rec, chi_rec, rsq_rec, aic_rec, ar_rec, W, W0, tile,
                     it_base, it_end, rec0, n_i, n_f, seed, am1, a, nw1,
                     aic_const};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int (*runs[3][2])(EnsArgs, int, cudaStream_t) = {
      {&run<0, false>, &run<0, true>},
      {&run<1, false>, &run<1, true>},
      {ODE_KV3((&run<3, false>)), ODE_KV3((&run<3, true>))}};
  const int row = stepper_row(stepper);
  if (row < 0 || !runs[row][prior != nullptr])
    return (int)cudaErrorInvalidValue;
  return runs[row][prior != nullptr](args, blocks, s);
}

}  // extern "C"
