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
// sequential by the algorithm, so a run is 2 (nits - 1) solve latencies
// end to end whatever the width: the main path's 12,288 walkers give 6,144
// solves per half-update, 1.45 warps per SM. Latency-bound.
//
// What the design does about it: one persistent cooperative launch runs
// the whole run (the first port made one launch per half-update, 1,999 a
// run, each reading the plan cold from L2 and waiting for its slowest warp).
//   - A thread owns column j of an ensemble's half: walker j of half A and
//     walker j of half B (32-thread blocks, spread over every SM). Where the
//     grid holds fewer threads than columns (it is at most what can be
//     co-resident), each thread loops over columns j, j + T, ...
//   - The plan tables are staged into each block's shared memory once
//     (where they fit in 48 KB), so the solve's table reads never leave
//     the SM.
//   - Walker state lives in a device buffer of (P + 3) x W floats
//     (log-theta, chi, R^2, accept count). Log-theta is what partners read:
//     after each half-update a grid barrier (an arrival counter and a
//     generation word) makes the half's new positions visible, and all
//     buffer traffic bypasses L1 (__ldcg/__stcg), which is not coherent
//     across SMs. A thread's own state loads issue beside its partner's,
//     which must come from L2 anyway, so keeping it in the buffer adds no
//     latency and lets any number of columns a thread run the same code.
//   - Every thread reaches every barrier, columns or not. The launch is
//     cooperative, so it fails (cudaErrorCooperativeLaunchTooLarge) rather
//     than deadlock where the grid cannot be co-resident.
//
// With priors (the PRIORS instantiations) the buffer's last row holds each
// walker's log prior, and the ratio adds lp_new - lp
// (pallas_mh.py:1598,1631-1648); without them it is never written.
//
// Chunk mode (pallas_mh.py:1523-1527, :1583-1589, :1684-1688): the buffer
// is the JAX kernel's chunk state, (P + 4) x W. A launch covers the
// proposals it_base + 1 .. it_end - 1; with state_in it copies that state
// into the buffer instead of scoring the start points, and the buffer holds
// the state after it_end - 1 when the launch ends. Both streams (the
// walkers' draws and the partner offsets) are keyed on the global
// iteration, so a run cut into launches gives the records of one launch,
// bitwise. Still one cooperative launch per chunk.
//
// Numerics: as mh.cu (-fmad=false, no fast math, host-rounded constants),
// so it rounds like its torch twin ensemble_plain (ops/cuda_mh.py).
#include "common.cuh"

#define ENS_BLOCK 32

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
                         // log prior (PRIORS only)
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
  const int half = tile / 256;           // rows per half
  const int cols = W / 2;
  const int T = gridDim.x * blockDim.x;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  float* lt = a.state;                   // P x W
  float* chi_s = a.state + (size_t)ODE_P * W;
  float* rsq_s = chi_s + W;
  float* acc_s = rsq_s + W;
  float* lp_s = acc_s + W;               // PRIORS only
  float scale[ODE_P];
  bool walked[ODE_P];
#pragma unroll
  for (int p = 0; p < ODE_P; ++p) {
    scale[p] = a.walk[p];
    walked[p] = a.walk[ODE_P + p] != 0.0f;
  }

  // the start points (or the state the launch resumes), both walkers of
  // each column
  for (int j = t; j < cols; j += T) {
    const int e = j / hn;
    for (int hb = 0; hb < 2; ++hb) {
      const int g = e * tile + hb * hn + (j - e * hn);
      if (a.state_in) {
        for (int q = 0; q < ODE_P + 4; ++q)
          __stcg(a.state + (size_t)q * W + g,
                 __ldcg(a.state_in + (size_t)q * W + g));
        continue;
      }
      float th[ODE_P];
#pragma unroll
      for (int p = 0; p < ODE_P; ++p) th[p] = a.theta0[(size_t)p * W + g];
      float chi, rsq;
      score<STEPPER>(pl, th, chi, rsq);
#pragma unroll
      for (int p = 0; p < ODE_P; ++p) __stcg(lt + (size_t)p * W + g, logf(th[p]));
      __stcg(chi_s + g, chi);
      __stcg(rsq_s + g, rsq);
      __stcg(acc_s + g, 0.0f);
      if constexpr (PRIORS)
        __stcg(lp_s + g, log_prior_sum<ODE_P>(a.prior, th));
    }
  }

  for (int it = a.it_base + 1; it < a.it_end; ++it) {
    for (int hb = 0; hb < 2; ++hb) {
      grid_barrier(a.bar);   // the other half's positions are final
      for (int j = t; j < cols; j += T) {
        const int e = j / hn;
        const int jj = j - e * hn;
        const int rp = jj / 128, l = jj % 128;   // row within the half, lane
        const int lo = hb ? half : 0;
        const int g = e * tile + hb * hn + jj;
        // shared partner offset of this ensemble and half-update
        const uint32_t scal_base =
            mix(a.seed * 0x7FEB352Du + (uint32_t)e * (uint32_t)tile + 0xE75u);
        const uint32_t sbits =
            mix(scal_base ^ mix((uint32_t)it * 2u + (uint32_t)hb));
        const int r_sub = (int)(sbits % (uint32_t)half);
        const int r_lane = (int)((sbits >> 8) % 128u);
        const int gp = e * tile
                       + ((half - lo) + (rp - r_sub + half) % half) * 128
                       + (l - r_lane + 128) % 128;

        const uint32_t key = mix(a.seed * 0x9E3779B1u + (uint32_t)g);
        const uint32_t ctr = (uint32_t)it * 1024u + 2u * (uint32_t)hb;
        const float u = uniform(key, ctr);
        const float s = 1.0f + a.am1 * u;
        const float z = (s * s) / a.a;
        const float omz = 1.0f - z;
        float cur[ODE_P], prop[ODE_P], thp[ODE_P];
#pragma unroll
        for (int p = 0; p < ODE_P; ++p) {
          const float c = __ldcg(lt + (size_t)p * W + g);
          cur[p] = c;
          if (walked[p]) {
            const float pt = __ldcg(lt + (size_t)p * W + gp);
            prop[p] = c + (omz * (pt - c)) * scale[p];
          } else {
            prop[p] = c;
          }
          thp[p] = expf(prop[p]);
        }
        float chi = __ldcg(chi_s + g);
        float rsq = __ldcg(rsq_s + g);
        float acc = __ldcg(acc_s + g);
        // the state's log prior is read before the solve, which hides its
        // L2 latency (read after it, the latency adds to each half-update)
        const float lp = PRIORS ? __ldcg(lp_s + g) : 0.0f;
        float chi_new, rsq_new;
        score<STEPPER>(pl, thp, chi_new, rsq_new);
        float log_ratio = (a.nw1 * logf(z) + chi) - chi_new;
        float lp_new = 0.0f;
        if constexpr (PRIORS) {
          lp_new = log_prior_sum<ODE_P>(a.prior, thp);
          log_ratio = log_ratio + (lp_new - lp);
        }
        const float uacc = uniform(key, ctr + 1u);
        // NaN or -inf log ratio compares false: rejected
        if (expf(log_ratio) > uacc) {
#pragma unroll
          for (int p = 0; p < ODE_P; ++p) {
            cur[p] = prop[p];
            __stcg(lt + (size_t)p * W + g, prop[p]);
          }
          chi = chi_new;
          rsq = rsq_new;
          acc = acc + 1.0f;
          __stcg(chi_s + g, chi);
          __stcg(rsq_s + g, rsq);
          __stcg(acc_s + g, acc);
          if constexpr (PRIORS) __stcg(lp_s + g, lp_new);
        }
        // this walker's state is final for the iteration: record it
        const int r = it - 1 - a.rec0;
        if (r >= 0 && g < a.W0) {
          const size_t row = (size_t)r * a.W0 + g;
#pragma unroll
          for (int p = 0; p < ODE_P; ++p)
            a.th_rec[((size_t)r * ODE_P + p) * a.W0 + g] = expf(cur[p]);
          a.chi_rec[row] = chi;
          a.rsq_rec[row] = rsq;
          a.aic_rec[row] = 2.0f * chi + a.aic_const;
          a.ar_rec[row] = acc / (float)it;
        }
      }
    }
  }
}

template <int STEPPER, bool PRIORS>
int run(EnsArgs a, int blocks, cudaStream_t s) {
  const size_t smem = plan_smem(a.n_i, a.n_f);
  if (smem == 0) a.n_i = a.n_f = 0;
  const int need = (a.W / 2 + ENS_BLOCK - 1) / ENS_BLOCK;
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
// scoring of theta0, or is null.
int odelib_ensemble(const int* pi, int n_i, const float* pf, int n_f,
                    const float* theta0, const float* walk,
                    const float* prior, const float* state_in, float* state,
                    unsigned int* bar, float* th_rec, float* chi_rec,
                    float* rsq_rec, float* aic_rec, float* ar_rec, int W,
                    int W0, int tile, int it_base, int it_end, int rec0,
                    unsigned int seed, float am1, float a, float nw1,
                    float aic_const, int stepper, int blocks, void* stream) {
  if (tile <= 0 || tile % 256 != 0 || W % tile != 0 || W0 > W || blocks < 1
      || it_base < 0 || it_end <= it_base)
    return (int)cudaErrorInvalidValue;
  const EnsArgs args{pi, pf, theta0, walk, prior, state_in, state, bar,
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
