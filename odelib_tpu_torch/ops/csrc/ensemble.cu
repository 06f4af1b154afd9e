// Fused Goodman-Weare ensemble (stretch-move) sampler for Hopper (sm_90a).
//
// Replaces, in odelib_tpu/ops/pallas_mh.py:
//   ens_init_kernel + ens_half_kernel <- _cached_ens_grid, whole-run mode
//                                        (public ensemble_fused)
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
// the bytes moved (state, partner reads, records) are small. The main
// path's 12,288 walkers give 6,144 threads per half-update: latency-bound.
//
// What the design does about it. The two halves must synchronise every
// half-iteration, so one thread cannot run a walker's whole loop as in
// mh_kernel. The C entry point loops on the host: one launch scores the
// start points, then 2 (nits - 1) launches, one per half-update, each one
// thread per walker of that half (32-thread blocks, spread over all SMs).
// Stream order is the barrier between halves. Walker state lives in a
// device buffer of (P + 3) x W floats (log-theta, chi, R^2, accept count);
// a launch reads its walkers' state and the partners' log-theta, and
// writes its walkers' state and record rows (final for that iteration).
// Launch overhead (a few microseconds, queued ahead asynchronously) is
// small beside a solve. A cooperative single launch is later work.
//
// Numerics: as mh.cu (-fmad=false, no fast math, host-rounded constants),
// so it rounds like its torch twin ensemble_plain (ops/cuda_mh.py).
#include "common.cuh"

namespace {

using namespace odelib;

template <int STEPPER>
__global__ void ens_init_kernel(const int* __restrict__ pi,
                                const float* __restrict__ pf,
                                const float* __restrict__ theta0,
                                float* __restrict__ state, int W) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= W) return;
  const Plan pl = load_plan(pi, pf);
  float th[ODE_P];
#pragma unroll
  for (int p = 0; p < ODE_P; ++p) th[p] = theta0[(size_t)p * W + g];
  float chi, rsq;
  score<STEPPER>(pl, th, chi, rsq);
#pragma unroll
  for (int p = 0; p < ODE_P; ++p) state[(size_t)p * W + g] = logf(th[p]);
  state[(size_t)ODE_P * W + g] = chi;
  state[(size_t)(ODE_P + 1) * W + g] = rsq;
  state[(size_t)(ODE_P + 2) * W + g] = 0.0f;
}

// One half-update of every ensemble: half hb (0 = A, 1 = B) at iteration it.
template <int STEPPER>
__global__ void __launch_bounds__(32)
ens_half_kernel(const int* __restrict__ pi, const float* __restrict__ pf,
                const float* __restrict__ walk, float* __restrict__ state,
                float* __restrict__ th_rec, float* __restrict__ chi_rec,
                float* __restrict__ rsq_rec, float* __restrict__ aic_rec,
                float* __restrict__ ar_rec, int W, int W0, int tile, int it,
                int hb, int burnin, uint32_t seed, float am1, float a,
                float nw1, float aic_const) {
  const int hn = tile / 2;                 // walkers per half
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= W / 2) return;
  const int e = idx / hn;
  const int j = idx - e * hn;
  const int rp = j / 128, l = j % 128;     // row within the half, lane
  const int half = tile / 256;             // rows per half
  const int lo = hb ? half : 0;
  const int g = e * tile + (lo + rp) * 128 + l;
  // shared partner offset of this ensemble and half-update
  const uint32_t scal_base =
      mix(seed * 0x7FEB352Du + (uint32_t)e * (uint32_t)tile + 0xE75u);
  const uint32_t sbits = mix(scal_base ^ mix((uint32_t)it * 2u + (uint32_t)hb));
  const int r_sub = (int)(sbits % (uint32_t)half);
  const int r_lane = (int)((sbits >> 8) % 128u);
  const int gp = e * tile + ((half - lo) + (rp - r_sub + half) % half) * 128
                 + (l - r_lane + 128) % 128;

  const Plan pl = load_plan(pi, pf);
  const uint32_t key = mix(seed * 0x9E3779B1u + (uint32_t)g);
  const uint32_t ctr = (uint32_t)it * 1024u + 2u * (uint32_t)hb;
  const float u = uniform(key, ctr);
  const float s = 1.0f + am1 * u;
  const float z = (s * s) / a;
  const float omz = 1.0f - z;
  float cur[ODE_P], prop[ODE_P], thp[ODE_P];
#pragma unroll
  for (int p = 0; p < ODE_P; ++p) {
    const float c = state[(size_t)p * W + g];
    cur[p] = c;
    if (walk[ODE_P + p] != 0.0f) {
      const float pt = state[(size_t)p * W + gp];
      prop[p] = c + (omz * (pt - c)) * walk[p];
    } else {
      prop[p] = c;
    }
    thp[p] = expf(prop[p]);
  }
  float chi_new, rsq_new;
  score<STEPPER>(pl, thp, chi_new, rsq_new);
  float chi = state[(size_t)ODE_P * W + g];
  float rsq = state[(size_t)(ODE_P + 1) * W + g];
  float acc = state[(size_t)(ODE_P + 2) * W + g];
  const float log_ratio = (nw1 * logf(z) + chi) - chi_new;
  const float uacc = uniform(key, ctr + 1u);
  // NaN or -inf log ratio compares false: rejected
  if (expf(log_ratio) > uacc) {
#pragma unroll
    for (int p = 0; p < ODE_P; ++p) {
      cur[p] = prop[p];
      state[(size_t)p * W + g] = prop[p];
    }
    chi = chi_new;
    rsq = rsq_new;
    acc = acc + 1.0f;
    state[(size_t)ODE_P * W + g] = chi;
    state[(size_t)(ODE_P + 1) * W + g] = rsq;
    state[(size_t)(ODE_P + 2) * W + g] = acc;
  }
  const int r = it - 1 - burnin;
  if (r >= 0 && g < W0) {
    const size_t row = (size_t)r * W0 + g;
#pragma unroll
    for (int p = 0; p < ODE_P; ++p)
      th_rec[((size_t)r * ODE_P + p) * W0 + g] = expf(cur[p]);
    chi_rec[row] = chi;
    rsq_rec[row] = rsq;
    aic_rec[row] = 2.0f * chi + aic_const;
    ar_rec[row] = acc / (float)it;
  }
}

template <int STEPPER>
int run(const int* pi, const float* pf, const float* theta0,
        const float* walk, float* state, float* th_rec, float* chi_rec,
        float* rsq_rec, float* aic_rec, float* ar_rec, int W, int W0,
        int tile, int nits, int burnin, uint32_t seed, float am1, float a,
        float nw1, float aic_const, cudaStream_t s) {
  ens_init_kernel<STEPPER><<<(W + 127) / 128, 128, 0, s>>>(pi, pf, theta0,
                                                           state, W);
  cudaError_t err = cudaGetLastError();
  const int grid = (W / 2 + 31) / 32;
  for (int it = 1; it < nits && err == cudaSuccess; ++it) {
    for (int hb = 0; hb < 2 && err == cudaSuccess; ++hb) {
      ens_half_kernel<STEPPER><<<grid, 32, 0, s>>>(
          pi, pf, walk, state, th_rec, chi_rec, rsq_rec, aic_rec, ar_rec, W,
          W0, tile, it, hb, burnin, seed, am1, a, nw1, aic_const);
      err = cudaGetLastError();
    }
  }
  return (int)err;
}

}  // namespace

extern "C" {

// Device launches: 1 + 2 (nits - 1). tile must be a positive multiple of
// 256 dividing W; W0 <= W walkers are recorded.
int odelib_ensemble(const int* pi, const float* pf, const float* theta0,
                    const float* walk, float* state, float* th_rec,
                    float* chi_rec, float* rsq_rec, float* aic_rec,
                    float* ar_rec, int W, int W0, int tile, int nits,
                    int burnin, unsigned int seed, float am1, float a,
                    float nw1, float aic_const, int stepper, void* stream) {
  if (tile <= 0 || tile % 256 != 0 || W % tile != 0 || W0 > W)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stepper == 0) {
    return run<0>(pi, pf, theta0, walk, state, th_rec, chi_rec, rsq_rec,
                  aic_rec, ar_rec, W, W0, tile, nits, burnin, seed, am1, a,
                  nw1, aic_const, s);
  }
  return run<1>(pi, pf, theta0, walk, state, th_rec, chi_rec, rsq_rec,
                aic_rec, ar_rec, W, W0, tile, nits, burnin, seed, am1, a,
                nw1, aic_const, s);
}

}  // extern "C"
