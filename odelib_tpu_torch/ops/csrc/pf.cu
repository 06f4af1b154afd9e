// Fused particle-marginal Metropolis-Hastings kernel for Hopper (sm_90a).
//
// Replaces, in odelib_tpu/ops/pallas_pf.py:
//   pf_kernel <- _cached_pf_grid, whole-run mode, Euler-Maruyama (public
//                pmmh_fused)
//
// Semantics (pallas_pf.py:130-469, read for its function). Per chain: the
// log-theta, chi, the accept count and the log proposal scale lsc. Per
// proposal (iteration it >= 1): the walked parameters step by
// rwalk_std exp(lsc) mask_p N(0, 1), the accept uniform is drawn BEFORE the
// filter (:377-383), and a K-particle bootstrap filter estimates the
// likelihood: particles start from y0 (with the '<s>0' overrides) and run
// the plan's steps, y <- (y + h f) + (sqrt_h g) xi (:281-288); after each
// observed grid point the block is weighed (:214-257): per-particle chi of
// the lognormal terms, a dead particle (NaN or chi >= 1e30) at weight 0,
// m = max log w, w = exp(log w - m) where that exceeds -60,
// loglik = ((loglik + m) + log sum w) - log K, and, except at the last
// observed grid point, systematic resampling: cum is the inclusive
// Hillis-Steele prefix sum of w (d = 1, 2, 4, ...), pos_i =
// ((i + u) (1/K)) cum[K-1], and slot i copies particle j iff
// cum[j-1] <= pos_i < cum[j] (cum[-1] = 0). chi_new = -loglik, so all
// particles dead gives +inf and a rejection. Accept when
// exp(chi - chi_new [+ lp(theta') - lp(theta)]) > u; during burn-in
// (it <= burnin) lsc += adapt_rate (accept - target) (:393-396).
//
// Parity with the JAX kernel, each trap named where the code meets it:
//   - lane keys (:343-344): particle k of chain c keys on
//     mix(seed 0x9E3779B1 + (c / 128) K 128 + k 128 + c % 128); per-chain
//     draws (proposal normals, accept and resample uniforms) use particle
//     0's key, row [0:1] of the JAX plane;
//   - counters (:122-126, :153-158): it * stride + slot, stride the next
//     power of two of _count_slots; the initial filter runs at it = 0 with
//     its own slots from 0 (rng0, :343, :359);
//   - slot order in an iteration: the proposal normals (2 slots each,
//     walked parameters in order), the accept uniform, then the filter's
//     draws in trace order;
//   - noise pairs (:80-90, :268-276): both Box-Muller halves, cos then sin,
//     handed out through a stash that lives for one filter, so with an odd
//     state count a pair straddles two steps (its two slots stay adjacent);
//   - sum w: 32-particle groups summed in particle order, then the group
//     sums in order: XLA:CPU's order for jnp.sum over the particles when
//     K <= 32 or K % 32 == 0, so the CPU twin meets the JAX kernel bitwise
//     there; the twin (ops/cuda_pf.py) shares this order with the kernel;
//   - selection edge (:238-257): pos_i >= total matches no particle and
//     the slot becomes all-zero states, as the JAX kernel's masked sum
//     gives; the index is never clamped.
//
// What bounds it on the card: operations. A filter is K particles x (steps
// x (drift, diffusion, one Box-Muller half: log, sqrt, sin and cos per pair
// and two SplitMix words per uniform)) plus, per observation block, the
// block's reductions and log2(K) scan levels, each behind a block barrier.
// The transcendental functions of Box-Muller and of the weights and the
// barriers of the scan are the cost; the bytes are the records only.
//
// What the design does about it: one block of K threads per chain, one
// thread per particle, particle state in registers for the whole run.
// Per-chain scalars (proposal, accept, loglik, lsc) are computed
// redundantly and identically by every thread of the block from the same
// counter-RNG words and the same shared-memory reductions, so they need no
// broadcast. Max and sum of the weights are warp shuffles plus a shared
// array of per-warp results; the prefix sum is the Hillis-Steele ladder in
// shared memory (one barrier per level); selection is a binary search of
// cum when cum is non-decreasing (checked with one block vote) and
// otherwise the JAX kernel's masked sum over all particles, then a gather
// from a shared-memory copy of the particle states. 10,240 chains are
// 10,240 blocks of 128 threads, several waves over the 132 SMs.
//
// Numerics: as mh.cu (-fmad=false, no fast math, constants rounded to
// float32 on the host), so it rounds like its torch twin pmmh_plain.
#include "common.cuh"

#ifndef PF_KMAX  // -DPF_KMAX from ops/build.py, the one place it is set
#error "PF_KMAX (particles per chain) must be defined by the build"
#endif
#define PF_WARPS ((PF_KMAX + 31) / 32)

#ifdef ODE_HAS_DIFFUSION

namespace {

using namespace odelib;

// Both Box-Muller halves from slots ctr and ctr + 1 (_RngS.normal_pair).
__device__ __forceinline__ void normal_pair(uint32_t key, uint32_t ctr,
                                            float& a, float& b) {
  const float u1 = uniform(key, ctr);
  const float u2 = uniform(key, ctr + 1u);
  const float r = sqrtf(-2.0f * logf(u1));
  const float ang = ODELIB_TWO_PI * u2;
  a = r * cosf(ang);
  b = r * sinf(ang);
}

struct Filter {
  int K, k, lane, warp, nwarps, nlane;
  unsigned mask;
  int last_gi;
  float log_k, inv_k;
  uint32_t key0, keyk;
  float* cum0;   // K: the weights, then a scan level
  float* cum1;   // K: the other scan level
  float* ys;     // ODE_S x K: the particles before resampling
  float* wmax;   // per-warp max of log w
  float* wsum;   // per-warp sum of w
};

// Weigh (and, but at the last observed grid point, resample) the block at
// grid point gi: every thread of the block calls it.
__device__ void resample_block(const Plan& pl, const Filter& F, int gi,
                               float* y, float& loglik, uint32_t ctr,
                               uint32_t& slot) {
  float chi_b = 0.0f, ssres = 0.0f;
  contrib<ODE_S>(pl, gi, y, chi_b, ssres);
  const bool finite = chi_b == chi_b && chi_b < 1e30f;
  const float logw = finite ? -chi_b : -INFINITY;
  float m = -INFINITY;
  for (int l = 0; l < F.nlane; ++l)
    m = fmaxf(m, __shfl_sync(F.mask, logw, l));
  if (F.lane == 0) F.wmax[F.warp] = m;
  __syncthreads();
  m = F.wmax[0];
  for (int g = 1; g < F.nwarps; ++g) m = fmaxf(m, F.wmax[g]);
  const float lw = logw - m;              // NaN when every particle died
  const float w = lw > -60.0f ? expf(lw) : 0.0f;
  float gs = 0.0f;
  for (int l = 0; l < F.nlane; ++l) gs = gs + __shfl_sync(F.mask, w, l);
  if (F.lane == 0) F.wsum[F.warp] = gs;
  F.cum0[F.k] = w;
#pragma unroll
  for (int s = 0; s < ODE_S; ++s) F.ys[s * F.K + F.k] = y[s];
  __syncthreads();
  float sumw = 0.0f;
  for (int g = 0; g < F.nwarps; ++g) sumw = sumw + F.wsum[g];
  loglik = ((loglik + m) + logf(sumw)) - F.log_k;
  if (gi == F.last_gi) return;   // nothing downstream needs the cloud
  // inclusive prefix sum: the Hillis-Steele ladder, one level per barrier
  float* src = F.cum0;
  float* dst = F.cum1;
  float c = w;
  for (int d = 1; d < F.K; d <<= 1) {
    c = c + (F.k >= d ? src[F.k - d] : 0.0f);
    dst[F.k] = c;
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }
  const float u = uniform(F.key0, ctr + slot);
  slot += 1;
  const float total = src[F.K - 1];
  const float pos = (((float)F.k + u) * F.inv_k) * total;
  const bool rising = F.k == 0 || src[F.k] >= src[F.k - 1];
  float yn[ODE_S];
  if (__syncthreads_and(rising)) {
    // the selection intervals tile [0, total): the first j with
    // cum[j] > pos is the only match, none when pos >= total
    int lo = 0, hi = F.K;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (src[mid] > pos) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
#pragma unroll
    for (int s = 0; s < ODE_S; ++s)
      yn[s] = lo < F.K ? 0.0f + F.ys[s * F.K + lo] : 0.0f;
  } else {
    // rounding made cum dip: the masked sum over every particle
#pragma unroll
    for (int s = 0; s < ODE_S; ++s) yn[s] = 0.0f;
    for (int j = 0; j < F.K; ++j) {
      const float edge = j ? src[j - 1] : 0.0f;
      const bool sel = pos >= edge && pos < src[j];
#pragma unroll
      for (int s = 0; s < ODE_S; ++s)
        yn[s] = yn[s] + (sel ? F.ys[s * F.K + j] : 0.0f);
    }
  }
#pragma unroll
  for (int s = 0; s < ODE_S; ++s) y[s] = yn[s];
}

// -loglik of one bootstrap filter at theta (every thread of the block).
__device__ float particle_filter(const Plan& pl, const Filter& F,
                                 const float* theta, uint32_t ctr,
                                 uint32_t& slot) {
  float y[ODE_S];
#pragma unroll
  for (int s = 0; s < ODE_S; ++s) {
    const int ip = pl.init_pidx[s];
    y[s] = ip >= 0 ? pick<ODE_P>(theta, ip) : pl.y0[s];
  }
  float loglik = 0.0f;
  bool stashed = false;
  float stash = 0.0f;
  if (pl.obs_ptr[1] > pl.obs_ptr[0])
    resample_block(pl, F, 0, y, loglik, ctr, slot);
  for (int n = 0; n < pl.n_steps; ++n) {
    const float* sf = pl.steps + 8 * n;   // h, t, f32(sqrt h)
    float f[ODE_S], g[ODE_S], xi[ODE_S];
    rhs(sf[1], y, theta, f);
    diffusion(sf[1], y, theta, g);
#pragma unroll
    for (int s = 0; s < ODE_S; ++s) {
      if (stashed) {
        xi[s] = stash;
        stashed = false;
      } else {
        normal_pair(F.keyk, ctr + slot, xi[s], stash);
        slot += 2;
        stashed = true;
      }
    }
#pragma unroll
    for (int s = 0; s < ODE_S; ++s)
      y[s] = (y[s] + sf[0] * f[s]) + (sf[2] * g[s]) * xi[s];
    const int gi = pl.step_gi[n];
    if (gi >= 0 && pl.obs_ptr[gi + 1] > pl.obs_ptr[gi])
      resample_block(pl, F, gi, y, loglik, ctr, slot);
  }
  return -loglik;
}

// walk: P mask values, then P walked flags; prior: P table entries of
// PRIOR_WIDTH floats (common.cuh log_prior).
__global__ void pf_kernel(const int* __restrict__ pi,
                          const float* __restrict__ pf,
                          const float* __restrict__ theta0,
                          const float* __restrict__ walk,
                          const float* __restrict__ prior,
                          float* __restrict__ th_rec,
                          float* __restrict__ chi_rec,
                          float* __restrict__ ar_rec, int C, int nits,
                          int burnin, uint32_t seed, uint32_t stride,
                          int last_gi, int use_priors, int use_adapt,
                          float rwalk_std, float adapt_rate, float target,
                          float log_k, float inv_k) {
  extern __shared__ float smem[];
  const int c = blockIdx.x;
  Filter F;
  F.K = blockDim.x;
  F.k = threadIdx.x;
  F.lane = F.k & 31;
  F.warp = F.k >> 5;
  F.nwarps = (F.K + 31) >> 5;
  F.nlane = min(32, F.K - 32 * F.warp);
  F.mask = F.nlane == 32 ? 0xFFFFFFFFu : (1u << F.nlane) - 1u;
  F.last_gi = last_gi;
  F.log_k = log_k;
  F.inv_k = inv_k;
  // the JAX plane's lane ids: the tile is 128 chains x K particles
  const uint32_t base = seed * 0x9E3779B1u +
                        (uint32_t)(c >> 7) * (uint32_t)(F.K * 128) +
                        (uint32_t)(c & 127);
  F.key0 = mix(base);
  F.keyk = mix(base + (uint32_t)F.k * 128u);
  F.cum0 = smem;
  F.cum1 = smem + F.K;
  F.ys = smem + 2 * F.K;
  F.wmax = F.ys + ODE_S * F.K;
  F.wsum = F.wmax + PF_WARPS;
  const Plan pl = load_plan(pi, pf);

  float lt[ODE_P], prop[ODE_P], thp[ODE_P];
#pragma unroll
  for (int p = 0; p < ODE_P; ++p) thp[p] = theta0[(size_t)p * C + c];
  uint32_t slot = 0;
  float chi = particle_filter(pl, F, thp, 0u, slot);
#pragma unroll
  for (int p = 0; p < ODE_P; ++p) lt[p] = logf(thp[p]);
  float acc = 0.0f, lsc = 0.0f;
  for (int it = 1; it < nits; ++it) {
    const uint32_t ctr = (uint32_t)it * stride;
    slot = 0;
    const float std = rwalk_std * expf(lsc);
#pragma unroll
    for (int p = 0; p < ODE_P; ++p) {
      if (walk[ODE_P + p] != 0.0f) {
        prop[p] = lt[p] + (std * walk[p]) * normal(F.key0, ctr + slot);
        slot += 2;
      } else {
        prop[p] = lt[p];
      }
      thp[p] = expf(prop[p]);
    }
    const float u = uniform(F.key0, ctr + slot);
    slot += 1;
    const float chi_new = particle_filter(pl, F, thp, ctr, slot);
    float log_ratio = chi - chi_new;
    if (use_priors) {
      float lp_new = 0.0f, lp_old = 0.0f;
#pragma unroll
      for (int p = 0; p < ODE_P; ++p) {
        const float* e = prior + PRIOR_WIDTH * p;
        if ((int)e[0] != PRIOR_NONE) {
          lp_new = lp_new + log_prior(e, thp[p]);
          lp_old = lp_old + log_prior(e, expf(lt[p]));
        }
      }
      log_ratio = log_ratio + (lp_new - lp_old);
    }
    // NaN or -inf log ratio compares false: rejected
    const bool accept = expf(log_ratio) > u;
    if (accept) {
#pragma unroll
      for (int p = 0; p < ODE_P; ++p) lt[p] = prop[p];
      chi = chi_new;
    }
    const float a = accept ? 1.0f : 0.0f;
    acc = acc + a;
    if (use_adapt && it <= burnin) lsc = lsc + adapt_rate * (a - target);
    const int r = it - 1 - burnin;
    if (r >= 0 && F.k == 0) {
#pragma unroll
      for (int p = 0; p < ODE_P; ++p)
        th_rec[((size_t)r * ODE_P + p) * C + c] = expf(lt[p]);
      chi_rec[(size_t)r * C + c] = chi;
      ar_rec[(size_t)r * C + c] = acc / (float)it;
    }
  }
}

}  // namespace

#endif  // ODE_HAS_DIFFUSION

extern "C" {

int odelib_pf(const int* pi, const float* pf, const float* theta0,
              const float* walk, const float* prior, float* th_rec,
              float* chi_rec, float* ar_rec, int C, int K, int nits,
              int burnin, unsigned int seed, unsigned int stride,
              int last_gi, int use_priors, int use_adapt, float rwalk_std,
              float adapt_rate, float target, float log_k, float inv_k,
              void* stream) {
#ifdef ODE_HAS_DIFFUSION
  if (K < 1 || K > PF_KMAX) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((2 + ODE_S) * (size_t)K + 2 * PF_WARPS);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pf_kernel<<<C, K, smem, s>>>(pi, pf, theta0, walk, prior, th_rec, chi_rec,
                               ar_rec, C, nits, burnin, seed, stride, last_gi,
                               use_priors, use_adapt, rwalk_std, adapt_rate,
                               target, log_k, inv_k);
  return (int)cudaGetLastError();
#else
  // this model has no diffusion: the library was built for an ODE
  return (int)cudaErrorNotSupported;
#endif
}

}  // extern "C"
