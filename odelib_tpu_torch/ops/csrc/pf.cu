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
// observed grid point the particles are weighed (:214-257): per-particle chi
// of the lognormal terms, a dead particle (NaN or chi >= 1e30) at weight 0,
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
//     there; the twin (ops/cuda_pf.py group_sum) shares this order;
//   - selection edge (:238-257): pos_i >= total matches no particle and
//     the slot becomes all-zero states, as the JAX kernel's masked sum
//     gives; the index is never clamped.
//
// What bounds it on the card: instructions. A filter is K particles x
// (steps x (drift, diffusion, one Box-Muller half: log, sqrt, sin and cos
// per pair and a SplitMix word per uniform)) plus, per observation block,
// the weights' reductions and log2(K) scan levels. The libm sequences and
// the hashing are most of the instructions; the bytes are the records only.
//
// What the design does about it: one warp per chain, PPT particles per
// lane in registers (particle k on lane k / PPT, slot k % PPT), PPT the
// least power of two with 32 PPT >= K: one particle on each of K lanes for
// K <= 32 (the other lanes idle), 4 at the main path's K = 128, and 8 or 16
// for 128 < K <= 512: one warp still, a lane holding its particles' states,
// keys, noise stash and scan values in registers (ptxas for one state: 56
// registers and 8 bytes of spill at 4 a lane, 80 and 12 at 8, 128 and 56 at
// 16) and the warp (1 + S) 32 PPT floats of shared memory (16 KB a block at
// 16). Four chains (warps) per block share nothing but the block, so
// nothing waits at a block barrier.
//   - Work that is the same for every particle of a chain is done once per
//     lane, not once per particle: mix(ctr) of each noise slot (only the key
//     differs between particles: uniform_mixed), the plan's per-step loads,
//     the stash bookkeeping, and the per-chain scalars (proposal, accept and
//     resample uniforms, priors, adaptation), which every lane computes from
//     the same words, so nothing is broadcast.
//   - Both Box-Muller halves from one sincosf; on the card it gives the
//     bits of sinf and cosf, which the twin's torch.sin and torch.cos
//     compute (held bitwise by chip_smoke.py's comparison). It saves ~2
//     instructions a pair: the compiler already shared the two calls'
//     range reduction.
//   - Reductions in registers and shuffles, in today's association exactly:
//     max of log w in any order (fmaxf is exact); the sum of w in XLA:CPU's
//     order, lane g adding group g's 32 weights in particle order (one
//     shuffle each, all groups at once), then every lane the group sums in
//     order; the Hillis-Steele ladder lane-blocked: a level d < PPT adds
//     in-lane values and, for the lane's first d slots, the previous lane's
//     last ones (a shuffle up by 1), a level d >= PPT adds the same slot of
//     the lane d / PPT below (a shuffle up by d / PPT), each level reading
//     only the previous level's values (tests/test_torch_pf.py emulates
//     both, lane by lane, against group_sum and systematic_resample's cum).
//   - Selection as before: a binary search of cum when it never falls (one
//     warp vote) and the JAX kernel's masked sum when rounding made it dip,
//     then a gather, both from a per-warp shared-memory copy of cum and of
//     the particle states ((1 + S) 32 PPT floats a warp) after a __syncwarp.
//
// Numerics: as mh.cu (-fmad=false, no fast math, constants rounded to
// float32 on the host), so it rounds like its torch twin pmmh_plain.
#include "common.cuh"

#ifndef PF_KMAX  // -DPF_KMAX from ops/build.py, the one place it is set
#error "PF_KMAX (particles per chain) must be defined by the build"
#endif
static_assert(PF_KMAX <= 512, "a warp holds at most 16 particles a lane");

#define PF_WARPS 4              // chains (warps) per block
#define FULL_MASK 0xFFFFFFFFu

#ifdef ODE_HAS_DIFFUSION

namespace {

using namespace odelib;

struct PfArgs {
  const int* pi;
  const float* pf;
  const float* theta0;
  const float* walk;    // P mask values, then P walked flags
  const float* prior;   // P table entries of PRIOR_WIDTH (common.cuh)
  float* th_rec;
  float* chi_rec;
  float* ar_rec;
  int C, K, nits, burnin;
  uint32_t seed, stride;
  int last_gi, use_priors, use_adapt;
  float rwalk_std, adapt_rate, target, log_k, inv_k;
};

__host__ __device__ constexpr int ilog2(int n) {
  return n <= 1 ? 0 : 1 + ilog2(n / 2);
}

// One chain's filter on one lane: particles lane PPT + i, i < PPT.
template <int PPT>
struct Lane {
  int K, lane, last_gi;
  float log_k, inv_k;
  uint32_t key0;         // particle 0's: the per-chain draws
  uint32_t key[PPT];
  float* cum;            // 32 PPT: the prefix sum (this warp's)
  float* ys;             // S x 32 PPT: the particles before resampling
};

// Both Box-Muller halves (cos, sin) from the mixed counter words of slots
// ctr and ctr + 1 (_RngS.normal_pair).
__device__ __forceinline__ void normal_pair(uint32_t key, uint32_t m1,
                                            uint32_t m2, float& a, float& b) {
  const float u1 = uniform_mixed(key, m1);
  const float u2 = uniform_mixed(key, m2);
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincosf(ODELIB_TWO_PI * u2, &s, &c);
  a = r * c;
  b = r * s;
}

// Weigh (and, but at the last observed grid point, resample) the chain's
// particles at grid point gi: every lane of the warp calls it.
template <int PPT>
__device__ __forceinline__ void resample_block(const Plan& pl,
                                               const Lane<PPT>& F, int gi,
                                               float (&y)[PPT][ODE_S],
                                               float& loglik, uint32_t ctr,
                                               uint32_t& slot) {
  constexpr int KP = 32 * PPT;
  constexpr int LPG = 32 / PPT;     // lanes of a 32-particle group
  const int k0 = F.lane * PPT;      // this lane's first particle
  float w[PPT];                     // log w, then w
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    float chi_b = 0.0f, ssres = 0.0f;
    contrib<ODE_S>(pl, gi, y[i], chi_b, ssres);
    const bool finite = chi_b == chi_b && chi_b < 1e30f;
    w[i] = finite && k0 + i < F.K ? -chi_b : -INFINITY;
    m = fmaxf(m, w[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, o));
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const float lw = w[i] - m;      // NaN when every particle died
    w[i] = lw > -60.0f ? expf(lw) : 0.0f;
  }
  // lane g sums group g (particles 32 g + j) in particle order
  const int G = (F.K + 31) >> 5;
  const int g = F.lane < G ? F.lane : 0;
  float part = 0.0f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float v = __shfl_sync(FULL_MASK, w[j % PPT], g * LPG + j / PPT);
    if (32 * g + j < F.K) part = part + v;
  }
  float sumw = 0.0f;
  for (int q = 0; q < G; ++q) sumw = sumw + __shfl_sync(FULL_MASK, part, q);
  loglik = ((loglik + m) + logf(sumw)) - F.log_k;
  if (gi == F.last_gi) return;   // nothing downstream needs the cloud
  // inclusive prefix sum: the Hillis-Steele ladder, lane-blocked
  float c[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) c[i] = w[i];
#pragma unroll
  for (int l = 0; l < ilog2(PPT); ++l) {   // levels d < PPT
    const int d = 1 << l;
    float n[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      // (indices masked into range: the branch not taken is compiled too)
      if (i >= d) {
        n[i] = c[i] + c[(i - d) & (PPT - 1)];
      } else {
        const float v =
            __shfl_up_sync(FULL_MASK, c[(i - d + PPT) & (PPT - 1)], 1);
        n[i] = c[i] + (F.lane > 0 ? v : 0.0f);
      }
    }
#pragma unroll
    for (int i = 0; i < PPT; ++i) c[i] = n[i];
  }
  for (int d = PPT; d < F.K; d <<= 1) {      // levels d >= PPT
    const int q = d / PPT;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const float v = __shfl_up_sync(FULL_MASK, c[i], q);
      c[i] = c[i] + (F.lane >= q ? v : 0.0f);
    }
  }
  const float before = __shfl_up_sync(FULL_MASK, c[PPT - 1], 1);
  bool rising = true;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int k = k0 + i;
    const float left = i ? c[(i - 1) & (PPT - 1)] : before;
    if (k >= 1 && k < F.K) rising = rising && c[i] >= left;
  }
  __syncwarp();                  // the last block's gather has read them
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    F.cum[k0 + i] = c[i];
#pragma unroll
    for (int s = 0; s < ODE_S; ++s) F.ys[s * KP + k0 + i] = y[i][s];
  }
  __syncwarp();
  const float u = uniform(F.key0, ctr + slot);
  slot += 1;
  const float total = F.cum[F.K - 1];
  if (__all_sync(FULL_MASK, rising)) {
    // the selection intervals tile [0, total): the first j with
    // cum[j] > pos is the only match, none when pos >= total
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const float pos = (((float)(k0 + i) + u) * F.inv_k) * total;
      int lo = 0, hi = F.K;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (F.cum[mid] > pos) {
          hi = mid;
        } else {
          lo = mid + 1;
        }
      }
#pragma unroll
      for (int s = 0; s < ODE_S; ++s)
        y[i][s] = lo < F.K ? 0.0f + F.ys[s * KP + lo] : 0.0f;
    }
  } else {
    // rounding made cum dip: the masked sum over every particle
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const float pos = (((float)(k0 + i) + u) * F.inv_k) * total;
      float yn[ODE_S];
#pragma unroll
      for (int s = 0; s < ODE_S; ++s) yn[s] = 0.0f;
      for (int j = 0; j < F.K; ++j) {
        const float edge = j ? F.cum[j - 1] : 0.0f;
        const bool sel = pos >= edge && pos < F.cum[j];
#pragma unroll
        for (int s = 0; s < ODE_S; ++s)
          yn[s] = yn[s] + (sel ? F.ys[s * KP + j] : 0.0f);
      }
#pragma unroll
      for (int s = 0; s < ODE_S; ++s) y[i][s] = yn[s];
    }
  }
}

// -loglik of one bootstrap filter at theta (every lane of the warp).
template <int PPT>
__device__ __forceinline__ float particle_filter(const Plan& pl,
                                                 const Lane<PPT>& F,
                                                 const float* theta,
                                                 uint32_t ctr,
                                                 uint32_t& slot) {
  float y[PPT][ODE_S];
#pragma unroll
  for (int s = 0; s < ODE_S; ++s) {
    const int ip = pl.init_pidx[s];
    const float v = ip >= 0 ? pick<ODE_P>(theta, ip) : pl.y0[s];
#pragma unroll
    for (int i = 0; i < PPT; ++i) y[i][s] = v;
  }
  float loglik = 0.0f;
  bool stashed = false;
  float stash[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) stash[i] = 0.0f;
  if (pl.obs_ptr[1] > pl.obs_ptr[0])
    resample_block<PPT>(pl, F, 0, y, loglik, ctr, slot);
  for (int n = 0; n < pl.n_steps; ++n) {
    const float* sf = pl.steps + 8 * n;   // h, t, f32(sqrt h)
    const float h = sf[0], t = sf[1], sq = sf[2];
    float xi[PPT][ODE_S];
#pragma unroll
    for (int s = 0; s < ODE_S; ++s) {
      if (stashed) {
#pragma unroll
        for (int i = 0; i < PPT; ++i) xi[i][s] = stash[i];
        stashed = false;
      } else {
        const uint32_t m1 = mix(ctr + slot);
        const uint32_t m2 = mix(ctr + slot + 1u);
#pragma unroll
        for (int i = 0; i < PPT; ++i)
          normal_pair(F.key[i], m1, m2, xi[i][s], stash[i]);
        slot += 2;
        stashed = true;
      }
    }
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      float f[ODE_S], g[ODE_S];
      rhs(t, y[i], theta, f);
      diffusion(t, y[i], theta, g);
#pragma unroll
      for (int s = 0; s < ODE_S; ++s)
        y[i][s] = (y[i][s] + h * f[s]) + (sq * g[s]) * xi[i][s];
    }
    const int gi = pl.step_gi[n];
    if (gi >= 0 && pl.obs_ptr[gi + 1] > pl.obs_ptr[gi])
      resample_block<PPT>(pl, F, gi, y, loglik, ctr, slot);
  }
  return -loglik;
}

template <int PPT>
__global__ void __launch_bounds__(32 * PF_WARPS) pf_kernel(const PfArgs a) {
  extern __shared__ float smem[];
  constexpr int KP = 32 * PPT;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * (blockDim.x >> 5) + warp;
  if (c >= a.C) return;          // the whole warp: no barrier spans warps
  const int C = a.C;
  Lane<PPT> F;
  F.K = a.K;
  F.lane = threadIdx.x & 31;
  F.last_gi = a.last_gi;
  F.log_k = a.log_k;
  F.inv_k = a.inv_k;
  // the JAX plane's lane ids: the tile is 128 chains x K particles
  const uint32_t base = a.seed * 0x9E3779B1u +
                        (uint32_t)(c >> 7) * (uint32_t)(a.K * 128) +
                        (uint32_t)(c & 127);
  F.key0 = mix(base);
#pragma unroll
  for (int i = 0; i < PPT; ++i)
    F.key[i] = mix(base + (uint32_t)(F.lane * PPT + i) * 128u);
  F.cum = smem + warp * (1 + ODE_S) * KP;
  F.ys = F.cum + KP;
  const Plan pl = load_plan(a.pi, a.pf);
  const float* walk = a.walk;

  float lt[ODE_P], prop[ODE_P], thp[ODE_P];
#pragma unroll
  for (int p = 0; p < ODE_P; ++p) thp[p] = a.theta0[(size_t)p * C + c];
  uint32_t slot = 0;
  float chi = particle_filter<PPT>(pl, F, thp, 0u, slot);
#pragma unroll
  for (int p = 0; p < ODE_P; ++p) lt[p] = logf(thp[p]);
  float acc = 0.0f, lsc = 0.0f;
  for (int it = 1; it < a.nits; ++it) {
    const uint32_t ctr = (uint32_t)it * a.stride;
    slot = 0;
    const float std = a.rwalk_std * expf(lsc);
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
    const float chi_new = particle_filter<PPT>(pl, F, thp, ctr, slot);
    float log_ratio = chi - chi_new;
    if (a.use_priors) {
      float lp_new = 0.0f, lp_old = 0.0f;
#pragma unroll
      for (int p = 0; p < ODE_P; ++p) {
        const float* e = a.prior + PRIOR_WIDTH * p;
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
    const float acc_step = accept ? 1.0f : 0.0f;
    acc = acc + acc_step;
    if (a.use_adapt && it <= a.burnin)
      lsc = lsc + a.adapt_rate * (acc_step - a.target);
    const int r = it - 1 - a.burnin;
    if (r >= 0 && F.lane == 0) {
#pragma unroll
      for (int p = 0; p < ODE_P; ++p)
        a.th_rec[((size_t)r * ODE_P + p) * C + c] = expf(lt[p]);
      a.chi_rec[(size_t)r * C + c] = chi;
      a.ar_rec[(size_t)r * C + c] = acc / (float)it;
    }
  }
}

template <int PPT>
int launch_pf(const PfArgs& a, cudaStream_t s) {
  const size_t per_warp = sizeof(float) * (1 + ODE_S) * 32 * PPT;
  if (per_warp > 48 * 1024) return (int)cudaErrorInvalidValue;
  int warps = PF_WARPS;
  while (warps * per_warp > 48 * 1024) --warps;
  pf_kernel<PPT><<<(a.C + warps - 1) / warps, 32 * warps, warps * per_warp,
                   s>>>(a);
  return (int)cudaGetLastError();
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
  if (K < 1 || K > PF_KMAX || C < 1) return (int)cudaErrorInvalidValue;
  const PfArgs a{pi, pf, theta0, walk, prior, th_rec, chi_rec, ar_rec,
                 C, K, nits, burnin, seed, stride, last_gi, use_priors,
                 use_adapt, rwalk_std, adapt_rate, target, log_k, inv_k};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // particles per lane: the least power of two with 32 PPT >= K
  if (K <= 32) return launch_pf<1>(a, s);
  if (K <= 64) return launch_pf<2>(a, s);
  if (K <= 128) return launch_pf<4>(a, s);
  if (K <= 256) return launch_pf<8>(a, s);
  return launch_pf<16>(a, s);
#else
  // this model has no diffusion: the library was built for an ODE
  return (int)cudaErrorNotSupported;
#endif
}

}  // extern "C"
