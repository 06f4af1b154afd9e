// Device code shared by the fused kernels (mh.cu, ensemble.cu, pt.cu,
// joint.cu, pf.cu): the runtime plan tables (and their staging into shared
// memory), the scorer, the counter RNG and the in-kernel priors.
//
// Counterparts in odelib_tpu/ops/pallas_mh.py: _build_plan (the plan, laid
// out as flat tables by ops/cuda_mh.py plan_tables), _make_scorer (every
// observation model, Tobit terms of censored observations, bolus doses)
// with the fixed steppers, _mix/_Rng, and _kernel_logpdf for its ten
// in-kernel prior families.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "odelib_gen.cuh"  // rhs(), step_dopri5(), step_rk4(), ODE_S, ODE_P,
                           // ODE_F, ObsModel0; with ODE_KVAERNO3, jac()
                           // and step_kvaerno3()

// The fixed steppers by id (ops/cuda_mh.py _STEPPER_ID; 2 is the particle
// filter's Euler step layout). A library built for a stiff path
// (ops/build.py, ODE_KVAERNO3) holds the kvaerno3 instantiations of the
// survey, MH, ensemble and PT kernels; in another, ODE_KV3(x) is a null
// entry of their launch tables and the launch returns an error.
enum : int { STEP_DOPRI5 = 0, STEP_RK4 = 1, STEP_KVAERNO3 = 3 };
#ifdef ODE_KVAERNO3
#define ODE_KV3(x) x
#else
#define ODE_KV3(x) nullptr
#endif

// A stepper id's row in a launch table {dopri5, rk4, kvaerno3}, or -1.
inline int stepper_row(int stepper) {
  return stepper == STEP_DOPRI5 ? 0 : stepper == STEP_RK4 ? 1
         : stepper == STEP_KVAERNO3 ? 2 : -1;
}

// Rows of the forcing table per step: one per distinct stage time of the
// stepper (ops/cuda_mh.py STAGE_C; 2, the particle filter's Euler step, 1).
// Each row holds the model's F forcing columns.
__host__ __device__ constexpr int forc_rows(int stepper) {
  return stepper == STEP_DOPRI5 ? 6 : stepper == 2 ? 1 : 3;
}

// The model of the generated header as a type, so the scorer can be
// instantiated per model: a joint fit of different models adds Model1, ...
// to the header (ops/build.py) and lists them all in ODE_MODELS. Its
// scoring constants (ObsModel0: FAMILY, CENSORED, DOSED and the family's
// constants) select at compile time the one branch of the scorer it runs.
// A step's forcing rows uf (forc_rows of its stepper, F floats each) are
// passed to the steppers, which hand each stage its row.
struct Model0 : ObsModel0 {
  static constexpr int S = ODE_S;
  static constexpr int P = ODE_P;
  static constexpr int F = ODE_F;
  static __device__ __forceinline__ void rhs(float t, const float* y,
                                             const float* p, const float* u,
                                             float* dy) {
    ::rhs(t, y, p, u, dy);
  }
  static __device__ __forceinline__ void step_dopri5(float* y,
                                                     const float* sf,
                                                     const float* p,
                                                     const float* uf) {
    ::step_dopri5(y, sf, p, uf);
  }
  static __device__ __forceinline__ void step_rk4(float* y, const float* sf,
                                                  const float* p,
                                                  const float* uf) {
    ::step_rk4(y, sf, p, uf);
  }
#ifdef ODE_KVAERNO3
  static __device__ __forceinline__ void step_kvaerno3(float* y,
                                                       const float* sf,
                                                       const float* p,
                                                       const float* uf) {
    ::step_kvaerno3(y, sf, p, uf);
  }
#endif
};
#ifndef ODE_MODELS
#define ODE_MODELS(X) X(0)
#define ODE_PMAX ODE_P
#endif

namespace odelib {

// Header of plan_i (ops/cuda_mh.py plan_tables).
enum : int {
  H_NSTEPS = 0, H_NGRID, H_NOBS, H_STEPPER,
  H_STEP_GI, H_STEP_OBS, H_OBS_PTR, H_OBS_MASK, H_INIT_PIDX,
  H_F_STEPS, H_F_LAB, H_F_DEN, H_F_AB, H_F_Y0,
  H_CEN, H_DOSE_PTR, H_DOSE_STATE, H_F_LSIG, H_F_DOSE_AMT, H_F_FORC
};

// Observation models (ops/build.py OBS_FAMILY).
enum : int { OBS_LOGNORMAL = 0, OBS_STUDENT_T, OBS_POISSON, OBS_NEGBINOM };

// Observations are flat: observation o reads its member mask (the states
// its prediction sums, bit s for state s: one word at index o for a model
// of at most 32 states, else mask_words(S) words from o mask_words(S)),
// lab, den and ab at index o, and step k the range [step_obs[2k],
// step_obs[2k + 1]) it scores; no load waits on another's result but the
// range's.
struct Plan {
  int n_steps;
  const int* step_gi;   // grid index scored after step k, or -1
  const int* step_obs;  // per step: first and end observation scored
  const int* obs_ptr;   // per grid point: first observation (CSR)
  const int* obs_mask;
  const int* init_pidx;
  float sstot;
  const float* steps;  // 8 floats per step
  const float* lab;
  const float* den;    // 2 * log_sigma^2
  const float* ab;
  const float* y0;
  const int* cen;         // per observation: 0 exact, 1 left, 2 right
  const float* lsig;      // per observation: log sigma
  const int* dose_ptr;    // per grid point: first dose (CSR)
  const int* dose_state;  // per dose: the raw state it joins
  const float* dose_amt;  // per dose: the amount (one entry per state)
  const float* forc;      // per step: forc_rows(stepper) rows of F columns
};

// Words of an observation's member mask in a model of S states.
__host__ __device__ constexpr int mask_words(int S) {
  return S <= 32 ? 1 : (S + 31) / 32;
}

__device__ __forceinline__ Plan load_plan(const int* __restrict__ pi,
                                          const float* __restrict__ pf) {
  Plan p;
  p.n_steps = pi[H_NSTEPS];
  p.step_gi = pi + pi[H_STEP_GI];
  p.step_obs = pi + pi[H_STEP_OBS];
  p.obs_ptr = pi + pi[H_OBS_PTR];
  p.obs_mask = pi + pi[H_OBS_MASK];
  p.init_pidx = pi + pi[H_INIT_PIDX];
  p.sstot = pf[0];
  p.steps = pf + pi[H_F_STEPS];
  p.lab = pf + pi[H_F_LAB];
  p.den = pf + pi[H_F_DEN];
  p.ab = pf + pi[H_F_AB];
  p.y0 = pf + pi[H_F_Y0];
  p.cen = pi + pi[H_CEN];
  p.lsig = pf + pi[H_F_LSIG];
  p.dose_ptr = pi + pi[H_DOSE_PTR];
  p.dose_state = pi + pi[H_DOSE_STATE];
  p.dose_amt = pf + pi[H_F_DOSE_AMT];
  p.forc = pf + pi[H_F_FORC];
  return p;
}

// Dynamic shared memory a kernel stages its read-only tables into without
// opting in to more (cudaFuncSetAttribute); tables that do not fit are read
// from global memory.
constexpr int SMEM_STAGE_MAX = 48 * 1024;

// Copy n words of a read-only table into shared memory, the block's
// threads in turn; the caller waits at a block barrier before reading it.
// Returns the staged copy: the Plan's generic pointers may point into it.
template <class T>
__device__ __forceinline__ T* stage(const T* __restrict__ src, T* dst, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  return dst;
}

// Dynamic shared memory that stages a plan of n_i + n_f words, or 0 where
// it does not fit (the launch then passes n_i = n_f = 0).
inline size_t plan_smem(int n_i, int n_f) {
  const size_t bytes = sizeof(int) * ((size_t)n_i + (size_t)n_f);
  return bytes <= SMEM_STAGE_MAX ? bytes : 0;
}

// The plan of a launch that staged it (n_i > 0: its dynamic shared memory
// holds the tables), else read from global memory; every thread of the
// block calls it. ens_kernel stages inline: through this helper ptxas
// allocated it 84 registers in place of 94, and it ran 8 % slower.
__device__ __forceinline__ Plan staged_plan(const int* pi, int n_i,
                                            const float* pf, int n_f) {
  extern __shared__ uint32_t smem[];
  if (n_i > 0) {
    pi = stage(pi, reinterpret_cast<int*>(smem), n_i);
    pf = stage(pf, reinterpret_cast<float*>(smem + n_i), n_f);
    __syncthreads();
  }
  return load_plan(pi, pf);
}

// v[i] for a runtime i, by an unrolled select so v stays in registers.
template <int N>
__device__ __forceinline__ float pick(const float* v, int i) {
  float r = v[0];
#pragma unroll
  for (int k = 1; k < N; ++k) r = (i == k) ? v[k] : r;
  return r;
}

// The Tobit terms run in double and round once to float32: in float32 the
// t log-CDF's upper tail loses ~1.5e-5 relative at nu = 100. Their torch
// twins are ops/cuda_mh.py log_ndtr, betacf and t_logcdf, the same double
// operations in the same order. They are called, not inlined: inlined into
// every instantiation of the five kernels (pf_kernel's ten), they made a
// library's build take minutes.
constexpr double RSQRT2 = 0.7071067811865476;

// log Phi(z): log1p(-erfc(z/sqrt2)/2) for z >= 0, and
// log(erfcx(-z/sqrt2)/2) - z^2/2 below (exact in the deep tail, where
// XLA's log_ndtr uses its asymptotic series). NaN stays NaN.
static __device__ __noinline__ float log_ndtr(float z) {
  const double zd = z;
  const double r = zd >= 0.0
                       ? log1p(-0.5 * erfc(zd * RSQRT2))
                       : log(0.5 * erfcx(-zd * RSQRT2)) - 0.5 * (zd * zd);
  return (float)r;
}

// The continued fraction of the regularized incomplete beta by modified
// Lentz (Numerical Recipes betacf), iterated until the last factor is
// within 1e-10 of 1, at most 300 times; valid for x < (a+1)/(a+b+2).
static __device__ __noinline__ double betacf(double a, double b,
                                              double x) {
  constexpr double FPMIN = 1e-300, EPS = 1e-10;
  const double qab = a + b, qap = a + 1.0, qam = a - 1.0;
  double c = 1.0;
  double d = 1.0 - (qab * x) / qap;
  d = 1.0 / (fabs(d) < FPMIN ? FPMIN : d);
  double h = d;
  for (int m = 1; m <= 300; ++m) {
    const double md = m;
    double aa = ((md * (b - md)) * x) / ((qam + 2.0 * md) * (a + 2.0 * md));
    d = 1.0 + aa * d;
    d = 1.0 / (fabs(d) < FPMIN ? FPMIN : d);
    c = 1.0 + aa / c;
    c = fabs(c) < FPMIN ? FPMIN : c;
    h = h * (d * c);
    aa = ((-(a + md) * (qab + md)) * x) /
         ((a + 2.0 * md) * (qap + 2.0 * md));
    d = 1.0 + aa * d;
    d = 1.0 / (fabs(d) < FPMIN ? FPMIN : d);
    c = 1.0 + aa / c;
    c = fabs(c) < FPMIN ? FPMIN : c;
    const double del = d * c;
    h = h * del;
    if (fabs(del - 1.0) < EPS) break;
  }
  return h;
}

// The Student-t log CDF's constants, in double from the host
// (ops/cuda_mh.py t_constants): nu, a = nu/2, the continued fraction's
// switch (a + 1)/(a + 5/2), and the two branches' constant terms.
struct TCdf {
  double nu, a, thresh, ka, kb;
};

template <class M>
__host__ __device__ constexpr TCdf t_cdf_of() {
  return TCdf{M::T_NU, M::T_A, M::T_THRESH, M::T_KA, M::T_KB};
}

// log T_nu(z): u = z^2/nu, x = 1/(1 + u), log x = -log1p(u), log(1 - x) =
// -log1p(1/u); below the switch log(I_x(a, 1/2)/2) by the direct
// continued fraction, above it by I_x(a, b) = 1 - I_{1-x}(b, a); T = I_x/2
// for z < 0 and 1 - I_x/2 otherwise. A NaN z (a failed prediction) is
// returned at once: the fraction would run its 300 steps on NaN, and the
// ensemble's grid barrier waits for its slowest walker (92 x the kernel's
// time on censored Student-t data before this check).
static __device__ __noinline__ float t_logcdf(float z, const TCdf c) {
  if (z != z) return z;
  const double zd = z;
  const double u = (zd * zd) / c.nu;
  const double x = 1.0 / (1.0 + u);
  const double lx = -log1p(u);
  const double lomx = -log1p(1.0 / u);
  double log_half;
  if (x < c.thresh) {
    log_half = ((c.a * lx + 0.5 * lomx) + c.ka) + log(betacf(c.a, 0.5, x));
  } else {
    const double omx = u / (1.0 + u);
    const double J =
        exp((0.5 * lomx + c.a * lx) + c.kb) * betacf(0.5, c.a, omx);
    log_half = log(0.5 * (1.0 - J));
  }
  return (float)(zd < 0.0 ? log_half : log1p(-exp(log_half)));
}

// Observation terms of observations [o0, o1) of model M (its S states and
// scoring constants). The prediction sums the masked states in ascending
// order, the members' order of the twin's obs_terms; each family's
// operations are the JAX kernel's contrib, in its order.
template <class M>
__device__ __forceinline__ void obs_terms(const Plan& pl, int o0, int o1,
                                          const float* y, float& chi,
                                          float& ssres) {
  for (int o = o0; o < o1; ++o) {
    // above 32 states, word s / 32 of the observation's words holds bit s
    int mask = 0;
    const int* words = nullptr;
    if constexpr (M::S <= 32) {
      mask = pl.obs_mask[o];
    } else {
      words = pl.obs_mask + (size_t)o * mask_words(M::S);
    }
    const float lab = pl.lab[o], den = pl.den[o], ab = pl.ab[o];
    float pred = 0.0f;
    bool first = true;
#pragma unroll
    for (int s = 0; s < M::S; ++s) {
      bool member;
      if constexpr (M::S <= 32) {
        member = (mask >> s) & 1;
      } else {
        member = (words[s / 32] >> (s % 32)) & 1;
      }
      if (member) {
        pred = first ? y[s] : pred + y[s];
        first = false;
      }
    }
    // no floor on pred: a blown-up trajectory gives a non-finite chi
    if constexpr (M::CENSORED) {
      const int cen = pl.cen[o];
      if (cen != 0) {   // Tobit: -log F(z) of the log-space model
        float z = (lab - logf(pred)) / pl.lsig[o];
        if (cen == 2) z = -z;
        if constexpr (M::FAMILY == OBS_STUDENT_T) {
          chi = chi - t_logcdf(z, t_cdf_of<M>());
        } else {
          chi = chi - log_ndtr(z);
        }
        continue;       // a limit is not a measurement: no R^2 term
      }
    }
    if constexpr (M::FAMILY == OBS_LOGNORMAL) {
      const float d = lab - logf(pred);
      chi = chi + (d * d) / den;
    } else if constexpr (M::FAMILY == OBS_STUDENT_T) {
      const float t = (lab - logf(pred)) / pl.lsig[o];
      chi = chi + M::C1 * log1pf((t * t) / M::NU);
    } else {
      float term;
      if constexpr (M::FAMILY == OBS_POISSON) {
        term = ab > 0.0f ? pred - ab * logf(pred) : pred - 0.0f;
      } else {          // negbinom, dispersion R
        term = M::R * log1pf(pred / M::R);
        if (ab > 0.0f) term = term + ab * log1pf(M::R / pred);
      }
      chi = chi + (pred >= 0.0f ? term : NAN);
    }
    const float e = pred - ab;
    ssres = ssres + e * e;
  }
}

// Observation terms scored at grid point gi.
template <class M>
__device__ __forceinline__ void contrib(const Plan& pl, int gi,
                                        const float* y, float& chi,
                                        float& ssres) {
  obs_terms<M>(pl, pl.obs_ptr[gi], pl.obs_ptr[gi + 1], y, chi, ssres);
}

// The doses leaving grid point gi (one entry per state, summed on the
// host), added by an unrolled select so y stays in registers.
template <int S>
__device__ __forceinline__ void apply_doses(const Plan& pl, int gi,
                                            float* y) {
  for (int d = pl.dose_ptr[gi]; d < pl.dose_ptr[gi + 1]; ++d) {
    const int st = pl.dose_state[d];
    const float amt = pl.dose_amt[d];
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (st == s) y[s] = y[s] + amt;
  }
}

// The fixed-step solve of model M over the plan's steps, scored; a dosed
// model's doses join after each grid point's terms (grid point 0's
// included). Step k's observation range is read before its arithmetic, so
// its latency hides behind the step.
template <class M, int STEPPER>
__device__ __forceinline__ void score_model(const Plan& pl,
                                            const float* theta,
                                            float& chi_out, float& rsq_out) {
  float y[M::S];
#pragma unroll
  for (int s = 0; s < M::S; ++s) {
    const int ip = pl.init_pidx[s];
    y[s] = ip >= 0 ? pick<M::P>(theta, ip) : pl.y0[s];
  }
  float chi = 0.0f, ssres = 0.0f;
  contrib<M>(pl, 0, y, chi, ssres);
  if constexpr (M::DOSED) apply_doses<M::S>(pl, 0, y);
  for (int k = 0; k < pl.n_steps; ++k) {
    const int o0 = pl.step_obs[2 * k], o1 = pl.step_obs[2 * k + 1];
    const float* sf = pl.steps + 8 * k;
    const float* uf = pl.forc + k * (forc_rows(STEPPER) * M::F);
    if constexpr (STEPPER == STEP_DOPRI5) {
      M::step_dopri5(y, sf, theta, uf);
    } else if constexpr (STEPPER == STEP_RK4) {
      M::step_rk4(y, sf, theta, uf);
    } else {
      M::step_kvaerno3(y, sf, theta, uf);
    }
    obs_terms<M>(pl, o0, o1, y, chi, ssres);
    if constexpr (M::DOSED) {
      const int gi = pl.step_gi[k];
      if (gi >= 0) apply_doses<M::S>(pl, gi, y);
    }
  }
  chi_out = chi;
  rsq_out = 1.0f - ssres / pl.sstot;
}

template <int STEPPER>
__device__ __forceinline__ void score(const Plan& pl, const float* theta,
                                      float& chi_out, float& rsq_out) {
  score_model<Model0, STEPPER>(pl, theta, chi_out, rsq_out);
}

// SplitMix32 finalizer and the counter RNG of odelib_tpu's _Rng.
__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x += 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The (0, 1) uniform of a key and a counter word already mixed, mix(ctr):
// keys that share a counter (a chain's particles) share its mix.
__device__ __forceinline__ float uniform_mixed(uint32_t key, uint32_t mctr) {
  const uint32_t w = mix(key ^ mctr);
  return (float)(int32_t)(w >> 8) * 0x1p-24f + 0x1p-25f;
}

__device__ __forceinline__ float uniform(uint32_t key, uint32_t ctr) {
  return uniform_mixed(key, mix(ctr));
}

// Box-Muller (cos half only) from slots ctr and ctr + 1.
__device__ __forceinline__ float normal(uint32_t key, uint32_t ctr) {
  const float u1 = uniform(key, ctr);
  const float u2 = uniform(key, ctr + 1u);
  return sqrtf(-2.0f * logf(u1)) * cosf(ODELIB_TWO_PI * u2);
}

// Log prior density of one theta slot, from its 6-float table entry
// (ops/priors.py prior_table): the family, loc, scale, two shape values
// p1 and p2, and the normalising constant c, each rounded to float32 on the
// host as _kernel_logpdf's Python floats are where they meet the float32
// theta. p1, p2 by family: LogNormal s; Uniform the upper edge; Gamma a - 1;
// TruncNormal a, b; Weibull c - 1, c; Beta a - 1, b - 1. Each family's
// operations are _kernel_logpdf's, in its order.
enum : int {
  PRIOR_NONE = 0, PRIOR_LOGNORMAL, PRIOR_NORMAL, PRIOR_UNIFORM, PRIOR_GAMMA,
  PRIOR_TRUNCNORMAL, PRIOR_EXPONENTIAL, PRIOR_CAUCHY, PRIOR_HALFNORMAL,
  PRIOR_WEIBULL, PRIOR_BETA
};
constexpr int PRIOR_WIDTH = 6;

__device__ __forceinline__ float log_prior(const float* e, float x) {
  const int fam = (int)e[0];
  const float loc = e[1], scale = e[2], p1 = e[3], p2 = e[4], c = e[5];
  const float y = (x - loc) / scale;   // z of the location-scale families
  switch (fam) {
    case PRIOR_LOGNORMAL: {
      const float ly = logf(fmaxf(y, 1e-37f));
      const float q = ly / p1;
      return y > 0.0f ? (-0.5f * (q * q) - ly) + c : -INFINITY;
    }
    case PRIOR_NORMAL:
      return -0.5f * y * y + c;
    case PRIOR_UNIFORM:
      return (x >= loc && x <= p1) ? c : -INFINITY;
    case PRIOR_GAMMA: {
      const float ly = logf(fmaxf(y, 1e-37f));
      return y > 0.0f ? (p1 * ly - y) + c : -INFINITY;
    }
    case PRIOR_TRUNCNORMAL:
      return (y >= p1 && y <= p2) ? -0.5f * y * y + c : -INFINITY;
    case PRIOR_EXPONENTIAL:
      return y >= 0.0f ? -y + c : -INFINITY;
    case PRIOR_CAUCHY:
      return -log1pf(y * y) + c;
    case PRIOR_HALFNORMAL:
      return y >= 0.0f ? -0.5f * y * y + c : -INFINITY;
    case PRIOR_WEIBULL: {
      const float ly = logf(fmaxf(y, 1e-37f));
      return y > 0.0f ? (p1 * ly - expf(p2 * ly)) + c : -INFINITY;
    }
    case PRIOR_BETA: {
      const bool inside = y > 0.0f && y < 1.0f;
      const float ys = inside ? y : 0.5f;
      return inside ? (p1 * logf(ys) + p2 * log1pf(-ys)) + c : -INFINITY;
    }
    default:
      return 0.0f;
  }
}

// The prior sum of N slots at theta th: the slots with a prior add to a
// zero start in slot order, as the JAX kernels' logprior does.
template <int N>
__device__ __forceinline__ float log_prior_sum(const float* __restrict__ tab,
                                               const float* th) {
  float lp = 0.0f;
#pragma unroll
  for (int p = 0; p < N; ++p) {
    const float* e = tab + PRIOR_WIDTH * p;
    if ((int)e[0] != PRIOR_NONE) lp = lp + log_prior(e, th[p]);
  }
  return lp;
}

}  // namespace odelib
