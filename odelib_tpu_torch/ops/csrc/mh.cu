// Fused survey and Metropolis-Hastings kernels for Hopper (sm_90a).
//
// Replaces, in odelib_tpu/ops/pallas_mh.py:
//   survey_kernel  <- _cached_survey_call (public survey_fused)
//   mh_kernel      <- _cached_mh_grid, whole-run and chunk mode (public
//                     metropolis_hastings_fused via _cached_mh_run and
//                     _mh_fused_chunked)
//
// What bounds them on the card: neither moves meaningful bytes (the MH
// kernel writes (P+4) floats per chain and recorded iteration; the plan
// tables are a few KB). A solve is one long chain of dependent float32
// operations and transcendental calls (a full fixed-step solve over the
// compact observation grid), so both kernels are bound by the latency of
// one solve, not by the card's operations: a serial MH run is nits - 1
// solve latencies end to end, and one thread per chain left the main
// path's 10,000 chains at 2.4 warps per SM, the schedulers mostly idle.
//
// What the MH design does about it: prefetching MH (Brockwell 2006,
// "Parallel Markov chain Monte Carlo simulation by pre-fetching", JCGS
// 15(1)). Each chain runs on a group of 4 lanes holding the same
// (replicated) state: log-theta, chi, R^2, the accept count. The RNG is a
// counter (slot k of iteration it is mix(key ^ mix(it 1024 + k)), keyed on
// the chain's global index), so at the start of a round at iteration it
// every proposal the next iterations can make is known. The lanes solve
// the four nodes of a speculation tree (node_child below), one each:
//   lane 0 (A): the proposal of iteration it, from lt;
//   lane 1 (B): iteration it+1 if A accepts, from A's proposal;
//   lanes 2, 3: while the chain's acceptance so far is at most 1/2,
//     C (it+1 if A rejects, from lt) and D (it+2 if A and C reject);
//     up to 4/5, C and BB (it+2 if A and B accept); above it, BB and BBB.
// Every lane builds all four proposals (the normals of it .. it+3) and
// solves its own; the group exchanges chi and R^2 by width-4 shuffles,
// and every lane replays the serial decisions down the tree,
// exp(chi - chi_new) > u with the same uniforms (NaN rejected), so all four
// update the same state with no second exchange. A round advances 2 or 3
// iterations on the first two trees (on average 2 + (1 - a)^2 and 2 + a^2
// at acceptance a: 2.4 on the first at the main path's 0.35) and 1 to 4 on
// the last (1 + a + a^2 + a^3). The tree matters because the launch ends
// with its slowest chain: on the first tree alone a chain that accepts
// every proposal needs (nits - 1) / 2 rounds, against about
// (nits - 1) / 2.4 for the rest. Lanes whose iteration is past
// nits - 1 solve nothing, and their results are never read. The lanes
// split the stores: lane k writes the k-th row the round completes (burn-in
// rows are never written). Each lane's proposal, solve and decision are
// the serial chain's operations on the serial chain's operands; only which
// lane does them, and when, changes, so the records are bitwise those of
// the serial loop (mh_plain, ops/cuda_mh.py; the lane-by-lane emulation in
// tests/test_torch_mh_prefetch.py). The round loop runs while any lane of
// the warp has iterations left, so the shuffles always see the whole warp;
// lanes past the last chain take part and store nothing. 8 chains a warp:
// the main path's 10,000 chains are 40,000 threads, about 9.5 warps per
// SM, each solving once a round. The launch bounds name one block per SM
// as the least, so ptxas does not trade registers for resident blocks (as
// pt.cu).
//
// In-kernel priors (pallas_mh.py:1044-1125): the PRIORS instantiations
// carry the chain's log prior lp and accept when exp((chi - chi_new) +
// (lp_new - lp)) > u. Each lane evaluates the log prior of its own node
// beside its solve (common.cuh log_prior_sum, on the theta it solves) and
// the group exchanges it with chi and R^2: one evaluation a lane and round.
// (Replaying lanes that each evaluated every node they replay, up to four
// in turn after the exchange, made mh_kernel 10-17 % slower; PERF.md §6.)
// Without priors the kernel is the prior-free code.
//
// Chunk mode (pallas_mh.py:1031-1037, :1057-1084, :1104-1108): a launch
// covers the proposals it_base + 1 .. it_end - 1, so a run cut into chunks
// is a sequence of launches. The state (P + 4) x C (log-theta, chi, R^2,
// the accept count, the log prior, 0 without priors) comes in from
// state_in instead of the scoring of theta0, and one lane of each group
// writes it to state_out after the last round. A round's tree may cross
// it_end: its nodes at or past it_end solve nothing and the replay stops
// there, as at the run's end, and the next launch builds its round from the
// persisted state. The tree choice reads the global acc and it - 1, both
// exact after a reload, so every decision is the serial chain's and the
// records are bitwise those of one launch. The CHUNK template flag
// compiles the state's load and store in; the whole run (it_base = 0,
// it_end = nits, no state) is the false instantiation, the code without
// chunks (with the branches in every instantiation the 21-step schedule's
// whole run took 2.7 % longer; PERF.md §6).
//
// Both kernels stage the plan (step list, per-grid-point observation CSR,
// y0) in shared memory where it fits in 48 KB (common.cuh staged_plan), as the
// ensemble and joint kernels do: the survey's one solve then reads no table
// cold from L2 inside its step loop. The plan is a runtime table, so one
// build serves every dataset and schedule of a model: only the RHS, S and
// P are compiled in (odelib_gen.cuh, generated by ops/build.py). The survey
// runs a thread per draw in 32-thread blocks, so 1,000 draws spread over
// 32 SMs. Records are (R, P, C) and (R, C), chain-minor.
//
// Numerics: built with -fmad=false and without fast math, so every
// operation rounds like its torch twin (ops/cuda_mh.py) and the JAX
// kernel: same order of the Dopri5/RK4 stage sums and of the Kvaerno3
// stepper's elimination and Newton updates, constants rounded to float32
// on the host, and the same counter RNG words.
//
// The stiff path (pallas_mh.py:87-91's kvaerno3 stepper): a library built
// with ODE_KVAERNO3 adds the STEPPER = 3 instantiations, which step with
// the generated step_kvaerno3 (ops/build.py kvaerno3_source: one traced
// Jacobian a step, I - h gamma J eliminated in registers, four
// chord-Newton iterations a stage, each quotient a corrected product of a
// reciprocal taken once a step, with no IEEE division and no branch on the
// Newton chain). Everything else is the same kernel: in mh_kernel each of
// a chain's four lanes runs the stepper on its node.
#include "common.cuh"  // staged_plan, score<STEPPER>, mix, uniform, normal

#define SURVEY_BLOCK 32
#define MH_BLOCK 128
#define MH_GROUP 4   // lanes a chain: the speculation tree's nodes

namespace {

using namespace odelib;

template <int STEPPER>
__global__ void __launch_bounds__(SURVEY_BLOCK)
survey_kernel(const int* __restrict__ pi, int n_i,
              const float* __restrict__ pf, int n_f,
              const float* __restrict__ theta, float* __restrict__ chi_out,
              int N) {
  const Plan pl = staged_plan(pi, n_i, pf, n_f);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float th[ODE_P];
#pragma unroll
  for (int p = 0; p < ODE_P; ++p) th[p] = theta[(size_t)p * N + n];
  float chi, rsq;
  score<STEPPER>(pl, th, chi, rsq);
  chi_out[n] = chi;
}

struct MhArgs {
  const int* pi;
  const float* pf;
  const float* theta0;
  const float* walk;     // P walk scales, then P walked flags
  const float* prior;    // P prior table entries (PRIORS instantiations)
  const float* state_in; // (P + 4) x C chain state, or null: score theta0
  float* state_out;      // (P + 4) x C chain state after it_end - 1, or null
  float* th_rec;
  float* chi_rec;
  float* rsq_rec;
  float* aic_rec;
  float* ar_rec;
  int n_i, n_f;          // plan words staged in shared memory (0: none)
  int C;
  int it_base, it_end;   // the launch's proposals: it_base + 1 .. it_end - 1
  int rec0;              // row it - 1 - rec0 records iteration it (if >= 0)
  uint32_t seed;
  float aic_const;
};

// The chain's state after one replayed decision on proposal `prop` with
// its score (chi_new, rsq_new) and, with PRIORS, its log prior lp_new; the
// serial kernel's update exactly (pallas_mh.py:1115-1125).
template <bool PRIORS>
__device__ __forceinline__ bool decide(float (&lt)[ODE_P], float& chi,
                                       float& rsq, float& acc, float& lp,
                                       const float (&prop)[ODE_P],
                                       float chi_new, float rsq_new,
                                       float lp_new, float u) {
  float log_ratio = chi - chi_new;
  if constexpr (PRIORS) log_ratio = log_ratio + (lp_new - lp);
  // NaN or -inf log ratio compares false: rejected
  const bool ok = expf(log_ratio) > u;
  if (ok) {
#pragma unroll
    for (int p = 0; p < ODE_P; ++p) lt[p] = prop[p];
    chi = chi_new;
    rsq = rsq_new;
    acc = acc + 1.0f;
    if constexpr (PRIORS) lp = lp_new;
  }
  return ok;
}

// Row `it` of the records (if recorded) from the state after iteration it.
__device__ __forceinline__ void record(const MhArgs& a, int c, int it,
                                       const float (&lt)[ODE_P], float chi,
                                       float rsq, float acc) {
  const int r = it - 1 - a.rec0;
  if (r < 0) return;
  const int C = a.C;
  const size_t row = (size_t)r * C + c;
#pragma unroll
  for (int p = 0; p < ODE_P; ++p)
    a.th_rec[((size_t)r * ODE_P + p) * C + c] = expf(lt[p]);
  a.chi_rec[row] = chi;
  a.rsq_rec[row] = rsq;
  a.aic_rec[row] = 2.0f * chi + a.aic_const;
  a.ar_rec[row] = acc / (float)it;
}

// The speculation trees of a round: lane n solves node n. Node 0 is the
// proposal of iteration it (A); a node at depth d proposes for it + d after
// the decisions on its path. By the chain's acceptance so far:
//   tree 0 (up to 1/2): A; B after A accepts; C after A rejects; D after A
//            and C reject (the header's layout);
//   tree 1 (1/2 to 4/5): A; B; C; BB after A and B accept;
//   tree 2 (above 4/5): A; B; BB; BBB, the all-accept path.
__device__ __forceinline__ int node_depth(int tree, int n) {
  return n < 2 ? n : (tree == 2 ? n : n - 1);
}

// The node after node n's decision `ok`, or -1 where the tree ends.
__device__ __forceinline__ int node_child(int tree, int n, bool ok) {
  if (tree == 0) return n == 0 ? (ok ? 1 : 2) : (n == 2 && !ok ? 3 : -1);
  if (tree == 1) return n == 0 ? (ok ? 1 : 2) : (n == 1 && ok ? 3 : -1);
  return ok && n < 3 ? n + 1 : -1;
}

__device__ __forceinline__ float pick4(const float (&v)[4], int n) {
  return n == 0 ? v[0] : n == 1 ? v[1] : n == 2 ? v[2] : v[3];
}

// PRIORS adds the log prior to the acceptance (a.prior); the false
// instantiations are the prior-free kernel, the prior's code compiled out.
// CHUNK reads it_base and the state in and out; without it the launch is a
// whole run.
template <int STEPPER, bool PRIORS, bool CHUNK>
__global__ void __launch_bounds__(MH_BLOCK, 1) mh_kernel(const MhArgs a) {
  constexpr int G = MH_GROUP;
  const Plan pl = staged_plan(a.pi, a.n_i, a.pf, a.n_f);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int c_own = t / G;
  const int role = t % G;
  const bool live = c_own < a.C;
  const int c = live ? c_own : a.C - 1;
  const int C = a.C, it_end = a.it_end;
  float lt[ODE_P], thp[ODE_P], scale[ODE_P];
  bool walked[ODE_P];
#pragma unroll
  for (int p = 0; p < ODE_P; ++p) {
    scale[p] = a.walk[p];
    walked[p] = a.walk[ODE_P + p] != 0.0f;
  }
  float chi, rsq, acc;
  float lp = 0.0f;   // the log prior at the chain's state
  if (CHUNK && a.state_in) {
#pragma unroll
    for (int p = 0; p < ODE_P; ++p) lt[p] = a.state_in[(size_t)p * C + c];
    chi = a.state_in[(size_t)ODE_P * C + c];
    rsq = a.state_in[(size_t)(ODE_P + 1) * C + c];
    acc = a.state_in[(size_t)(ODE_P + 2) * C + c];
    if constexpr (PRIORS) lp = a.state_in[(size_t)(ODE_P + 3) * C + c];
  } else {
#pragma unroll
    for (int p = 0; p < ODE_P; ++p) thp[p] = a.theta0[(size_t)p * C + c];
    score<STEPPER>(pl, thp, chi, rsq);
    if constexpr (PRIORS) lp = log_prior_sum<ODE_P>(a.prior, thp);
#pragma unroll
    for (int p = 0; p < ODE_P; ++p) lt[p] = logf(thp[p]);
    acc = 0.0f;
  }
  // the chain's global index keys its stream: any layout gives the JAX
  // kernel's words
  const uint32_t key = mix(a.seed * 0x9E3779B1u + (uint32_t)c);
  // the next iteration of this lane's chain
  int it = live ? (CHUNK ? a.it_base : 0) + 1 : it_end;
  while (__any_sync(0xFFFFFFFFu, it < it_end)) {
    const uint32_t b0 = (uint32_t)it * 1024u;
    // every lane of the group picks the same tree from the same state
    const float past = (float)(it - 1);
    const int tree = acc > 0.8f * past ? 2 : acc > 0.5f * past ? 1 : 0;
    // the nodes' proposals, each the serial chain's on the node's path
    float nd[4][ODE_P];
    uint32_t slot = 0;
#pragma unroll
    for (int p = 0; p < ODE_P; ++p) {
      if (walked[p]) {
        const float s1 = scale[p] * normal(key, b0 + 1024u + slot);
        const float s2 = scale[p] * normal(key, b0 + 2048u + slot);
        nd[0][p] = lt[p] + scale[p] * normal(key, b0 + slot);   // A
        nd[1][p] = nd[0][p] + s1;                                // B
        if (tree == 2) {
          nd[2][p] = nd[1][p] + s2;                              // BB
          nd[3][p] = nd[2][p] + scale[p] * normal(key, b0 + 3072u + slot);
        } else {
          nd[2][p] = lt[p] + s1;                                 // C
          nd[3][p] = tree == 0 ? lt[p] + s2 : nd[1][p] + s2;     // D, BB
        }
        slot += 2;
      } else {
#pragma unroll
        for (int n = 0; n < 4; ++n) nd[n][p] = lt[p];
      }
      thp[p] = expf(role == 0 ? nd[0][p] : role == 1 ? nd[1][p]
                    : role == 2 ? nd[2][p] : nd[3][p]);
    }
    // lanes past this launch's last iteration solve nothing; their results
    // are never read
    const int ahead = node_depth(tree, role);
    float chi_new = 0.0f, rsq_new = 0.0f, lp_new = 0.0f;
    if (it + ahead < it_end) {
      score<STEPPER>(pl, thp, chi_new, rsq_new);
      if constexpr (PRIORS) lp_new = log_prior_sum<ODE_P>(a.prior, thp);
    }
    float chi_n[4], rsq_n[4], lp_n[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      chi_n[n] = __shfl_sync(0xFFFFFFFFu, chi_new, n, G);
      rsq_n[n] = __shfl_sync(0xFFFFFFFFu, rsq_new, n, G);
      lp_n[n] = PRIORS ? __shfl_sync(0xFFFFFFFFu, lp_new, n, G) : 0.0f;
    }
    if (it < it_end) {
      // replay the serial decisions down the tree; lane k stores the k-th
      // row of the round
      int n = 0, k = 0;
      for (;;) {
        float prop[ODE_P];
#pragma unroll
        for (int p = 0; p < ODE_P; ++p)
          prop[p] = n == 0 ? nd[0][p] : n == 1 ? nd[1][p]
                    : n == 2 ? nd[2][p] : nd[3][p];
        const bool ok = decide<PRIORS>(lt, chi, rsq, acc, lp, prop,
                                       pick4(chi_n, n), pick4(rsq_n, n),
                                       pick4(lp_n, n),
                                       uniform(key, b0 + 1024u * k + slot));
        if (live && role == k) record(a, c, it + k, lt, chi, rsq, acc);
        ++k;
        const int next = node_child(tree, n, ok);
        if (next < 0 || it + k >= it_end) break;
        n = next;
      }
      it += k;
    }
  }
  if (CHUNK && a.state_out && live && role == 0) {
#pragma unroll
    for (int p = 0; p < ODE_P; ++p) a.state_out[(size_t)p * C + c] = lt[p];
    a.state_out[(size_t)ODE_P * C + c] = chi;
    a.state_out[(size_t)(ODE_P + 1) * C + c] = rsq;
    a.state_out[(size_t)(ODE_P + 2) * C + c] = acc;
    a.state_out[(size_t)(ODE_P + 3) * C + c] = lp;
  }
}

}  // namespace

namespace {

// The device probe: y = x + 1 over a float32 tile, one thread an element.
// ops/build.py launches it once as it loads each library and raises if
// the result is wrong (the JAX package's mosaic_supported compiles and
// runs a trivial pallas_call once for the same purpose).
__global__ void probe_kernel(const float* __restrict__ x, int n,
                             float* __restrict__ y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + 1.0f;
}

__global__ void tobit_kernel(const float* __restrict__ z, int n, int which,
                             odelib::TCdf c, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    out[i] = which ? odelib::t_logcdf(z[i], c) : odelib::log_ndtr(z[i]);
}

#ifdef ODE_KVAERNO3
// A probe of step_kvaerno3's quotient (ops/build.py KV3_QUOTIENT): on
// arrays, q = kv3_quotient(x, kv3_divisor(d, 1/d)) and its flag (1 where
// the step would be taken again with IEEE divisions: d out of range, or a
// subnormal quotient) beside ref = the IEEE division.
__global__ void kv3_quotient_kernel(const float* __restrict__ x,
                                    const float* __restrict__ d, int n,
                                    float* __restrict__ q,
                                    float* __restrict__ ref,
                                    float* __restrict__ flag) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    bool bad = false;
    const Kv3Div v = kv3_divisor(d[i], __frcp_rn(d[i]), bad);
    q[i] = kv3_quotient(x[i], v, bad);
    ref[i] = __fdiv_rn(x[i], d[i]);
    flag[i] = bad ? 1.0f : 0.0f;
  }
}
#endif

}  // namespace

extern "C" {

int odelib_survey(const int* pi, int n_i, const float* pf, int n_f,
                  const float* theta, float* chi, int N, int stepper,
                  void* stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = odelib::plan_smem(n_i, n_f);
  if (smem == 0) n_i = n_f = 0;
  const int grid = (N + SURVEY_BLOCK - 1) / SURVEY_BLOCK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using Survey = void (*)(const int*, int, const float*, int, const float*,
                          float*, int);
  const Survey kernels[3] = {&survey_kernel<STEP_DOPRI5>,
                             &survey_kernel<STEP_RK4>,
                             ODE_KV3(&survey_kernel<STEP_KVAERNO3>)};
  const int row = stepper_row(stepper);
  if (row < 0 || !kernels[row]) return (int)cudaErrorInvalidValue;
  kernels[row]<<<grid, SURVEY_BLOCK, smem, s>>>(pi, n_i, pf, n_f, theta, chi,
                                                N);
  return (int)cudaGetLastError();
}

// prior: P table entries of PRIOR_WIDTH floats, or null for none. The
// launch runs iterations it_base + 1 .. it_end - 1 and records iteration it
// in row it - 1 - rec0 where that is >= 0: a whole run is it_base = 0,
// it_end = nits, rec0 = burnin; a chunk of R_chunk proposals is it_end =
// it_base + R_chunk + 1, rec0 = it_base. state_in (or null: score theta0)
// and state_out (or null) are (P + 4) x C.
int odelib_mh(const int* pi, int n_i, const float* pf, int n_f,
              const float* theta0, const float* walk, const float* prior,
              const float* state_in, float* state_out, float* th_rec,
              float* chi_rec, float* rsq_rec, float* aic_rec, float* ar_rec,
              int C, int it_base, int it_end, int rec0, unsigned int seed,
              float aic_const, int stepper, void* stream) {
  if (C < 1 || it_base < 0 || it_end <= it_base)
    return (int)cudaErrorInvalidValue;
  const size_t smem = odelib::plan_smem(n_i, n_f);
  if (smem == 0) n_i = n_f = 0;
  const MhArgs a{pi, pf, theta0, walk, prior, state_in, state_out, th_rec,
                 chi_rec, rsq_rec, aic_rec, ar_rec, n_i, n_f, C, it_base,
                 it_end, rec0, seed, aic_const};
  const long long threads = (long long)C * MH_GROUP;
  const int grid = (int)((threads + MH_BLOCK - 1) / MH_BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void (*kernels[3][2][2])(const MhArgs) = {
      {{&mh_kernel<0, false, false>, &mh_kernel<0, false, true>},
       {&mh_kernel<0, true, false>, &mh_kernel<0, true, true>}},
      {{&mh_kernel<1, false, false>, &mh_kernel<1, false, true>},
       {&mh_kernel<1, true, false>, &mh_kernel<1, true, true>}},
      {{ODE_KV3((&mh_kernel<3, false, false>)),
        ODE_KV3((&mh_kernel<3, false, true>))},
       {ODE_KV3((&mh_kernel<3, true, false>)),
        ODE_KV3((&mh_kernel<3, true, true>))}}};
  const int row = stepper_row(stepper);
  if (row < 0) return (int)cudaErrorInvalidValue;
  void (*kernel)(const MhArgs) =
      kernels[row][prior != nullptr]
             [state_in != nullptr || state_out != nullptr];
  if (!kernel) return (int)cudaErrorInvalidValue;
  kernel<<<grid, MH_BLOCK, smem, s>>>(a);
  return (int)cudaGetLastError();
}

int odelib_probe(const float* x, int n, float* y, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  probe_kernel<<<(n + 127) / 128, 128, 0, s>>>(x, n, y);
  return (int)cudaGetLastError();
}

// The Tobit terms' device functions on n float32 z (common.cuh): log Phi
// (which = 0) or the Student-t log CDF with the constants nu .. kb
// (which = 1), one thread each; an accuracy probe, on no sampler's path.
int odelib_tobit(const float* z, int n, int which, double nu, double a,
                 double thresh, double ka, double kb, float* out,
                 void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tobit_kernel<<<(n + 127) / 128, 128, 0, s>>>(
      z, n, which, odelib::TCdf{nu, a, thresh, ka, kb}, out);
  return (int)cudaGetLastError();
}

#ifdef ODE_KVAERNO3
int odelib_kv3_quotient(const float* x, const float* d, float* q,
                        float* ref, float* flag, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kv3_quotient_kernel<<<(n + 255) / 256, 256, 0, s>>>(x, d, n, q, ref,
                                                      flag);
  return (int)cudaGetLastError();
}
#endif

const char* odelib_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
