"""Fused survey and Metropolis-Hastings: CUDA kernels and their torch twins.

Counterpart of the parts of ``odelib_tpu/ops/pallas_mh.py`` on the main
path: the static plan (``_StaticPlan``/``_normalize_substeps``/
``_build_plan``), the counter RNG (``_mix``/``_Rng``), the scorer
(``_make_scorer``, lognormal and uncensored) and the public
``survey_fused``, ``metropolis_hastings_fused`` and ``ensemble_fused``
with the JAX package's arguments and ``MHOutput``.

Each public function takes the device from its input: for a CUDA tensor it
launches its hand-written kernel (``csrc/mh.cu``, ``csrc/ensemble.cu``,
built by :mod:`.build`) or raises; for a CPU tensor it runs the plain
torch twin defined here. The
twin and the kernel perform the same float32 operations in the same order
as the Pallas kernel, and draw the same random words, so a chain's accept
sequence agrees with the JAX reference up to ulp-level ties of the math
library (``exp``/``log``/``cos``).
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..model import ModelSpec, ObsData, obsdata_from_arrays
from ..rhs import torch_evaluator, trace_rhs
from .runge_kutta import DP_C, FIXED_STEPPERS, const

_M32 = 0xFFFFFFFF
_SLOT_BUDGET = 1024

# Kernel launches per public wrapper (a run shows it went through the
# kernels by these counts; reset with ``reset_launch_counts``).
LAUNCHES = {"survey_fused": 0, "metropolis_hastings_fused": 0,
            "ensemble_fused": 0, "parallel_tempering_fused": 0,
            "joint_metropolis_hastings_fused": 0, "pmmh_fused": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# static plan
# --------------------------------------------------------------------------

class _StaticPlan(NamedTuple):
    """Everything the kernels need besides the RHS."""
    step_ts: tuple      # (t, h, gi) per sub-step; gi = grid index scored
    #                     after the step, or -1 mid-interval
    obs_after: tuple    # per grid index: ((members, log_ab, log_sig, ab),)
    sstot: float
    n_grid: int


def _normalize_substeps(substeps, n_intervals: int):
    """int -> uniform; sequence -> validated per-interval schedule."""
    if isinstance(substeps, (int, np.integer)):
        s = int(substeps)
        if s < 1:
            raise ValueError("substeps must be >= 1")
        return s
    sched = tuple(int(v) for v in np.asarray(substeps).ravel())
    if len(sched) != n_intervals:
        raise ValueError(
            f"substeps schedule must have {n_intervals} entries "
            f"(len(times)-1), got {len(sched)}")
    if any(v < 1 for v in sched):
        raise ValueError("substeps schedule entries must be >= 1")
    return sched


def _build_plan(spec: ModelSpec, obs: ObsData, times, substeps):
    if spec.obs_model != "lognormal" or obs.censor is not None:
        raise NotImplementedError(
            "the kernels score uncensored lognormal observations only "
            "(ROADMAP queue 1, item 13)")
    times = np.asarray(times, np.float64)
    t_index = np.asarray(obs.t_index)
    state_index = np.asarray(obs.state_index)
    log_ab = np.asarray(obs.log_abundance, np.float64)
    log_sig = np.asarray(obs.log_sigma, np.float64)
    abund = np.asarray(obs.abundance, np.float64)
    if spec.sum_matrix is not None:
        m = np.asarray(spec.sum_matrix)
        members = tuple(tuple(int(i) for i in np.where(m[:, j])[0])
                        for j in range(m.shape[1]))
    else:
        members = tuple((j,) for j in range(len(spec.snames)))
    obs_after = [[] for _ in range(len(times))]
    for o in range(len(log_ab)):
        if not np.isfinite(log_ab[o]):
            continue
        obs_after[int(t_index[o])].append(
            (members[int(state_index[o])], float(log_ab[o]),
             float(log_sig[o]), float(abund[o])))
    substeps = _normalize_substeps(substeps, len(times) - 1)
    step_ts = []
    for i in range(len(times) - 1):
        n_sub = substeps if isinstance(substeps, int) else substeps[i]
        h = (times[i + 1] - times[i]) / n_sub
        for s in range(n_sub):
            gi = (i + 1) if s == n_sub - 1 else -1
            step_ts.append((float(times[i] + s * h), float(h), gi))
    return _StaticPlan(step_ts=tuple(step_ts),
                       obs_after=tuple(tuple(x) for x in obs_after),
                       sstot=float(np.asarray(obs.sstot)),
                       n_grid=len(times))


_STEPPER_ID = {"dopri5": 0, "rk4": 1}
_EULER = 2  # header stepper id of the particle filter's step layout
_HDR = 16  # int header of plan_i (see csrc/common.cuh)


def _check_stepper(stepper):
    if stepper not in _STEPPER_ID:
        raise NotImplementedError(
            f"stepper={stepper!r}: the kernels run dopri5 and rk4 "
            "(kvaerno3: ROADMAP queue 1, item 14)")


def plan_tables(spec: ModelSpec, plan: _StaticPlan, y0_base, stepper: str):
    """The plan as two flat arrays the kernels read at run time:
    ``plan_i`` (int32: a 16-entry header of sizes and offsets, then the
    step grid indices, the per-grid-point observation CSR, the summation
    members and the init-parameter wiring) and ``plan_f`` (float32: sstot,
    then 8 floats per step, the per-observation constants and y0). Floats
    are rounded to float32 on the host exactly where the JAX kernel's
    Python scalars meet float32 arrays. ``stepper`` 'euler' lays each step
    out for the particle filter as (h, t, f32(sqrt h))."""
    if stepper != "euler":
        _check_stepper(stepper)
    n_steps, n_grid = len(plan.step_ts), plan.n_grid
    posts = sorted({mem for grid in plan.obs_after for mem, *_ in grid})
    post_id = {mem: k for k, mem in enumerate(posts)}
    obs = [o for grid in plan.obs_after for o in grid]
    obs_ptr = np.cumsum([0] + [len(g) for g in plan.obs_after])
    post_ptr = np.cumsum([0] + [len(m) for m in posts])
    ints = [np.asarray([gi for _, _, gi in plan.step_ts]),
            obs_ptr,
            np.asarray([post_id[mem] for mem, *_ in obs]),
            post_ptr,
            np.asarray([i for m in posts for i in m]),
            np.asarray(spec.init_pidx)]
    steps = np.zeros((n_steps, 8))
    for k, (t, h, _) in enumerate(plan.step_ts):
        if stepper == "dopri5":
            steps[k, :7] = [h] + [t + DP_C[i] * h for i in range(6)]
        elif stepper == "euler":
            steps[k, :3] = [h, t, float(np.sqrt(h))]
        else:
            steps[k, :6] = [h, 0.5 * h, h / 6.0, t, t + 0.5 * h, t + h]
    floats = [np.asarray([plan.sstot]), steps.ravel(),
              np.asarray([lab for _, lab, _, _ in obs]),
              np.asarray([2.0 * ls * ls for _, _, ls, _ in obs]),
              np.asarray([ab for _, _, _, ab in obs]),
              np.asarray(y0_base, np.float64)]
    offs_i = np.cumsum([_HDR] + [len(a) for a in ints])[:-1]
    offs_f = np.cumsum([0] + [len(a) for a in floats])[:-1]
    header = np.zeros(_HDR, np.int64)
    header[:5] = [n_steps, n_grid, len(obs), len(posts),
                  _STEPPER_ID.get(stepper, _EULER)]
    header[5:11] = offs_i
    header[11:15] = offs_f[1:5]
    header[15] = offs_f[5]
    plan_i = np.concatenate([header] + [np.asarray(a, np.int64)
                                        for a in ints]).astype(np.int32)
    plan_f = np.concatenate(floats).astype(np.float32)
    return plan_i, plan_f


# --------------------------------------------------------------------------
# counter RNG (torch twin; uint32 words held in int64)
# --------------------------------------------------------------------------

def mix(x):
    """SplitMix32 finalizer on uint32 values held in an int64 tensor. The
    low 32 bits of an int64 product are exact (torch CPU has no uint32
    ``+``/``>>``, so the twin works in int64 and masks)."""
    x = (x + 0x9E3779B9) & _M32
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def words(key, ctr: int):
    """The counter RNG's word ``mix(key ^ mix(ctr))`` for every key."""
    c = mix(torch.tensor(ctr & _M32, dtype=torch.int64, device=key.device))
    return mix(key ^ c)


def _unit(w):
    """(0, 1) uniform from the top 24 bits: (b24 + 1/2) * 2^-24."""
    b = (w >> 8).to(torch.int32).to(torch.float32)
    return b * const(1.0 / (1 << 24), b) + const(0.5 / (1 << 24), b)


def uniform_of(key, ctr: int):
    """(0, 1) uniform of counter ``ctr`` for every key."""
    return _unit(words(key, ctr))


class Rng:
    """Per-chain counter RNG, bit-identical to ``odelib_tpu``'s ``_Rng``:
    chain ``c`` keys on ``mix(seed * 0x9E3779B1 + c)`` (the tile drops
    out), and slot ``k`` of iteration ``it`` is
    ``mix(key ^ mix(it * 1024 + k))``."""

    def __init__(self, seed: int, chains: torch.Tensor):
        s = int(np.uint32(np.int64(seed) & _M32))
        self._key = mix((s * 0x9E3779B1 + chains.to(torch.int64)) & _M32)
        self._slot = 0

    def start(self, it: int):
        """Begin iteration ``it`` (slots restart at 0)."""
        self._it = int(it)
        self._slot = 0

    def bits(self):
        if self._slot >= _SLOT_BUDGET:
            raise ValueError(
                "per-iteration RNG slot budget (1024) exhausted — too many "
                "draw sites (walked parameters) for the fused kernel")
        self._slot += 1
        return words(self._key, self._it * 1024 + self._slot - 1)

    def uniform(self):
        """The next slot's (0, 1) uniform."""
        return _unit(self.bits())

    def normal(self):
        """Box-Muller, cos half only."""
        u1 = self.uniform()
        u2 = self.uniform()
        return torch.sqrt(const(-2.0, u1) * torch.log(u1)) * torch.cos(
            const(2.0 * math.pi, u2) * u2)


# --------------------------------------------------------------------------
# scorer and twins
# --------------------------------------------------------------------------

def obs_terms(obs_at, y, chi, ssres=None):
    """Add the lognormal chi terms (and, unless ``ssres`` is None, the
    squared residuals) of one grid point's observations ``obs_at`` for
    states ``y``; returns (chi, ssres)."""
    for mem, lab, lsig, ab in obs_at:
        pred = y[mem[0]]
        for m in mem[1:]:
            pred = pred + y[m]
        d = const(lab, pred) - torch.log(pred)
        chi = chi + (d * d) / const(2.0 * lsig * lsig, pred)
        if ssres is not None:
            e = pred - const(ab, pred)
            ssres = ssres + e * e
    return chi, ssres


def make_scorer(spec: ModelSpec, plan: _StaticPlan, y0_base, stepper: str):
    """``score(theta_list) -> (chi, rsq)``: the fixed-step solve over the
    plan's steps with the static per-observation terms, on a list of P
    per-slot float32 tensors."""
    y0_base = tuple(float(v) for v in np.asarray(y0_base))
    S, P = len(spec.snames), spec.theta_size
    f = torch_evaluator(spec.rhs, S, P)
    step = FIXED_STEPPERS[stepper]

    def contrib(y, gi, chi, ssres):
        return obs_terms(plan.obs_after[gi], y, chi, ssres)

    def score(theta):
        ref = theta[0]
        y = [theta[i] if i >= 0 else
             torch.full_like(ref, y0_base[s])
             for s, i in enumerate(spec.init_pidx)]
        chi = torch.zeros_like(ref)
        ssres = torch.zeros_like(ref)
        chi, ssres = contrib(y, 0, chi, ssres)
        for t, h, gi in plan.step_ts:
            y = step(f, t, y, h, theta)
            if gi >= 0:
                chi, ssres = contrib(y, gi, chi, ssres)
        rsq = const(1.0, ref) - ssres / const(plan.sstot, ref)
        return chi, rsq

    return score


def survey_plain(spec, plan, y0_base, thetas, stepper="dopri5"):
    """Twin of the survey kernel: ``thetas`` (P, N) float32 -> chi (N,)."""
    score = make_scorer(spec, plan, y0_base, stepper)
    return score(list(thetas))[0]


def mh_plain(spec, plan, y0_base, theta0, seed, *, nits, burnin, walk,
             walked, num, stepper="dopri5"):
    """Twin of the MH kernel: ``theta0`` (P, C) float32; returns the
    chain-minor records theta (R, P, C) and chi, rsq, aic, acceptance
    ratio (R, C), R = nits - 1 - burnin. ``walk`` is the per-slot walk
    scale ``rwalk_std * walk_mask`` and ``walked`` marks the slots that
    draw a normal (``walk_mask != 0``)."""
    score = make_scorer(spec, plan, y0_base, stepper)
    P, C = theta0.shape
    R = nits - 1 - burnin
    rng = Rng(seed, torch.arange(C, device=theta0.device))
    theta = list(theta0)
    chi, rsq = score(theta)
    lt = [torch.log(th) for th in theta]
    acc = torch.zeros_like(chi)
    recs = [torch.empty((R, P, C), dtype=torch.float32,
                        device=theta0.device)] + [
        torch.empty((R, C), dtype=torch.float32, device=theta0.device)
        for _ in range(4)]
    two, aic_c = const(2.0, chi), const(2.0 * num, chi)
    for it in range(1, nits):
        rng.start(it)
        prop = [lt[p] + const(walk[p], chi) * rng.normal()
                if walked[p] else lt[p] for p in range(P)]
        chi_new, rsq_new = score([torch.exp(v) for v in prop])
        u = rng.uniform()
        accept = torch.exp(chi - chi_new) > u   # NaN / -inf ratio rejects
        lt = [torch.where(accept, a, b) for a, b in zip(prop, lt)]
        chi = torch.where(accept, chi_new, chi)
        rsq = torch.where(accept, rsq_new, rsq)
        acc = acc + accept.to(torch.float32)
        r = it - 1 - burnin
        if r >= 0:
            recs[0][r] = torch.stack([torch.exp(v) for v in lt])
            recs[1][r] = chi
            recs[2][r] = rsq
            recs[3][r] = two * chi + aic_c
            recs[4][r] = acc / torch.full_like(acc, float(it))
    return tuple(recs)


def pick_tile_chains(C: int) -> int:
    """The JAX package's auto tile on one device (``odelib_tpu/ops/
    pallas_mh.py`` ``pick_tile_chains``), copied so that the same call
    gives the same ensembles: it is the ensemble size of
    ``ensemble_fused``, and so part of the result. Its rates were measured
    on a TPU; nothing here is tuned for the card."""
    C = max(1, C)
    best_t, best_score = 1024, 0.0
    for t, rate in ((4096, 192.0), (2048, 150.0), (1024, 125.0)):
        padded = -(-C // t) * t
        score = rate * C / padded
        if score > best_score:
            best_t, best_score = t, score
    return best_t


def ensemble_init(theta0, seed: int, tile: int, walk, init_jitter: float):
    """The walkers' start points on the host, as the JAX package makes
    them: ``np.random.default_rng(seed)`` jitters every walker's walked
    slots by ``exp(init_jitter * N(0, 1))``, then pads to a multiple of
    ``tile`` with jittered clones. ``theta0`` (W0, P) float32 ndarray ->
    (W, P) float32 ndarray."""
    W0 = theta0.shape[0]
    W = int(-(-W0 // tile) * tile)
    mask_row = np.asarray([1.0 if w != 0.0 else 0.0 for w in walk],
                          np.float32)
    rng = np.random.default_rng(seed)
    if init_jitter:
        theta0 = theta0 * np.exp(
            float(init_jitter) * mask_row[None, :]
            * rng.normal(size=theta0.shape)).astype(np.float32)
    if W > W0:
        reps = theta0[rng.integers(0, W0, W - W0)]
        reps = reps * np.exp(0.05 * mask_row[None, :]
                             * rng.normal(size=reps.shape)
                             ).astype(np.float32)
        theta0 = np.concatenate([theta0, reps], axis=0)
    return theta0


def ensemble_halves(W: int, tile: int, device):
    """Global indices of each half's walkers, ordered (ensemble, row, lane),
    and the (ensemble, row, lane) of each: the kernel's thread order."""
    half = tile // 256
    e, r, lane = torch.meshgrid(
        torch.arange(W // tile, device=device),
        torch.arange(half, device=device),
        torch.arange(128, device=device), indexing="ij")
    e, r, lane = e.reshape(-1), r.reshape(-1), lane.reshape(-1)
    return [(e * tile + (lo + r) * 128 + lane, e, r, lane)
            for lo in (0, half)]


def ensemble_plain(spec, plan, y0_base, theta0, seed, *, tile, nits, burnin,
                   a, walk, walked, num, W0, stepper="dopri5"):
    """Twin of the ensemble kernel: ``theta0`` (P, W) float32 walkers (W a
    multiple of ``tile``); returns the records of the first ``W0`` walkers,
    theta (R, P, W0) and chi, rsq, aic, acceptance ratio (R, W0),
    R = nits - 1 - burnin. ``walk`` is the per-slot walk mask and
    ``walked`` marks its non-zero slots."""
    score = make_scorer(spec, plan, y0_base, stepper)
    P, W = theta0.shape
    dev = theta0.device
    R = nits - 1 - burnin
    half = tile // 256
    n_walked = sum(walked)
    s = int(np.uint32(np.int64(seed) & _M32))
    halves = ensemble_halves(W, tile, dev)
    scal_base = mix((s * 0x7FEB352D + torch.arange(W // tile, device=dev)
                     * tile + 0xE75) & _M32)
    rng = Rng(seed, torch.arange(W, device=dev))
    chi, rsq = score(list(theta0))
    lt = [torch.log(th) for th in theta0]
    acc = torch.zeros_like(chi)
    one, am1, a_c = (const(v, chi) for v in (1.0, a - 1.0, a))
    nw1 = const(float(n_walked - 1), chi)
    wc = [const(w, chi) for w in walk]
    recs = [torch.empty((R, P, W0), dtype=torch.float32, device=dev)] + [
        torch.empty((R, W0), dtype=torch.float32, device=dev)
        for _ in range(4)]
    two, aic_c = const(2.0, chi), const(2.0 * num, chi)
    for it in range(1, nits):
        rng.start(it)
        draws = [rng.uniform() for _ in range(4)]   # slots 0-3, all walkers
        for hb, (idx, e, r, lane) in enumerate(halves):
            sbits = mix(scal_base ^ mix(torch.tensor(
                it * 2 + hb, dtype=torch.int64, device=dev)))
            r_sub = (sbits % max(half, 1))[e]
            r_lane = ((sbits >> 8) % 128)[e]
            comp = half - (half if hb else 0)
            pidx = e * tile + (comp + (r - r_sub) % half) * 128 \
                + (lane - r_lane) % 128
            u, uacc = draws[2 * hb][idx], draws[2 * hb + 1][idx]
            t = one + am1 * u
            z = (t * t) / a_c
            omz = one - z
            cur = [v[idx] for v in lt]
            prop = [c + (omz * (v[pidx] - c)) * wc[p] if walked[p] else c
                    for p, (c, v) in enumerate(zip(cur, lt))]
            chi_new, rsq_new = score([torch.exp(v) for v in prop])
            log_ratio = (nw1 * torch.log(z) + chi[idx]) - chi_new
            accept = torch.exp(log_ratio) > uacc   # NaN / -inf rejects
            for p in range(P):
                lt[p][idx] = torch.where(accept, prop[p], cur[p])
            chi[idx] = torch.where(accept, chi_new, chi[idx])
            rsq[idx] = torch.where(accept, rsq_new, rsq[idx])
            acc[idx] = acc[idx] + accept.to(torch.float32)
        r = it - 1 - burnin
        if r >= 0:
            recs[0][r] = torch.stack([torch.exp(v[:W0]) for v in lt])
            recs[1][r] = chi[:W0]
            recs[2][r] = rsq[:W0]
            recs[3][r] = two * chi[:W0] + aic_c
            recs[4][r] = acc[:W0] / torch.full_like(acc[:W0], float(it))
    return tuple(recs)


# --------------------------------------------------------------------------
# public wrappers
# --------------------------------------------------------------------------

def _as_f32_tensor(x):
    """A tensor keeps its device; an array becomes a CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32))


def _check_unported(priors, checkpoint_every, checkpoint_path,
                    resume_from, mesh):
    """Raise for the fused kernels' options that are not ported yet."""
    if priors is not None and any(d is not None for d in priors):
        raise NotImplementedError(
            "in-kernel priors are not ported yet (ROADMAP queue 1, item 12)")
    if checkpoint_every is not None or resume_from is not None \
            or checkpoint_path is not None:
        raise NotImplementedError(
            "chunked checkpoint/resume is not ported yet (ROADMAP queue 1, "
            "item 11)")
    if mesh is not None:
        raise NotImplementedError(
            "multi-GPU chain split is not ported yet (ROADMAP queue 1, "
            "item 18)")


def _check_cuda(spec, t: torch.Tensor):
    if t.device.type != "cuda":
        return False
    # raises RhsTraceError for an RHS the kernels cannot compile
    trace_rhs(spec.rhs, len(spec.snames), spec.theta_size)
    return True


@lru_cache(maxsize=64)
def _device_plan(spec, plan, y0_key, stepper, device):
    """The plan tables on ``device`` (cached per model, plan and y0)."""
    plan_i, plan_f = plan_tables(spec, plan, y0_key, stepper)
    return (torch.as_tensor(plan_i, device=device),
            torch.as_tensor(plan_f, device=device))


def survey_launcher(spec, plan, y0_base, stepper, th):
    """Prepare the survey kernel for draws ``th`` (P, N) on the card and
    return ``launch() -> chi (N,)``; each call launches the kernel once
    (and counts it)."""
    from . import build
    lib = build.load_kernels(spec)
    dev = th.device
    plan_i, plan_f = _device_plan(spec, plan, _key(y0_base), stepper,
                                  str(dev))
    N = th.shape[1]
    chi = torch.empty(N, dtype=torch.float32, device=dev)
    args = (plan_i.data_ptr(), plan_f.data_ptr(), th.data_ptr(),
            chi.data_ptr(), N, _STEPPER_ID[stepper], build.stream(dev))

    def launch():
        build.check(lib, lib.odelib_survey(*args), "survey")
        LAUNCHES["survey_fused"] += 1
        return chi
    return launch


def mh_launcher(spec, plan, y0_base, stepper, th0, seed, *, nits, burnin,
                walk, walked, num):
    """Prepare the MH kernel for chains ``th0`` (P, C) on the card and
    return ``launch() -> records`` (theta (R, P, C); chi, rsq, aic,
    acceptance ratio (R, C)); each call launches the kernel once (and
    counts it)."""
    from . import build
    lib = build.load_kernels(spec)
    dev = th0.device
    P, C = th0.shape
    R = nits - 1 - burnin
    plan_i, plan_f = _device_plan(spec, plan, _key(y0_base), stepper,
                                  str(dev))
    # per slot: the walk scale, then the walked flag
    walk_t = torch.as_tensor(np.asarray(
        walk + tuple(float(w) for w in walked), np.float32), device=dev)
    recs = (torch.empty((R, P, C), dtype=torch.float32, device=dev),) \
        + tuple(torch.empty((R, C), dtype=torch.float32, device=dev)
                for _ in range(4))
    args = (plan_i.data_ptr(), plan_f.data_ptr(), th0.data_ptr(),
            walk_t.data_ptr(), *(r.data_ptr() for r in recs), C, int(nits),
            int(burnin), int(np.uint32(np.int64(seed) & _M32)),
            float(np.float32(2.0 * num)), _STEPPER_ID[stepper],
            build.stream(dev))

    def launch():
        build.check(lib, lib.odelib_mh(*args), "mh")
        LAUNCHES["metropolis_hastings_fused"] += 1
        return recs
    launch.keep = walk_t        # alive as long as the launcher
    return launch


def ensemble_launcher(spec, plan, y0_base, stepper, th0, seed, *, tile,
                      nits, burnin, a, walk, walked, num, W0):
    """Prepare the ensemble kernels for walkers ``th0`` (P, W) on the card
    and return ``launch() -> records`` (theta (R, P, W0); chi, rsq, aic,
    acceptance ratio (R, W0)). Each call launches 1 + 2 (nits - 1)
    kernels, one per half-update, and counts once."""
    from . import build
    lib = build.load_kernels(spec)
    dev = th0.device
    P, W = th0.shape
    R = nits - 1 - burnin
    plan_i, plan_f = _device_plan(spec, plan, _key(y0_base), stepper,
                                  str(dev))
    # per slot: the walk mask value, then the walked flag
    walk_t = torch.as_tensor(np.asarray(
        tuple(walk) + tuple(float(w) for w in walked), np.float32),
        device=dev)
    state = torch.empty((P + 3, W), dtype=torch.float32, device=dev)
    recs = (torch.empty((R, P, W0), dtype=torch.float32, device=dev),) \
        + tuple(torch.empty((R, W0), dtype=torch.float32, device=dev)
                for _ in range(4))
    # a - 1, a, n_walked - 1 and the AIC term, rounded as JAX rounds them
    consts = (float(np.float32(v)) for v in (a - 1.0, a, sum(walked) - 1,
                                             2.0 * num))
    args = (plan_i.data_ptr(), plan_f.data_ptr(), th0.data_ptr(),
            walk_t.data_ptr(), state.data_ptr(),
            *(r.data_ptr() for r in recs), W, W0, int(tile), int(nits),
            int(burnin), int(np.uint32(np.int64(seed) & _M32)), *consts,
            _STEPPER_ID[stepper], build.stream(dev))

    def launch():
        build.check(lib, lib.odelib_ensemble(*args), "ensemble")
        LAUNCHES["ensemble_fused"] += 1
        return recs
    launch.keep = (walk_t, state)   # alive as long as the launcher
    return launch


def _key(y0_base):
    return tuple(float(v) for v in np.asarray(y0_base, np.float64))


def survey_fused(spec: ModelSpec, obs: ObsData, times, y0_base, thetas, *,
                 substeps: int = 4, stepper: str = "dopri5",
                 tile_chains: Optional[int] = None, interpret: bool = False):
    """Chi of N parameter draws in one kernel launch (the fused survey).

    ``thetas`` is (N, P) flat slots; a CUDA tensor launches the survey
    kernel, a CPU one runs its twin. Returns chi (N,) float32 on the
    input's device. ``tile_chains``/``interpret`` are the JAX signature's
    and are ignored (the CUDA grid covers N exactly)."""
    _check_stepper(stepper)
    thetas = _as_f32_tensor(thetas)
    N, P = thetas.shape
    if P != spec.theta_size:
        raise ValueError(f"thetas must have {spec.theta_size} columns")
    substeps = _normalize_substeps(substeps, len(np.asarray(times)) - 1)
    plan = _build_plan(spec, obs, times, substeps)
    th = thetas.t().contiguous()
    if not _check_cuda(spec, th):
        return survey_plain(spec, plan, y0_base, th, stepper)
    return survey_launcher(spec, plan, y0_base, stepper, th)()


def metropolis_hastings_fused(
        spec: ModelSpec, obs: ObsData, times, y0_base, theta0, seed: int, *,
        nits: int = 1000, burnin: Optional[int] = None,
        walk_mask: Optional[Sequence[float]] = None, rwalk_std: float = 0.05,
        substeps: int = 4, stepper: str = "dopri5",
        tile_chains: Optional[int] = None, interpret: bool = False,
        mesh=None, priors=None, checkpoint_every: Optional[int] = None,
        checkpoint_path: Optional[str] = None,
        resume_from: Optional[str] = None, config_token: str = ""):
    """Run C chains of reference-semantics MH in one kernel launch.

    ``theta0`` is (C, P) float32; a CUDA tensor launches the MH kernel,
    a CPU one runs its twin. Returns ``MHOutput`` with theta (C, R, P) and
    chi, rsquared, aic, acceptance_ratio (C, R), R = nits - 1 - burnin, and
    iteration (R,).
    Chain c keys its RNG on its global index c, as in the JAX kernel, so
    no padding is needed. ``tile_chains``/``interpret``/``config_token``
    are accepted and ignored; in-kernel priors, checkpointing and meshes
    are not ported yet and raise ``NotImplementedError``."""
    from ..samplers.mh import MHOutput
    _check_unported(priors, checkpoint_every, checkpoint_path, resume_from,
                    mesh)
    _check_stepper(stepper)
    if burnin is None:
        burnin = int(nits / 2)
    R = nits - 1 - burnin
    if R <= 0:
        raise ValueError(f"nits={nits} leaves no recorded iterations after "
                         f"burnin={burnin}")
    theta0 = _as_f32_tensor(theta0)
    C, P = theta0.shape
    if P != spec.theta_size:
        raise ValueError(f"theta0 must have {spec.theta_size} columns")
    num = int(torch.count_nonzero(theta0[0]))
    if walk_mask is None:
        walk_mask = [1.0] * P
    walked = tuple(float(w) != 0.0 for w in walk_mask)
    walk = tuple(float(rwalk_std) * float(w) for w in walk_mask)
    n_walked = sum(walked)
    if 2 * n_walked + 1 > _SLOT_BUDGET:
        raise ValueError(
            "per-iteration RNG slot budget (1024) exhausted — too many "
            "draw sites (walked parameters) for the fused kernel")
    substeps = _normalize_substeps(substeps, len(np.asarray(times)) - 1)
    plan = _build_plan(spec, obs, times, substeps)
    th0 = theta0.t().contiguous()
    iteration = torch.arange(1, nits, device=theta0.device)[burnin:]
    if not _check_cuda(spec, th0):
        recs = mh_plain(spec, plan, y0_base, th0, seed, nits=nits,
                        burnin=burnin, walk=walk, walked=walked, num=num,
                        stepper=stepper)
    else:
        recs = mh_launcher(spec, plan, y0_base, stepper, th0, seed,
                           nits=nits, burnin=burnin, walk=walk,
                           walked=walked, num=num)()
    th_r, chi_r, rsq_r, aic_r, ar_r = recs
    return MHOutput(theta=th_r.permute(2, 0, 1), chi=chi_r.t(),
                    rsquared=rsq_r.t(), aic=aic_r.t(),
                    acceptance_ratio=ar_r.t(), iteration=iteration)


def ensemble_fused(
        spec: ModelSpec, obs: ObsData, times, y0_base, theta0, seed: int, *,
        nits: int = 1000, burnin: Optional[int] = None, a: float = 2.0,
        walk_mask: Optional[Sequence[float]] = None,
        substeps: int = 4, stepper: str = "dopri5",
        tile_chains: Optional[int] = None, interpret: bool = False,
        mesh=None, priors=None, init_jitter: float = 0.01,
        checkpoint_every: Optional[int] = None,
        checkpoint_path: Optional[str] = None,
        resume_from: Optional[str] = None, config_token: str = ""):
    """Affine-invariant ensemble sampler (Goodman-Weare stretch moves).

    ``theta0`` is (W0, P) float32 walkers; a CUDA tensor launches the
    ensemble kernels, a CPU one runs their twin. Walkers are jittered and
    padded on the host exactly as in the JAX package (:func:`ensemble_init`),
    to W, a multiple of ``tile_chains``; every ``tile_chains`` walkers are
    one independent ensemble, so the tile is part of the result (default:
    :func:`pick_tile_chains`, the JAX rule; any multiple of 256). Returns
    ``MHOutput`` for the first W0 walkers, as
    :func:`metropolis_hastings_fused`. ``interpret``/``config_token`` are
    accepted and ignored; in-kernel priors, checkpointing and meshes are
    not ported yet and raise ``NotImplementedError``."""
    from ..samplers.mh import MHOutput
    _check_unported(priors, checkpoint_every, checkpoint_path, resume_from,
                    mesh)
    _check_stepper(stepper)
    if burnin is None:
        burnin = int(nits / 2)
    P = spec.theta_size
    if a <= 1.0:
        raise ValueError(f"stretch scale a must exceed 1, got {a}")
    dev = theta0.device if isinstance(theta0, torch.Tensor) \
        else torch.device("cpu")
    th_np = _as_f32_tensor(theta0).cpu().numpy()
    W0 = th_np.shape[0]
    if th_np.shape[1] != P:
        raise ValueError(f"theta0 must have {P} columns")
    tile = int(tile_chains if tile_chains is not None
               else pick_tile_chains(W0))
    if tile <= 0 or tile % 256:
        raise ValueError("tile_chains must be a positive multiple of 256 "
                         "(two halves of 128-lane rows per ensemble)")
    if nits - 1 <= burnin:
        raise ValueError(f"nits={nits} leaves no recorded iterations after "
                         f"burnin={burnin}")
    num = int(np.count_nonzero(th_np[0]))
    if walk_mask is None:
        walk_mask = [1.0] * P
    walk = tuple(float(w) for w in walk_mask)
    walked = tuple(w != 0.0 for w in walk)
    th_np = ensemble_init(th_np, seed, tile, walk, init_jitter)
    substeps = _normalize_substeps(substeps, len(np.asarray(times)) - 1)
    plan = _build_plan(spec, obs, times, substeps)
    th0 = torch.as_tensor(np.ascontiguousarray(th_np.T), device=dev)
    iteration = torch.arange(1, nits, device=dev)[burnin:]
    kw = dict(tile=tile, nits=nits, burnin=burnin, a=float(a), walk=walk,
              walked=walked, num=num, W0=W0)
    if not _check_cuda(spec, th0):
        recs = ensemble_plain(spec, plan, y0_base, th0, seed,
                              stepper=stepper, **kw)
    else:
        recs = ensemble_launcher(spec, plan, y0_base, stepper, th0, seed,
                                 **kw)()
    th_r, chi_r, rsq_r, aic_r, ar_r = recs
    return MHOutput(theta=th_r.permute(2, 0, 1), chi=chi_r.t(),
                    rsquared=rsq_r.t(), aic=aic_r.t(),
                    acceptance_ratio=ar_r.t(), iteration=iteration)


def inputs_from_reference(obs, theta0, seed, y0):
    """The port's inputs from the JAX package's host objects: ``obs`` with
    the ``ObsData`` field names (numpy), theta0 (C, P) float32 (chains,
    walkers or ladder seeds: the ensemble's jitter and padding happen
    inside both packages' ``ensemble_fused`` from the same seed, and a
    temperature ladder is a plain tuple), the kernel seed and y0. Reads
    plain numpy only. Returns (ObsData, theta0 CPU tensor, seed, y0
    ndarray); move the tensor to run on the card."""
    th = _as_f32_tensor(theta0)
    return (obsdata_from_arrays(obs), th, int(seed),
            np.asarray(y0, np.float64))
