"""Fused survey and Metropolis-Hastings: CUDA kernels and their torch twins.

Counterpart of the parts of ``odelib_tpu/ops/pallas_mh.py`` on the main
path: the static plan (``_StaticPlan``/``_normalize_substeps``/
``_build_plan``), the counter RNG (``_mix``/``_Rng``), the scorer
(``_make_scorer``: every observation model, Tobit terms for censored
log-space data, bolus doses) and the public
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

import ctypes
import math
from functools import lru_cache
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..model import (ModelSpec, ObsData, device_tensor, forcing_rows,
                     obsdata_from_arrays, rhs_program, spec_columns)
from ..rhs import jacobian_evaluator, torch_evaluator
from . import chunked
from .priors import checked_priors, logprior_plain
from .runge_kutta import (DP_C, FIXED_STEPPERS, KV3_C, KV3_GAMMA, const,
                          kvaerno3_fixed_step)

_M32 = 0xFFFFFFFF
_SLOT_BUDGET = 1024

# Kernel launches per public wrapper (a run shows it went through the
# kernels by these counts; reset with ``reset_launch_counts``).
LAUNCHES = {"survey_fused": 0, "metropolis_hastings_fused": 0,
            "ensemble_fused": 0, "parallel_tempering_fused": 0,
            "joint_metropolis_hastings_fused": 0, "pmmh_fused": 0}


def reset_launch_counts():
    """Zero every wrapper's launch count, the device probe's too."""
    from . import build
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    build.PROBE_LAUNCHES["device_probe"] = 0


# --------------------------------------------------------------------------
# static plan
# --------------------------------------------------------------------------

class _StaticPlan(NamedTuple):
    """Everything the kernels need besides the RHS."""
    step_ts: tuple      # (t, h, gi) per sub-step; gi = grid index scored
    #                     after the step, or -1 mid-interval
    obs_after: tuple    # per grid index: ((members, log_ab, log_sig, ab,
    #                     censor flag),)
    sstot: float
    n_grid: int
    dose_after: tuple = ()   # per grid index: ((raw state, amount),)
    obs_model: str = "lognormal"
    obs_param: float = 0.0


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
    times = np.asarray(times, np.float64)
    t_index = np.asarray(obs.t_index)
    state_index = np.asarray(obs.state_index)
    log_ab = np.asarray(obs.log_abundance, np.float64)
    log_sig = np.asarray(obs.log_sigma, np.float64)
    abund = np.asarray(obs.abundance, np.float64)
    censor = (np.zeros(len(log_ab), np.int32) if obs.censor is None
              else np.asarray(obs.censor, np.int32))
    if censor.any() and spec.obs_model not in ("lognormal", "student_t"):
        # the -log CDF of a count model needs an incomplete gamma or beta
        # at a data-dependent order; the reference scores such data on its
        # XLA samplers, which are not ported yet (ROADMAP queue 1, items 8
        # and 15)
        raise ValueError(
            "the fused kernel scores censored observations for "
            "obs_model='lognormal' and 'student_t' only; censored "
            f"{spec.obs_model!r} data runs on the XLA samplers, not ported "
            "yet (ROADMAP queue 1, items 8 and 15)")
    if spec.sum_matrix is not None:
        m = np.asarray(spec.sum_matrix)
        members = tuple(tuple(int(i) for i in np.where(m[:, j])[0])
                        for j in range(m.shape[1]))
    else:
        members = tuple((j,) for j in range(len(spec.snames)))
    # drop what the likelihood masks out: an invalid log abundance for the
    # log-space models, an invalid abundance for the count models (where
    # O = 0, log O = -inf, is a valid count)
    keep = np.isfinite(abund) if spec.obs_model in ("poisson", "negbinom") \
        else np.isfinite(log_ab)
    obs_after = [[] for _ in range(len(times))]
    for o in range(len(log_ab)):
        if not keep[o]:
            continue
        obs_after[int(t_index[o])].append(
            (members[int(state_index[o])], float(log_ab[o]),
             float(log_sig[o]), float(abund[o]), int(censor[o])))
    dose_after = [[] for _ in range(len(times))]
    for t, s, amt in spec.dose_events or ():
        dose_after[int(np.argmin(np.abs(times - t)))].append(
            (int(s), float(amt)))
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
                       n_grid=len(times),
                       dose_after=tuple(tuple(x) for x in dose_after),
                       obs_model=spec.obs_model,
                       obs_param=float(spec.obs_param))


def plan_doses(plan: _StaticPlan, gi: int):
    """The doses leaving grid point ``gi`` as ((raw state, amount),) with
    one entry per state, the amounts summed in double and each state in
    ascending order (the JAX kernel's ``apply_dose``)."""
    adds = {}
    for s, amt in plan.dose_after[gi] if plan.dose_after else ():
        adds[s] = adds.get(s, 0.0) + amt
    return tuple((s, adds[s]) for s in sorted(adds) if adds[s] != 0.0)


def scoring(plan: _StaticPlan):
    """What the kernels compile in for a plan's model: (observation
    model, its parameter, whether any observation is censored, whether
    any dose is given). ``ops/build.py`` writes it into the generated
    header, so each kernel compiles one scoring branch."""
    return (plan.obs_model, float(plan.obs_param),
            any(o[4] for grid in plan.obs_after for o in grid),
            any(plan_doses(plan, gi) for gi in range(plan.n_grid)))


# the fixed steppers' ids (csrc/common.cuh STEP_*)
_STEPPER_ID = {"dopri5": 0, "rk4": 1, "kvaerno3": 3}
_EULER = 2  # header stepper id of the particle filter's step layout
_HDR = 20  # int header of plan_i (see csrc/common.cuh)
# each stepper's distinct stage offsets c (stage time t + c h): one row of
# the forcing table per offset and step (csrc/common.cuh forc_rows). RK4's
# two middle stages share t + h/2, Kvaerno3's last two t + h.
STAGE_C = {"dopri5": DP_C[:6], "rk4": (0.0, 0.5, 1.0),
           "kvaerno3": (0.0, KV3_C[1], 1.0), "euler": (0.0,)}


def stage_time(t: float, h: float, c: float) -> float:
    """A stage's time as the steppers compute it: t + c h in double (t
    itself at c = 0)."""
    return t if c == 0.0 else t + c * h


@lru_cache(maxsize=64)
def forcing_table(spec: ModelSpec, plan: "_StaticPlan", stepper: str):
    """(n_steps, len(STAGE_C[stepper]), F) float32: every forcing column
    (:func:`~odelib_tpu_torch.model.spec_columns`) at every distinct stage
    time of every step, folded in double at the time in double and rounded
    to float32 once (the JAX kernel's Python floats, where they meet a
    tile). F is 0 for an unforced model."""
    cs = STAGE_C[stepper]
    F = len(spec_columns(spec))
    if not F:
        return np.zeros((len(plan.step_ts), len(cs), 0), np.float32)
    times = [stage_time(t, h, c) for t, h, _ in plan.step_ts for c in cs]
    return forcing_rows(spec, times).astype(np.float32).reshape(
        len(plan.step_ts), len(cs), F)


def stage_forcings(spec: ModelSpec, plan, stepper: str, device=None):
    """Per step, the forcing values each stage time reads, as the twins'
    steppers ask for them: ``{stage time: {column: float32 tensor}}`` (the
    rows of :func:`forcing_table`); None for an unforced model."""
    cols = spec_columns(spec)
    if not cols:
        return None
    tab = torch.as_tensor(forcing_table(spec, plan, stepper), device=device)
    return [{stage_time(t, h, c): dict(zip(cols, tab[k, r]))
             for r, c in enumerate(STAGE_C[stepper])}
            for k, (t, h, _) in enumerate(plan.step_ts)]


def with_forcings(f, at):
    """``f(t, y, ps)`` reading the forcing values of its stage time from
    ``at`` (one step's :func:`stage_forcings`), or ``f`` itself."""
    if at is None:
        return f
    return lambda t, y, ps: f(t, y, ps, at[t])


def mask_words(n_states: int) -> int:
    """Words of an observation's member mask (``csrc/common.cuh``
    ``mask_words``): one for a model of at most 32 states, else one per
    32 states."""
    return 1 if n_states <= 32 else -(-n_states // 32)


def member_mask(members, n_states: int):
    """An observation's member mask as :func:`mask_words` int32 words,
    bit ``s % 32`` of word ``s // 32`` for state ``s``."""
    out = [0] * mask_words(n_states)
    for m in members:
        out[m // 32] |= 1 << (m % 32)
    return [w - (1 << 32) if w >= 1 << 31 else w for w in out]


def _check_stepper(stepper, allowed=tuple(_STEPPER_ID)):
    if stepper not in allowed:
        raise ValueError(f"stepper={stepper!r}: the kernels run "
                         f"{', '.join(allowed)}")


def plan_tables(spec: ModelSpec, plan: _StaticPlan, y0_base, stepper: str):
    """The plan as two flat arrays the kernels read at run time:
    ``plan_i`` (int32: a 19-entry header of sizes and offsets, then the
    per-observation censor flags, the per-grid-point dose CSR and each
    dose's state, the step grid indices, each step's range of
    observations, the per-grid-point observation CSR, each observation's
    member mask (:func:`member_mask`) and the init-parameter wiring) and
    ``plan_f`` (float32: sstot, each observation's log sigma, the dose
    amounts, then 8 floats per step, the per-observation constants, y0
    and the forcing table of :func:`forcing_table`, step-major). The
    tables added with censoring and doses come first and the forcing
    table last, so the others keep the places they had. Floats are
    rounded to float32 on the host exactly where the JAX kernel's Python
    scalars meet float32 arrays (a grid point's doses of
    one state summed in double first). A step's 8 floats are, for
    'dopri5', h and its stage times; 'rk4' h, h/2, h/6 and its times;
    'kvaerno3' h, h gamma and the times of its four stages; 'euler' (the
    particle filter) h, t, f32(sqrt h) and f32(h / 2), the Milstein
    term's factor."""
    if stepper != "euler":
        _check_stepper(stepper)
    n_steps, n_grid = len(plan.step_ts), plan.n_grid
    obs = [o for grid in plan.obs_after for o in grid]
    obs_ptr = np.cumsum([0] + [len(g) for g in plan.obs_after])
    step_obs = [(obs_ptr[gi], obs_ptr[gi + 1]) if gi >= 0 else (0, 0)
                for _, _, gi in plan.step_ts]
    doses = [plan_doses(plan, gi) for gi in range(n_grid)]
    ints = [np.asarray([o[4] for o in obs]),
            np.cumsum([0] + [len(d) for d in doses]),
            np.asarray([s for d in doses for s, _ in d]),
            np.asarray([gi for _, _, gi in plan.step_ts]),
            np.asarray(step_obs).ravel(),
            obs_ptr,
            np.asarray([w for o in obs
                        for w in member_mask(o[0], len(spec.snames))]),
            np.asarray(spec.init_pidx)]
    steps = np.zeros((n_steps, 8))
    forc = forcing_table(spec, plan, stepper)
    for k, (t, h, _) in enumerate(plan.step_ts):
        if stepper == "dopri5":
            steps[k, :7] = [h] + [t + DP_C[i] * h for i in range(6)]
        elif stepper == "euler":
            steps[k, :4] = [h, t, float(np.sqrt(h)), 0.5 * h]
        elif stepper == "kvaerno3":
            steps[k, :6] = [h, h * KV3_GAMMA] + [t + c * h for c in KV3_C]
        else:
            steps[k, :6] = [h, 0.5 * h, h / 6.0, t, t + 0.5 * h, t + h]
    floats = [np.asarray([plan.sstot]),
              np.asarray([o[2] for o in obs]),
              np.asarray([a for d in doses for _, a in d]),
              steps.ravel(),
              np.asarray([o[1] for o in obs]),
              np.asarray([2.0 * o[2] * o[2] for o in obs]),
              np.asarray([o[3] for o in obs]),
              np.asarray(y0_base, np.float64),
              forc.ravel()]
    offs_i = np.cumsum([_HDR] + [len(a) for a in ints])[:-1]
    offs_f = np.cumsum([0] + [len(a) for a in floats])[:-1]
    header = np.zeros(_HDR, np.int64)
    header[:4] = [n_steps, n_grid, len(obs), _STEPPER_ID.get(stepper, _EULER)]
    header[4:9] = offs_i[3:]
    header[9:14] = offs_f[3:8]
    header[14:17] = offs_i[:3]
    header[17:19] = offs_f[1:3]
    header[19] = offs_f[8]
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

# The Tobit terms are computed in double and rounded to float32 once: in
# float32 the upper tail of the t log-CDF loses ~1.5e-5 relative at
# nu = 100 (the a log x term of ~60 nats carries the rounding of u = z^2/nu
# a = nu/2 times over), above the 1e-5 the port holds it to.
_RSQRT2 = 0.7071067811865476
_CF_EPS, _CF_MAXIT, _CF_FPMIN = 1e-10, 300, 1e-300


def t_constants(nu: float):
    """The constants of the Student-t log CDF with ``nu`` dof
    (:func:`t_logcdf`), in double: a = nu/2, the continued fraction's
    switch (a + 1)/(a + 5/2), and the two branches' constant terms
    -log a - log B(a, 1/2) - log 2 and -log(1/2) - log B(a, 1/2)."""
    a = 0.5 * float(nu)
    lbeta = math.lgamma(a) + math.lgamma(0.5) - math.lgamma(a + 0.5)
    return {"nu": float(nu), "a": a, "thresh": (a + 1.0) / (a + 2.5),
            "ka": -math.log(a) - lbeta - math.log(2.0),
            "kb": -math.log(0.5) - lbeta}


def betacf(a: float, b: float, x):
    """The continued fraction of the regularized incomplete beta by
    modified Lentz (Numerical Recipes ``betacf``), elementwise on a
    float64 ``x``, each element iterating until its last factor is within
    1e-10 of 1 (at most 300 times): ``common.cuh`` ``betacf``'s
    operations in its order (divisors as tensors: torch's CUDA division
    by a Python scalar multiplies by its reciprocal). Valid for
    x < (a + 1)/(a + b + 2)."""
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    one = const(1.0, x)

    def tiny(v):
        return torch.where(torch.abs(v) < _CF_FPMIN, _CF_FPMIN, v)
    c = torch.ones_like(x)
    d = one / tiny(one - (qab * x) / const(qap, x))
    h = d
    done = torch.zeros_like(x, dtype=torch.bool)
    for m in range(1, _CF_MAXIT + 1):
        aa = (m * (b - m) * x) / const((qam + 2 * m) * (a + 2 * m), x)
        d1 = one / tiny(one + aa * d)
        c1 = tiny(one + aa / c)
        h1 = h * (d1 * c1)
        aa = (-(a + m) * (qab + m) * x) / const((a + 2 * m) * (qap + 2 * m),
                                               x)
        d2 = one / tiny(one + aa * d1)
        c2 = tiny(one + aa / c1)
        dl = d2 * c2
        h = torch.where(done, h, h1 * dl)
        d = torch.where(done, d, d2)
        c = torch.where(done, c, c2)
        done = done | (torch.abs(dl - one) < _CF_EPS)
        if bool(done.all()):
            break
    return h


def t_logcdf(z, tc):
    """log T_nu(z) of float32 ``z`` with the constants ``tc`` of
    :func:`t_constants`, computed in double and returned in float32
    (``common.cuh`` ``t_logcdf``): with u = z^2/nu, x = 1/(1 + u),
    log x = -log1p(u) and log(1 - x) = -log1p(1/u); below the switch
    log(I_x(a, 1/2)/2) by the direct continued fraction, above it by the
    symmetry I_x(a, b) = 1 - I_{1-x}(b, a); T = I_x/2 for z < 0,
    1 - I_x/2 otherwise. A NaN z is returned as it is, without the
    fraction (the kernel's early return); z = +-inf gives 0 and -inf."""
    nan = torch.isnan(z)
    zd = torch.where(nan, torch.zeros_like(z), z).to(torch.float64)
    a, one = tc["a"], const(1.0, zd)
    u = (zd * zd) / const(tc["nu"], zd)
    x = one / (one + u)
    lx = -torch.log1p(u)
    lomx = -torch.log1p(one / u)
    direct = x < tc["thresh"]
    # each branch on its own side (the other side's lanes take x = 0)
    xa = torch.where(direct, x, torch.zeros_like(x))
    log_a = ((a * lx + 0.5 * lomx) + tc["ka"]) \
        + torch.log(betacf(a, 0.5, xa))
    omx = torch.where(direct, torch.zeros_like(x), u / (one + u))
    J = torch.exp((0.5 * lomx + a * lx) + tc["kb"]) * betacf(0.5, a, omx)
    log_b = torch.log(0.5 * (1.0 - J))
    log_half = torch.where(direct, log_a, log_b)
    out = torch.where(zd < 0.0, log_half, torch.log1p(-torch.exp(log_half)))
    return torch.where(nan, z, out.to(torch.float32))


def log_ndtr(z):
    """log Phi(z) of float32 ``z``, computed in double and returned in
    float32 (``common.cuh`` ``log_ndtr``): log1p(-erfc(z/sqrt2)/2) for
    z >= 0, log(erfcx(-z/sqrt2)/2) - z^2/2 below. NaN stays NaN."""
    zd = z.to(torch.float64)
    right = torch.log1p(-0.5 * torch.erfc(zd * _RSQRT2))
    left = torch.log(0.5 * torch.special.erfcx(-zd * _RSQRT2)) \
        - 0.5 * (zd * zd)
    return torch.where(zd >= 0.0, right, left).to(torch.float32)


def obs_terms(obs_at, y, chi, ssres=None, obs_model="lognormal",
              obs_param=0.0):
    """Add the terms of one grid point's observations ``obs_at`` for
    states ``y`` under ``obs_model`` (and, unless ``ssres`` is None, the
    squared residuals of the exact ones); returns (chi, ssres). A
    censored observation adds -log F(z) (left) or -log F(-z) (right) of
    its log-space model, z = (lab - log pred)/lsig (:func:`log_ndtr`,
    :func:`t_logcdf`). The JAX kernel's operations, in its order, with
    its Python constants rounded to float32 where they meet the arrays."""
    tc = t_constants(obs_param) if obs_model == "student_t" else None
    for mem, lab, lsig, ab, cen in obs_at:
        pred = y[mem[0]]
        for m in mem[1:]:
            pred = pred + y[m]
        if cen:
            z = (const(lab, pred) - torch.log(pred)) / const(lsig, pred)
            if cen == 2:
                z = -z
            chi = chi - (t_logcdf(z, tc) if tc is not None
                         else log_ndtr(z))
            continue
        if obs_model == "lognormal":
            d = const(lab, pred) - torch.log(pred)
            chi = chi + (d * d) / const(2.0 * lsig * lsig, pred)
        elif obs_model == "student_t":
            t = (const(lab, pred) - torch.log(pred)) / const(lsig, pred)
            chi = chi + const(0.5 * (obs_param + 1.0), pred) * torch.log1p(
                (t * t) / const(obs_param, pred))
        else:
            if obs_model == "poisson":
                term = pred - const(ab, pred) * torch.log(pred) if ab > 0 \
                    else pred - const(0.0, pred)
            else:   # negbinom, dispersion r
                r = const(obs_param, pred)
                term = r * torch.log1p(pred / r)
                if ab > 0:
                    term = term + const(ab, pred) * torch.log1p(r / pred)
            chi = chi + torch.where(pred >= const(0.0, pred), term,
                                    const(math.nan, pred))
        if ssres is not None:
            e = pred - const(ab, pred)
            ssres = ssres + e * e
    return chi, ssres


def apply_doses(plan, gi, y):
    """``y`` (S tensors) after the doses leaving grid point ``gi``."""
    y = list(y)
    for s, amt in plan_doses(plan, gi):
        y[s] = y[s] + const(amt, y[s])
    return y


def make_scorer(spec: ModelSpec, plan: _StaticPlan, y0_base, stepper: str):
    """``score(theta_list) -> (chi, rsq)``: the fixed-step solve over the
    plan's steps with the static per-observation terms of the plan's
    observation model, each grid point's doses after its terms, on a list
    of P per-slot float32 tensors."""
    y0_base = tuple(float(v) for v in np.asarray(y0_base))
    S = len(spec.snames)
    f = torch_evaluator(spec.rhs, S, spec.pshapes, spec.forcings)
    if stepper == "kvaerno3":   # the traced Jacobian, as the kernel's
        jac = jacobian_evaluator(spec.rhs, S, spec.pshapes, spec.forcings)

        def step(f, t, y, h, ps, at):
            return kvaerno3_fixed_step(f, t, y, h, ps, with_forcings(jac, at))
    else:
        fixed = FIXED_STEPPERS[stepper]

        def step(f, t, y, h, ps, at):
            return fixed(f, t, y, h, ps)
    dosed = scoring(plan)[3]
    forc = {}     # the stage tables, per device

    def contrib(y, gi, chi, ssres):
        chi, ssres = obs_terms(plan.obs_after[gi], y, chi, ssres,
                               plan.obs_model, plan.obs_param)
        return chi, ssres, (apply_doses(plan, gi, y) if dosed else y)

    def score(theta):
        ref = theta[0]
        y = [theta[i] if i >= 0 else
             torch.full_like(ref, y0_base[s])
             for s, i in enumerate(spec.init_pidx)]
        chi = torch.zeros_like(ref)
        ssres = torch.zeros_like(ref)
        chi, ssres, y = contrib(y, 0, chi, ssres)
        if ref.device not in forc:
            forc[ref.device] = stage_forcings(spec, plan, stepper, ref.device)
        at = forc[ref.device]
        for k, (t, h, gi) in enumerate(plan.step_ts):
            ak = None if at is None else at[k]
            y = step(with_forcings(f, ak), t, y, h, theta, ak)
            if gi >= 0:
                chi, ssres, y = contrib(y, gi, chi, ssres)
        rsq = const(1.0, ref) - ssres / const(plan.sstot, ref)
        return chi, rsq

    return score


def survey_plain(spec, plan, y0_base, thetas, stepper="dopri5"):
    """Twin of the survey kernel: ``thetas`` (P, N) float32 -> chi (N,)."""
    score = make_scorer(spec, plan, y0_base, stepper)
    return score(list(thetas))[0]


def chunk_range(nits: int, burnin: int, R_chunk, it_base: int):
    """(it_end, rec0) of one kernel launch: it runs the proposals
    ``it_base + 1 .. it_end - 1`` and records iteration ``it`` in row
    ``it - 1 - rec0`` where that is >= 0. A whole run (``R_chunk`` None)
    is ``(nits, burnin)``; a chunk of ``R_chunk`` proposals records every
    one (the JAX kernels' chunk mode, burn-in sliced on the host)."""
    if R_chunk is None:
        return nits, burnin
    return it_base + R_chunk + 1, it_base


def mh_plain(spec, plan, y0_base, theta0, seed, *, nits, burnin, walk,
             walked, num, stepper="dopri5", prior=None, R_chunk=None,
             it_base=0, state=None):
    """Twin of the MH kernel: ``theta0`` (P, C) float32; returns the
    chain-minor records theta (R, P, C) and chi, rsq, aic, acceptance
    ratio (R, C), R = nits - 1 - burnin. ``walk`` is the per-slot walk
    scale ``rwalk_std * walk_mask`` and ``walked`` marks the slots that
    draw a normal (``walk_mask != 0``); ``prior`` a
    :func:`~.priors.prior_table` or None.

    Chunk mode (``R_chunk`` proposals, :func:`chunk_range`): the
    proposals ``it_base + 1 .. it_base + R_chunk``, every one recorded,
    from ``state`` ((P + 4, C): log-theta, chi, R^2, the accept count and
    the log prior, 0 without priors; None scores theta0); returns
    (records, the state after the chunk)."""
    score = make_scorer(spec, plan, y0_base, stepper)
    P, C = theta0.shape
    it_end, rec0 = chunk_range(nits, burnin, R_chunk, it_base)
    R = it_end - 1 - rec0
    rng = Rng(seed, torch.arange(C, device=theta0.device))
    if state is None:
        theta = list(theta0)
        chi, rsq = score(theta)
        lp = None if prior is None else logprior_plain(prior, theta)
        lt = [torch.log(th) for th in theta]
        acc = torch.zeros_like(chi)
    else:
        lt = list(state[:P])
        chi, rsq, acc = state[P], state[P + 1], state[P + 2]
        lp = None if prior is None else state[P + 3]
    recs = _records(R, P, C, theta0.device)
    two, aic_c = const(2.0, chi), const(2.0 * num, chi)
    for it in range(it_base + 1, it_end):
        rng.start(it)
        prop = [lt[p] + const(walk[p], chi) * rng.normal()
                if walked[p] else lt[p] for p in range(P)]
        thp = [torch.exp(v) for v in prop]
        chi_new, rsq_new = score(thp)
        u = rng.uniform()
        log_ratio = chi - chi_new
        if prior is not None:
            lp_new = logprior_plain(prior, thp)
            log_ratio = log_ratio + (lp_new - lp)
        accept = torch.exp(log_ratio) > u   # NaN / -inf ratio rejects
        lt = [torch.where(accept, a, b) for a, b in zip(prop, lt)]
        chi = torch.where(accept, chi_new, chi)
        rsq = torch.where(accept, rsq_new, rsq)
        if prior is not None:
            lp = torch.where(accept, lp_new, lp)
        acc = acc + accept.to(torch.float32)
        r = it - 1 - rec0
        if r >= 0:
            recs[0][r] = torch.stack([torch.exp(v) for v in lt])
            recs[1][r] = chi
            recs[2][r] = rsq
            recs[3][r] = two * chi + aic_c
            recs[4][r] = acc / torch.full_like(acc, float(it))
    if R_chunk is None:
        return recs
    return recs, torch.stack(
        lt + [chi, rsq, acc, torch.zeros_like(chi) if lp is None else lp])


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
                   a, walk, walked, num, W0, stepper="dopri5", prior=None,
                   R_chunk=None, it_base=0, state=None):
    """Twin of the ensemble kernel: ``theta0`` (P, W) float32 walkers (W a
    multiple of ``tile``); returns the records of the first ``W0`` walkers,
    theta (R, P, W0) and chi, rsq, aic, acceptance ratio (R, W0),
    R = nits - 1 - burnin. ``walk`` is the per-slot walk mask and
    ``walked`` marks its non-zero slots; ``prior`` a
    :func:`~.priors.prior_table` or None. Chunk mode as
    :func:`mh_plain`'s, the state (P + 4, W) over all W walkers."""
    score = make_scorer(spec, plan, y0_base, stepper)
    P, W = theta0.shape
    dev = theta0.device
    it_end, rec0 = chunk_range(nits, burnin, R_chunk, it_base)
    R = it_end - 1 - rec0
    half = tile // 256
    n_walked = sum(walked)
    s = int(np.uint32(np.int64(seed) & _M32))
    halves = ensemble_halves(W, tile, dev)
    scal_base = mix((s * 0x7FEB352D + torch.arange(W // tile, device=dev)
                     * tile + 0xE75) & _M32)
    rng = Rng(seed, torch.arange(W, device=dev))
    if state is None:
        chi, rsq = score(list(theta0))
        lp = None if prior is None else logprior_plain(prior, list(theta0))
        lt = [torch.log(th) for th in theta0]
        acc = torch.zeros_like(chi)
    else:   # updated in place below: copies of the state's rows
        lt = [v.clone() for v in state[:P]]
        chi, rsq, acc = (state[P + i].clone() for i in range(3))
        lp = None if prior is None else state[P + 3].clone()
    one, am1, a_c = (const(v, chi) for v in (1.0, a - 1.0, a))
    nw1 = const(float(n_walked - 1), chi)
    wc = [const(w, chi) for w in walk]
    recs = _records(R, P, W0, dev)
    two, aic_c = const(2.0, chi), const(2.0 * num, chi)
    for it in range(it_base + 1, it_end):
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
            thp = [torch.exp(v) for v in prop]
            chi_new, rsq_new = score(thp)
            log_ratio = (nw1 * torch.log(z) + chi[idx]) - chi_new
            if prior is not None:
                lp_new = logprior_plain(prior, thp)
                log_ratio = log_ratio + (lp_new - lp[idx])
            accept = torch.exp(log_ratio) > uacc   # NaN / -inf rejects
            if prior is not None:
                lp[idx] = torch.where(accept, lp_new, lp[idx])
            for p in range(P):
                lt[p][idx] = torch.where(accept, prop[p], cur[p])
            chi[idx] = torch.where(accept, chi_new, chi[idx])
            rsq[idx] = torch.where(accept, rsq_new, rsq[idx])
            acc[idx] = acc[idx] + accept.to(torch.float32)
        r = it - 1 - rec0
        if r >= 0:
            recs[0][r] = torch.stack([torch.exp(v[:W0]) for v in lt])
            recs[1][r] = chi[:W0]
            recs[2][r] = rsq[:W0]
            recs[3][r] = two * chi[:W0] + aic_c
            recs[4][r] = acc[:W0] / torch.full_like(acc[:W0], float(it))
    if R_chunk is None:
        return recs
    return recs, torch.stack(
        lt + [chi, rsq, acc, torch.zeros_like(chi) if lp is None else lp])


# --------------------------------------------------------------------------
# public wrappers
# --------------------------------------------------------------------------

def _as_f32_tensor(x, device="cuda"):
    """A float32 tensor: a tensor keeps its device; an array goes to
    ``device`` (the card by default; without CUDA only ``device='cpu'``
    runs, as :func:`~odelib_tpu_torch.model.device_tensor` says)."""
    return device_tensor(x, torch.float32, device)


def _check_mesh(mesh):
    """Raise for a chain mesh, which is not ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "multi-GPU chain split is not ported yet (ROADMAP queue 1, "
            "item 18)")


def _check_cuda(spec, t: torch.Tensor):
    if t.device.type != "cuda":
        return False
    # raises RhsTraceError for an RHS the kernels cannot compile
    rhs_program(spec)
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
    lib = build.load_kernels(spec, scoring=[scoring(plan)],
                             stiff=stepper == "kvaerno3")
    dev = th.device
    plan_i, plan_f = _device_plan(spec, plan, _key(y0_base), stepper,
                                  str(dev))
    N = th.shape[1]
    chi = torch.empty(N, dtype=torch.float32, device=dev)
    args = (plan_i.data_ptr(), plan_i.numel(), plan_f.data_ptr(),
            plan_f.numel(), th.data_ptr(), chi.data_ptr(), N,
            _STEPPER_ID[stepper], build.stream(dev))

    def launch():
        build.check(lib, lib.odelib_survey(*args), "survey")
        LAUNCHES["survey_fused"] += 1
        return chi
    return launch


def _prior_tensor(prior, dev):
    """A prior table on the card, or None (a null pointer: no priors)."""
    return None if prior is None else torch.as_tensor(
        np.ascontiguousarray(prior, np.float32), device=dev)


def _ptr(t):
    """A tensor's device address, or None (a null pointer)."""
    return None if t is None else t.data_ptr()


def _records(R, P, C, dev, n_rows=4):
    """Chain-minor records: theta (R, P, C), then ``n_rows`` of (R, C)."""
    return (torch.empty((R, P, C), dtype=torch.float32, device=dev),) \
        + tuple(torch.empty((R, C), dtype=torch.float32, device=dev)
                for _ in range(n_rows))


def twin_launcher(plain):
    """A chain launcher that runs the twin ``plain`` on the launcher's
    arguments (``launch(**chunk)`` calls it; nothing is launched or
    counted): the CPU path of the wrappers, and ``ops.plain_launchers``."""
    def launcher(*args, **kw):
        *head, stepper, th0, seed = args
        return lambda **ck: plain(*head, th0, seed, stepper=stepper, **kw,
                                  **ck)
    return launcher


def mh_launcher(spec, plan, y0_base, stepper, th0, seed, *, nits, burnin,
                walk, walked, num, prior=None, R_chunk=None):
    """Prepare the MH kernel for chains ``th0`` (P, C) on the card and
    return ``launch() -> records`` (theta (R, P, C); chi, rsq, aic,
    acceptance ratio (R, C)); each call launches the kernel once (and
    counts it). ``prior``: a :func:`~.priors.prior_table` or None. With
    ``R_chunk`` it is ``launch(it_base, state) -> (records, state)``, a
    chunk of :func:`mh_plain`'s chunk mode, state a (P + 4, C) tensor on
    the card (None on the first chunk)."""
    from . import build
    lib = build.load_kernels(spec, scoring=[scoring(plan)],
                             stiff=stepper == "kvaerno3")
    dev = th0.device
    P, C = th0.shape
    plan_i, plan_f = _device_plan(spec, plan, _key(y0_base), stepper,
                                  str(dev))
    # per slot: the walk scale, then the walked flag
    walk_t = torch.as_tensor(np.asarray(
        walk + tuple(float(w) for w in walked), np.float32), device=dev)
    prior_t = _prior_tensor(prior, dev)
    head = (plan_i.data_ptr(), plan_i.numel(), plan_f.data_ptr(),
            plan_f.numel(), th0.data_ptr(), walk_t.data_ptr(),
            _ptr(prior_t))
    tail = (int(np.uint32(np.int64(seed) & _M32)),
            float(np.float32(2.0 * num)), _STEPPER_ID[stepper],
            build.stream(dev))

    def launch(it_base=0, state=None):
        it_end, rec0 = chunk_range(nits, burnin, R_chunk, it_base)
        recs = _records(it_end - 1 - rec0, P, C, dev)
        out = None if R_chunk is None else torch.empty(
            (P + 4, C), dtype=torch.float32, device=dev)
        build.check(lib, lib.odelib_mh(
            *head, _ptr(state), _ptr(out), *(r.data_ptr() for r in recs),
            C, int(it_base), int(it_end), int(rec0), *tail), "mh")
        LAUNCHES["metropolis_hastings_fused"] += 1
        return recs if R_chunk is None else (recs, out)
    launch.keep = (walk_t, prior_t)   # alive as long as the launcher
    return launch


def ensemble_launcher(spec, plan, y0_base, stepper, th0, seed, *, tile,
                      nits, burnin, a, walk, walked, num, W0, blocks=None,
                      prior=None, R_chunk=None):
    """Prepare the ensemble kernel for walkers ``th0`` (P, W) on the card
    and return ``launch() -> records`` (theta (R, P, W0); chi, rsq, aic,
    acceptance ratio (R, W0)). Each call makes one device launch, which
    runs the whole run (or, with ``R_chunk``, one chunk: ``launch(it_base,
    state) -> (records, state)`` as :func:`mh_launcher`'s, the state
    (P + 4, W)), and counts it. ``blocks`` caps the grid (default: as many
    blocks as can be co-resident; with fewer threads than the W/2 columns
    each thread loops over several). ``prior``: a
    :func:`~.priors.prior_table` or None."""
    from . import build
    lib = build.load_kernels(spec, scoring=[scoring(plan)],
                             stiff=stepper == "kvaerno3")
    dev = th0.device
    P, W = th0.shape
    plan_i, plan_f = _device_plan(spec, plan, _key(y0_base), stepper,
                                  str(dev))
    sizes = (plan_i.numel(), plan_f.numel())
    if blocks is None:
        n = ctypes.c_int()
        build.check(lib, lib.odelib_ensemble_blocks(
            *sizes, _STEPPER_ID[stepper], int(prior is not None),
            ctypes.byref(n)), "ensemble")
        blocks = n.value
    # per slot: the walk mask value, then the walked flag
    walk_t = torch.as_tensor(np.asarray(
        tuple(walk) + tuple(float(w) for w in walked), np.float32),
        device=dev)
    prior_t = _prior_tensor(prior, dev)
    bar = torch.empty(2, dtype=torch.int32, device=dev)  # zeroed per launch
    # the kernel's scratch: the state's other parity, each column's two
    # candidates and its posted decision (csrc/ensemble.cu)
    work = torch.empty((P + 4) * W + (2 * (P + 3) + 1) * (W // 2),
                       dtype=torch.float32, device=dev)
    # a - 1, a, n_walked - 1 and the AIC term, rounded as JAX rounds them
    consts = tuple(float(np.float32(v)) for v in (a - 1.0, a,
                                                  sum(walked) - 1, 2.0 * num))
    head = (plan_i.data_ptr(), sizes[0], plan_f.data_ptr(), sizes[1],
            th0.data_ptr(), walk_t.data_ptr(), _ptr(prior_t))
    tail = (int(np.uint32(np.int64(seed) & _M32)), *consts,
            _STEPPER_ID[stepper], int(blocks), build.stream(dev))

    def launch(it_base=0, state=None):
        it_end, rec0 = chunk_range(nits, burnin, R_chunk, it_base)
        recs = _records(it_end - 1 - rec0, P, W0, dev)
        # the walkers' state, which the kernel works in: log-theta, chi,
        # R^2, the accept count and the log prior (0 without priors)
        buf = torch.zeros((P + 4, W), dtype=torch.float32, device=dev)
        build.check(lib, lib.odelib_ensemble(
            *head, _ptr(state), buf.data_ptr(), work.data_ptr(),
            bar.data_ptr(),
            *(r.data_ptr() for r in recs), W, W0, int(tile), int(it_base),
            int(it_end), int(rec0), *tail), "ensemble")
        LAUNCHES["ensemble_fused"] += 1
        return recs if R_chunk is None else (recs, buf)
    launch.keep = (walk_t, prior_t, bar, work)   # alive with the launcher
    return launch


def _key(y0_base):
    return tuple(float(v) for v in np.asarray(y0_base, np.float64))


def survey_fused(spec: ModelSpec, obs: ObsData, times, y0_base, thetas, *,
                 substeps: int = 4, stepper: str = "dopri5",
                 tile_chains: Optional[int] = None, interpret: bool = False,
                 device="cuda"):
    """Chi of N parameter draws in one kernel launch (the fused survey).

    ``thetas`` is (N, P) flat slots; a CUDA tensor launches the survey
    kernel, a CPU one runs its twin, and an array goes to ``device`` (the
    card by default; without CUDA it raises unless ``device='cpu'``).
    Returns chi (N,) float32 on the input's device. ``tile_chains``/
    ``interpret`` are the JAX signature's and are ignored (the CUDA grid
    covers N exactly)."""
    _check_stepper(stepper)
    thetas = _as_f32_tensor(thetas, device)
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
        resume_from: Optional[str] = None, config_token: str = "",
        _stop_after_chunks: Optional[int] = None, device="cuda"):
    """Run C chains of reference-semantics MH in one kernel launch.

    ``theta0`` is (C, P) float32; a CUDA tensor launches the MH kernel,
    a CPU one runs its twin, an array goes to ``device`` (as
    :func:`survey_fused`'s ``thetas``). Returns ``MHOutput`` with theta (C, R, P) and
    chi, rsquared, aic, acceptance_ratio (C, R), R = nits - 1 - burnin, and
    iteration (R,).
    Chain c keys its RNG on its global index c, as in the JAX kernel, so
    no padding is needed. ``priors``: one distribution (or None) per theta
    slot, added to the acceptance in the kernel (all None: no priors; a
    family without an in-kernel form raises ``ValueError``).

    ``checkpoint_every`` runs the proposals in chunks of that many, one
    launch each (:mod:`.chunked`), bitwise the records of one launch;
    with ``checkpoint_path`` the state and records are persisted after
    each chunk, and ``resume_from`` (alone: one chunk of ``nits``)
    continues from such a file, raising ``ValueError`` if it was written
    by a different configuration (``config_token`` is part of it).
    ``_stop_after_chunks`` returns None after that many chunks, as a
    killed run. ``tile_chains``/``interpret`` are accepted and ignored; a
    ``mesh`` raises ``NotImplementedError``."""
    from ..samplers.mh import MHOutput
    _check_mesh(mesh)
    _check_stepper(stepper)
    if burnin is None:
        burnin = int(nits / 2)
    R = nits - 1 - burnin
    if R <= 0:
        raise ValueError(f"nits={nits} leaves no recorded iterations after "
                         f"burnin={burnin}")
    theta0 = _as_f32_tensor(theta0, device)
    C, P = theta0.shape
    if P != spec.theta_size:
        raise ValueError(f"theta0 must have {spec.theta_size} columns")
    prior = checked_priors(priors, P)
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
    launcher = mh_launcher if _check_cuda(spec, th0) \
        else twin_launcher(mh_plain)

    def make(R_chunk=None):
        return launcher(spec, plan, y0_base, stepper, th0, seed, nits=nits,
                        burnin=burnin, walk=walk, walked=walked, num=num,
                        prior=prior, R_chunk=R_chunk)
    static = ("mh", spec.pnames, P, C, nits, burnin, walk, num, stepper,
              substeps, int(seed), chunked.prior_key(prior),
              str(config_token))
    recs = chunked.run(make, "MCMC", static, nits=int(nits),
                       burnin=int(burnin), device=th0.device,
                       checkpoint_every=checkpoint_every,
                       checkpoint_path=checkpoint_path,
                       resume_from=resume_from, stop_after=_stop_after_chunks)
    if recs is None:
        return None
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
        resume_from: Optional[str] = None, config_token: str = "",
        _stop_after_chunks: Optional[int] = None, device="cuda"):
    """Affine-invariant ensemble sampler (Goodman-Weare stretch moves).

    ``theta0`` is (W0, P) float32 walkers; a CUDA tensor launches the
    ensemble kernel, a CPU one runs its twin, an array goes to ``device``
    (as :func:`survey_fused`'s ``thetas``). Walkers are jittered and
    padded on the host exactly as in the JAX package (:func:`ensemble_init`),
    to W, a multiple of ``tile_chains``; every ``tile_chains`` walkers are
    one independent ensemble, so the tile is part of the result (default:
    :func:`pick_tile_chains`, the JAX rule; any multiple of 256). Returns
    ``MHOutput`` for the first W0 walkers, as
    :func:`metropolis_hastings_fused`, with ``priors`` and the chunked
    checkpointing options as there (the first chunk scores the start
    walkers, later ones load the state of all W). ``interpret`` is
    accepted and ignored; a ``mesh`` raises ``NotImplementedError``."""
    from ..samplers.mh import MHOutput
    _check_mesh(mesh)
    _check_stepper(stepper)
    if burnin is None:
        burnin = int(nits / 2)
    P = spec.theta_size
    if a <= 1.0:
        raise ValueError(f"stretch scale a must exceed 1, got {a}")
    theta0 = _as_f32_tensor(theta0, device)
    dev = theta0.device
    th_np = theta0.cpu().numpy()
    W0 = th_np.shape[0]
    if th_np.shape[1] != P:
        raise ValueError(f"theta0 must have {P} columns")
    prior = checked_priors(priors, P)
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
    launcher = ensemble_launcher if _check_cuda(spec, th0) \
        else twin_launcher(ensemble_plain)

    def make(R_chunk=None):
        return launcher(spec, plan, y0_base, stepper, th0, seed, tile=tile,
                        nits=nits, burnin=burnin, a=float(a), walk=walk,
                        walked=walked, num=num, W0=W0, prior=prior,
                        R_chunk=R_chunk)
    static = ("ensemble", spec.pnames, P, tile, th0.shape[1], nits, burnin,
              walk, float(a), num, stepper, substeps, W0, int(seed),
              float(init_jitter), chunked.prior_key(prior),
              str(config_token))
    recs = chunked.run(make, "MCMC", static, nits=int(nits),
                       burnin=int(burnin), device=th0.device,
                       checkpoint_every=checkpoint_every,
                       checkpoint_path=checkpoint_path,
                       resume_from=resume_from, stop_after=_stop_after_chunks)
    if recs is None:
        return None
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
    th = _as_f32_tensor(theta0, "cpu")
    return (obsdata_from_arrays(obs), th, int(seed),
            np.asarray(y0, np.float64))
