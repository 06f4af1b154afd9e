"""Static model description and host-side observation arrays.

Counterpart of ``odelib_tpu/model.py``: :class:`ModelSpec` is the static,
hashable description of the problem (RHS, names, state summations, the
``<sname>0`` init-parameter wiring, the diagonal diffusion of an SDE
model, its bolus dose events) and :class:`ObsData` holds the flat
per-observation arrays as host numpy. Scalar parameters only: forcings and
array parameters raise ``NotImplementedError`` (ROADMAP queue 1, item
13b).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class ObsData(NamedTuple):
    """Flat per-observation arrays (states concatenated)."""
    log_abundance: Any   # (N,)
    log_sigma: Any       # (N,)
    abundance: Any       # (N,) linear-space observations (for R^2)
    t_index: Any         # (N,) int32 index into the integration grid
    state_index: Any     # (N,) int32 index into post-summation states
    sstot: Any           # scalar: sum_s n_s * var(O_s) (R^2 denominator)
    censor: Any = None   # (N,) int32 censoring flags, or None


def obsdata_from_arrays(obs) -> ObsData:
    """Port-side :class:`ObsData` from any object with the same field names
    (for instance ``odelib_tpu.model.ObsData``), read as plain numpy."""
    censor = getattr(obs, "censor", None)
    return ObsData(
        log_abundance=np.asarray(obs.log_abundance, np.float64),
        log_sigma=np.asarray(obs.log_sigma, np.float64),
        abundance=np.asarray(obs.abundance, np.float64),
        t_index=np.asarray(obs.t_index, np.int32),
        state_index=np.asarray(obs.state_index, np.int32),
        sstot=np.asarray(obs.sstot, np.float64),
        censor=None if censor is None else np.asarray(censor, np.int32))


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static problem description.

    ``rhs`` has the signature ``f(t, y, ps)``: ``y`` indexes states on its
    leading axis and ``ps`` is the list of parameter values in ``pnames``
    order (see :mod:`odelib_tpu_torch.rhs`).
    """
    rhs: Callable
    pnames: Tuple[str, ...]
    snames: Tuple[str, ...]
    sum_matrix: Optional[tuple] = None           # (S_raw, S_post) 0/1
    post_snames: Tuple[str, ...] = None
    init_pidx: Tuple[int, ...] = None            # theta slot of '<s>0' or -1
    obs_model: str = "lognormal"
    obs_param: float = 0.0
    # bolus doses ((time, raw_state_index, amount), ...) sorted by time:
    # each amount joins its state when the solve leaves the grid point
    # nearest its time, so reported states are pre-dose left limits
    dose_events: Optional[Tuple[Tuple[float, int, float], ...]] = None
    # diagonal process noise ``g(t, y, ps)`` (same convention as ``rhs``):
    # the model is the SDE dy = f dt + g dW, fitted by sampler='pmmh';
    # None for an ODE
    diffusion: Optional[Callable] = None

    def __post_init__(self):
        if self.post_snames is None:
            object.__setattr__(self, "post_snames", tuple(self.snames))
        if self.init_pidx is None:
            idx = tuple(self.pnames.index(s + "0") if s + "0" in self.pnames
                        else -1 for s in self.snames)
            object.__setattr__(self, "init_pidx", idx)

    @property
    def theta_size(self) -> int:
        return len(self.pnames)

    def pack_theta(self, values: Sequence) -> np.ndarray:
        """Per-parameter scalar values (pnames order) -> flat theta."""
        out = []
        for p, v in zip(self.pnames, values):
            a = np.ravel(np.asarray(v, np.float64))
            if a.size != 1:
                raise NotImplementedError(
                    f"parameter {p!r} is array-valued; array parameters are "
                    "not ported yet (ROADMAP queue 1, item 13b)")
            out.append(a[0])
        return np.asarray(out, np.float64)

    def unpack_theta(self, theta):
        """(..., P) theta -> list of per-parameter (...,) values."""
        return [theta[..., j] for j in range(self.theta_size)]

    def apply_summations(self, ys):
        """(..., S_raw) -> (..., S_post)."""
        if self.sum_matrix is None:
            return ys
        m = torch.as_tensor(np.asarray(self.sum_matrix), dtype=ys.dtype,
                            device=ys.device)
        return ys @ m

    def override_inits(self, y0, theta):
        """Replace y0 entries wired to '<sname>0' parameters. ``y0`` is
        (S,) and ``theta`` (N, P); returns (S, N)."""
        n = theta.shape[0]
        rows = [theta[:, i] if i >= 0 else y0[s].expand(n)
                for s, i in enumerate(self.init_pidx)]
        return torch.stack(rows)


OBS_MODELS = ("lognormal", "student_t", "poisson", "negbinom")


def make_spec(rhs, pnames, snames, state_summations=None, pshapes=None,
              obs_model="lognormal", obs_param=None, dose_events=None,
              forcings=None, diffusion=None) -> ModelSpec:
    """Build a ModelSpec, validating summations, the observation model
    and ``dose_events`` (``(time, state name or raw index, amount)``
    triples) like ``odelib_tpu``."""
    if any(s for s in (pshapes or ())):
        raise NotImplementedError(
            "array parameters are not ported yet (ROADMAP queue 1, item 13b)")
    if forcings:
        raise NotImplementedError(
            "forcings are not ported yet (ROADMAP queue 1, item 13b)")
    if obs_model not in OBS_MODELS:
        raise ValueError(f"obs_model must be one of {OBS_MODELS}, "
                         f"got {obs_model!r}")
    if obs_model == "student_t":
        obs_param = 4.0 if obs_param is None else float(obs_param)
        if obs_param <= 0:
            raise ValueError("student_t obs_param (degrees of freedom) "
                             "must be > 0")
    elif obs_model == "negbinom":
        if obs_param is None or float(obs_param) <= 0:
            raise ValueError("negbinom requires obs_param = dispersion r "
                             "> 0 (variance = mean + mean^2/r)")
        obs_param = float(obs_param)
    else:
        obs_param = 0.0
    pnames, snames = tuple(pnames), tuple(snames)
    if dose_events:
        evs = []
        for t, s, amt in dose_events:
            if isinstance(s, str):
                if s not in snames:
                    raise ValueError(f"dose_events state {s!r} is not a "
                                     f"valid state name {snames}")
                s = snames.index(s)
            s = int(s)
            if not 0 <= s < len(snames):
                raise ValueError(f"dose_events state index {s} out of "
                                 f"range for {len(snames)} states")
            evs.append((float(t), s, float(amt)))
        dose_events = tuple(sorted(evs))
    else:
        dose_events = None
    sum_matrix, post_snames = None, snames
    if state_summations:
        sname_i = {s: i for i, s in enumerate(snames)}
        summed, groups = set(), {}
        for newname, members in state_summations.items():
            idxs = []
            for pop in members:
                if pop in summed:
                    raise ValueError(f"{pop} state variable cannot be used "
                                     "in two summations")
                if pop not in sname_i:
                    raise ValueError(
                        f"{pop} state variable is not a valid state name")
                summed.add(pop)
                idxs.append(sname_i[pop])
            if len(idxs) < 2:
                raise ValueError(
                    f"Summation of {newname} needs two or more states")
            idxs.sort()
            groups[idxs[0]] = (newname, tuple(idxs))
        post, cols = [], []
        for i, s in enumerate(snames):
            if i in groups:
                post.append(groups[i][0])
                cols.append(groups[i][1])
            elif s not in summed:
                post.append(s)
                cols.append((i,))
        m = np.zeros((len(snames), len(post)))
        for j, idxs in enumerate(cols):
            m[list(idxs), j] = 1.0
        sum_matrix = tuple(tuple(row) for row in m)
        post_snames = tuple(post)
    return ModelSpec(rhs=rhs, pnames=pnames, snames=snames,
                     sum_matrix=sum_matrix, post_snames=post_snames,
                     obs_model=obs_model, obs_param=obs_param,
                     dose_events=dose_events, diffusion=diffusion)


# --------------------------------------------------------------------------
# batched integration and scoring (torch, any device and dtype)
# --------------------------------------------------------------------------

def state_func(spec: ModelSpec):
    """``func(t, y (S, N), ps) -> (S, N)`` for the integrators."""
    from .rhs import torch_evaluator
    f = torch_evaluator(spec.rhs, len(spec.snames), spec.theta_size)
    return lambda t, y, ps: torch.stack(f(t, list(y), ps))


def state_jac(spec: ModelSpec):
    """``jac(t, y (S, N), ps) -> (S, S, N)``: the RHS's Jacobian in the
    states from the traced DAG's forward-mode columns
    (:meth:`~odelib_tpu_torch.rhs.RhsProgram.jacobian`), for the implicit
    integrators."""
    from .rhs import jacobian_evaluator
    S = len(spec.snames)
    J = jacobian_evaluator(spec.rhs, S, spec.theta_size)

    def jac(t, y, ps):
        cols = J(t, list(y), ps)
        return torch.stack(cols).reshape((S, S) + cols[0].shape)
    return jac


def dose_matrix(spec: ModelSpec, times) -> Optional[np.ndarray]:
    """(T, S_raw) float64 impulse matrix of the spec's dose events on the
    grid ``times``: each event snaps to the nearest grid point (the first
    of a tie) and its amount adds into ``D[grid index, state]``. None
    without events."""
    if not spec.dose_events:
        return None
    times = np.asarray(times, np.float64)
    D = np.zeros((len(times), len(spec.snames)))
    for t, s, amt in spec.dose_events:
        D[int(np.argmin(np.abs(times - t))), s] += amt
    return D


def integrate_theta(spec: ModelSpec, thetas, y0, times, *, method="dopri5",
                    rtol=1e-6, atol=1e-4, max_steps=4096, substeps=4):
    """Solve the ODE for N flat parameter vectors ``thetas`` (N, P) from
    per-lane initial states ``y0`` (S, N), on the tensor's device and
    dtype, with the spec's doses (:func:`dose_matrix`; pre-dose outputs).
    Returns raw-state ys (T, S, N), NaN from a failed adaptive lane on.
    ``method``: adaptive 'dopri5', 'kvaerno3', 'kvaerno5' or 'auto', or
    fixed steps ('rk4', 'fixed_dopri5', 'fixed_kvaerno3'; ``substeps``
    per interval); the implicit ones take the traced RHS's Jacobian
    (:func:`state_jac`)."""
    from .ops.integrate import odeint_fixed, odeint_grid
    f = state_func(spec)
    ps = spec.unpack_theta(thetas)
    dose = dose_matrix(spec, times)
    fixed = {"rk4": "rk4", "fixed_dopri5": "dopri5",
             "fixed_kvaerno3": "kvaerno3"}
    if method in fixed:
        return odeint_fixed(f, y0, times, ps, substeps=substeps,
                            method=fixed[method], dose=dose,
                            jac=state_jac(spec)).ys
    return odeint_grid(f, y0, times, ps, rtol=rtol, atol=atol,
                       max_steps=max_steps, method=method, dose=dose,
                       jac=state_jac(spec)).ys


def observe(spec: ModelSpec, obs: ObsData, ys):
    """Predictions at the observation points: (T, S_raw, N) -> (N, n_obs),
    after summation."""
    post = spec.apply_summations(ys.permute(2, 0, 1))      # (N, T, S_post)
    ti = torch.as_tensor(np.asarray(obs.t_index), dtype=torch.int64,
                         device=ys.device)
    si = torch.as_tensor(np.asarray(obs.state_index), dtype=torch.int64,
                         device=ys.device)
    return post[:, ti, si]


def score_pred(spec: ModelSpec, obs: ObsData, pred):
    """Chi of linear-space predictions (N, n_obs) under the spec's
    observation model and the observations' censoring -> (N,)."""
    from . import stats
    dt, dev = pred.dtype, pred.device

    def col(a, dtype=dt):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    return stats.obs_negloglik(
        spec.obs_model, spec.obs_param, col(obs.log_abundance),
        torch.log(pred), col(obs.log_sigma), col(obs.abundance), pred,
        censor=None if obs.censor is None else col(obs.censor, torch.int64))


def chi_of_theta(spec: ModelSpec, obs: ObsData, thetas, y0, times, **ikw):
    """One survey evaluation per row of ``thetas`` (N, P): integrate from
    ``y0`` (S,) with the '<s>0' overrides, observe and score -> chi (N,),
    on ``thetas``' device and dtype."""
    y0 = torch.as_tensor(y0, dtype=thetas.dtype, device=thetas.device)
    ys = integrate_theta(spec, thetas, spec.override_inits(y0, thetas),
                         times, **ikw)
    return score_pred(spec, obs, observe(spec, obs, ys))
