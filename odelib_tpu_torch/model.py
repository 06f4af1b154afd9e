"""Static model description and host-side observation arrays.

Counterpart of ``odelib_tpu/model.py``: :class:`ModelSpec` is the static,
hashable description of the problem (RHS, names, state summations, the
``<sname>0`` init-parameter wiring) and :class:`ObsData` holds the flat
per-observation arrays as host numpy. Scalar parameters only: forcings,
dose events, diffusions and array parameters raise ``NotImplementedError``
(ROADMAP queue 1, item 13).
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
                    "not ported yet (ROADMAP queue 1, item 13)")
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
    """Build a ModelSpec, validating summations like ``odelib_tpu``."""
    if any(s for s in (pshapes or ())):
        raise NotImplementedError(
            "array parameters are not ported yet (ROADMAP queue 1, item 13)")
    if dose_events or forcings:
        raise NotImplementedError(
            "dose_events and forcings are not ported yet (ROADMAP queue 1, "
            "item 13)")
    if diffusion is not None:
        raise NotImplementedError(
            "diffusion (SDE models, sampler='pmmh') is not ported yet "
            "(ROADMAP queue 1, item 15)")
    if obs_model not in OBS_MODELS:
        raise ValueError(f"obs_model must be one of {OBS_MODELS}, "
                         f"got {obs_model!r}")
    if obs_model == "student_t":
        obs_param = 4.0 if obs_param is None else float(obs_param)
    elif obs_model == "negbinom":
        if obs_param is None or float(obs_param) <= 0:
            raise ValueError("negbinom requires obs_param = dispersion r "
                             "> 0 (variance = mean + mean^2/r)")
        obs_param = float(obs_param)
    else:
        obs_param = 0.0
    pnames, snames = tuple(pnames), tuple(snames)
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
                     obs_model=obs_model, obs_param=obs_param)
