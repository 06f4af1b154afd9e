"""Static model description and host-side observation arrays.

Counterpart of ``odelib_tpu/model.py``: :class:`ModelSpec` is the static,
hashable description of the problem (RHS, names, state summations, the
``<sname>0`` init-parameter wiring, the diagonal diffusion of an SDE
model, its bolus dose events, its forcings and the parameters' shapes)
and :class:`ObsData` holds the flat per-observation arrays as host numpy.
Array parameters flatten into one theta slot per entry; forcings are the
reference's linear, hold and PCHIP tables (:func:`normalize_forcings`,
:func:`eval_forcings`), which the kernels read as a per-stage table of
the forcing columns (:func:`spec_columns`, :func:`forcing_rows`).
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


def device_tensor(x, dtype, device="cuda"):
    """``x`` as a ``dtype`` tensor: a tensor keeps its device; an array or
    list goes to ``device``, the card by default, which raises without
    CUDA (as ``ModelFramework`` does) unless the CPU is asked for."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the input goes to a CUDA device by default and none was found "
            "(torch.cuda.is_available() is False); pass device='cpu' or a "
            "CPU tensor to run on the CPU")
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)


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

    ``rhs`` has the signature ``f(t, y, ps)``, or ``f(t, y, ps, u)`` with
    ``forcings`` (``u`` the dict of forcing values at ``t``): ``y`` indexes
    states on its leading axis and ``ps`` is the list of parameter values
    in ``pnames`` order, an array parameter as an array of its ``pshapes``
    shape (see :mod:`odelib_tpu_torch.rhs`).
    """
    rhs: Callable
    pnames: Tuple[str, ...]
    snames: Tuple[str, ...]
    pshapes: Tuple[Tuple[int, ...], ...] = None  # () == scalar
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
    # time-varying covariates ((name, times, values, mode), ...), mode
    # 'linear', 'hold' or 'cubic' (:func:`normalize_forcings`); None
    forcings: Optional[Tuple[Tuple[str, tuple, tuple, str], ...]] = None

    def __post_init__(self):
        if self.pshapes is None:
            object.__setattr__(self, "pshapes", tuple(() for _ in self.pnames))
        if self.post_snames is None:
            object.__setattr__(self, "post_snames", tuple(self.snames))
        if self.init_pidx is None:
            offs = self.theta_offsets
            idx = tuple(offs[self.pnames.index(s + "0")]
                        if s + "0" in self.pnames else -1
                        for s in self.snames)
            object.__setattr__(self, "init_pidx", idx)

    # ---- theta (flat parameter vector) layout ---------------------------
    @property
    def theta_offsets(self) -> Tuple[int, ...]:
        offs, o = [], 0
        for shp in self.pshapes:
            offs.append(o)
            o += int(np.prod(shp)) if shp else 1
        return tuple(offs)

    @property
    def theta_size(self) -> int:
        return sum(int(np.prod(s)) if s else 1 for s in self.pshapes)

    def pack_theta(self, values: Sequence) -> np.ndarray:
        """Per-parameter values (pnames order) -> flat float64 theta, an
        array parameter row-major."""
        parts = [np.ravel(np.asarray(v, np.float64)) for v in values]
        return np.concatenate(parts) if parts else np.zeros((0,))

    def unpack_theta(self, theta):
        """Flat ``theta`` (..., P) -> per-parameter values in ``pnames``
        order: a scalar's (...,) slot, an array parameter's slots as
        (..., *shape)."""
        ps = []
        for off, shp in zip(self.theta_offsets, self.pshapes):
            if shp:
                n = int(np.prod(shp))
                v = theta[..., off:off + n]
                ps.append(v.reshape(tuple(v.shape[:-1]) + tuple(shp)))
            else:
                ps.append(theta[..., off])
        return ps

    def slots(self, theta):
        """(..., P) theta -> the list of its P per-slot (...,) values, the
        form the traced RHS and the kernels' twins take."""
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

FORCING_MODES = ("linear", "hold", "cubic")


@lru_cache(maxsize=256)
def _pchip_slopes(ft: tuple, fv: tuple) -> np.ndarray:
    """Knot derivatives of the shape-preserving (PCHIP, Fritsch-Carlson)
    cubic interpolant of a forcing table: monotone data never overshoots
    between knots. Cached per table (the spec keeps tables as tuples)."""
    t = np.asarray(ft, np.float64)
    v = np.asarray(fv, np.float64)
    n = t.size
    if n == 1:
        return np.zeros(1)
    h = np.diff(t)
    delta = np.diff(v) / h
    if n == 2:
        return np.array([delta[0], delta[0]])
    d = np.zeros(n)
    # interior: weighted harmonic mean where the secants agree in sign
    d0, d1 = delta[:-1], delta[1:]
    h0, h1 = h[:-1], h[1:]
    w1 = 2.0 * h1 + h0
    w2 = h1 + 2.0 * h0
    with np.errstate(divide="ignore", invalid="ignore"):
        hm = (w1 + w2) / (w1 / d0 + w2 / d1)
    d[1:-1] = np.where((d0 * d1) > 0.0, hm, 0.0)

    def edge(h_a, h_b, del_a, del_b):
        # one-sided three-point estimate, clamped for shape preservation
        s = ((2.0 * h_a + h_b) * del_a - h_a * del_b) / (h_a + h_b)
        if np.sign(s) != np.sign(del_a):
            return 0.0
        if np.sign(del_a) != np.sign(del_b) and abs(s) > 3.0 * abs(del_a):
            return 3.0 * del_a
        return s

    d[0] = edge(h[0], h[1], delta[0], delta[1])
    d[-1] = edge(h[-1], h[-2], delta[-1], delta[-2])
    return d


def _hermite_eval(tq, ft, fv, d, xp):
    """The cubic Hermite interpolant (knots ``ft``/``fv``, slopes ``d``) at
    ``tq``, clamped to the table's span; ``xp`` is numpy (concrete times)
    or a namespace of torch functions (tensor times)."""
    tq = xp.clip(tq, ft[0], ft[-1])
    i = xp.clip(xp.searchsorted(ft, tq, side="right") - 1, 0, len(ft) - 2)
    t0, t1 = ft[i], ft[i + 1]
    hseg = t1 - t0
    s = tq - t0
    dl = (fv[i + 1] - fv[i]) / hseg
    c2 = (3.0 * dl - 2.0 * d[i] - d[i + 1]) / hseg
    c3 = (d[i] + d[i + 1] - 2.0 * dl) / (hseg * hseg)
    return fv[i] + s * (d[i] + s * (c2 + s * c3))


def normalize_forcings(forcings):
    """A user forcings mapping in the spec's static tuple form.

    Accepts ``{name: (times, values)}``, ``{name: (times, values, mode)}``
    or ``{name: {'t': ..., 'v': ..., 'mode': ...}}``, and the normalised
    tuple itself (``odelib_tpu``'s too), which passes through. Times must
    be strictly increasing and as many as the values; queries outside the
    table take the endpoint values. Modes: ``'linear'`` (default),
    ``'hold'`` (the previous knot's value) and ``'cubic'`` (PCHIP,
    :func:`_pchip_slopes`)."""
    if not forcings:
        return None
    if isinstance(forcings, tuple) and forcings and \
            isinstance(forcings[0], tuple) and len(forcings[0]) == 4:
        return forcings  # already normalized (spec rebuilds)
    out = []
    for name, table in dict(forcings).items():
        if isinstance(table, dict):
            ft, fv = table["t"], table["v"]
            mode = table.get("mode", "linear")
        else:
            if len(table) == 3:
                ft, fv, mode = table
            else:
                ft, fv = table
                mode = "linear"
        if mode not in FORCING_MODES:
            raise ValueError(f"forcing {name!r}: mode must be one of "
                             f"{FORCING_MODES}, got {mode!r}")
        ft = np.asarray(ft, np.float64).ravel()
        fv = np.asarray(fv, np.float64).ravel()
        if ft.size == 0 or ft.size != fv.size:
            raise ValueError(
                f"forcing {name!r}: times and values must be equal-length "
                f"and non-empty (got {ft.size} times, {fv.size} values)")
        if not np.all(np.isfinite(ft)) or not np.all(np.isfinite(fv)):
            raise ValueError(f"forcing {name!r}: times/values must be finite")
        if ft.size > 1 and not np.all(np.diff(ft) > 0):
            raise ValueError(
                f"forcing {name!r}: times must be strictly increasing")
        out.append((str(name), tuple(float(t) for t in ft),
                    tuple(float(v) for v in fv), str(mode)))
    return tuple(out)


class _TorchXp:
    """The numpy functions :func:`_hermite_eval` calls, on tensors."""

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, min=lo, max=hi)

    @staticmethod
    def searchsorted(a, v, side="left"):
        return torch.searchsorted(a, v, right=side == "right")


def eval_forcings(forcings, t):
    """Every forcing at time ``t`` -> ``{name: value}``.

    At a concrete time (a Python or numpy float) the values are Python
    floats computed in double, as ``odelib_tpu`` folds them into its
    kernels; at a tensor ``t`` they are tensors of its dtype and shape,
    each table lookup a ``torch.searchsorted`` (the torch solvers)."""
    out = {}
    if not isinstance(t, torch.Tensor):
        tc = float(t)
        for name, ft, fv, mode in forcings:
            if mode == "hold":
                i = int(np.clip(np.searchsorted(ft, tc, side="right") - 1,
                                0, len(fv) - 1))
                out[name] = float(fv[i])
            elif mode == "cubic" and len(ft) > 1:
                out[name] = float(_hermite_eval(
                    tc, np.asarray(ft), np.asarray(fv),
                    _pchip_slopes(ft, fv), np))
            else:
                out[name] = float(np.interp(tc, ft, fv))
        return out
    dt, dev = t.dtype, t.device
    for name, ft, fv, mode in forcings:
        ftt = torch.as_tensor(ft, dtype=dt, device=dev)
        fvt = torch.as_tensor(fv, dtype=dt, device=dev)
        if len(ft) == 1:
            out[name] = torch.full_like(t, fv[0])
        elif mode == "hold":
            i = torch.clamp(torch.searchsorted(ftt, t.contiguous(),
                                               right=True) - 1, 0, len(fv) - 1)
            out[name] = fvt[i]
        elif mode == "cubic":
            d = torch.as_tensor(_pchip_slopes(ft, fv), dtype=dt, device=dev)
            out[name] = _hermite_eval(t.contiguous(), ftt, fvt, d, _TorchXp)
        else:   # jnp.interp: linear inside, the end values outside
            tq = torch.clamp(t, ft[0], ft[-1]).contiguous()
            i = torch.clamp(torch.searchsorted(ftt, tq, right=True) - 1,
                            0, len(ft) - 2)
            t0, t1 = ftt[i], ftt[i + 1]
            v0, v1 = fvt[i], fvt[i + 1]
            out[name] = v0 + (tq - t0) * ((v1 - v0) / (t1 - t0))
    return out


def make_spec(rhs, pnames, snames, state_summations=None, pshapes=None,
              obs_model="lognormal", obs_param=None, dose_events=None,
              forcings=None, diffusion=None) -> ModelSpec:
    """Build a ModelSpec, validating summations, the observation model,
    ``dose_events`` (``(time, state name or raw index, amount)``
    triples) and ``forcings`` (:func:`normalize_forcings`) like
    ``odelib_tpu``. ``pshapes`` gives each parameter's shape (``()`` for a
    scalar). With forcings ``rhs`` takes a fourth argument, the dict of
    forcing values; ``diffusion`` takes it if it has four arguments."""
    forcings = normalize_forcings(forcings)
    if forcings and diffusion is not None:
        from .rhs import takes_forcings
        if not takes_forcings(diffusion):
            base_g = diffusion

            def diffusion(t, y, ps, u, _g=base_g):
                return _g(t, y, ps)
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
    if pshapes is not None:
        pshapes = tuple(tuple(int(d) for d in s) for s in pshapes)
        if len(pshapes) != len(pnames):
            raise ValueError(f"pshapes has {len(pshapes)} entries for "
                             f"{len(pnames)} parameters")
    return ModelSpec(rhs=rhs, pnames=pnames, snames=snames, pshapes=pshapes,
                     sum_matrix=sum_matrix, post_snames=post_snames,
                     obs_model=obs_model, obs_param=obs_param,
                     dose_events=dose_events, diffusion=diffusion,
                     forcings=forcings)


# --------------------------------------------------------------------------
# batched integration and scoring (torch, any device and dtype)
# --------------------------------------------------------------------------

def rhs_program(spec: ModelSpec):
    """The spec's traced RHS (:func:`~odelib_tpu_torch.rhs.trace_rhs`);
    raises ``RhsTraceError`` for one that does not trace."""
    from .rhs import trace_rhs
    return trace_rhs(spec.rhs, len(spec.snames), spec.pshapes, spec.forcings)


def diffusion_program(spec: ModelSpec):
    """The spec's traced diffusion, as :func:`rhs_program`."""
    from .rhs import trace_rhs
    return trace_rhs(spec.diffusion, len(spec.snames), spec.pshapes,
                     spec.forcings)


@lru_cache(maxsize=256)
def spec_columns(spec: ModelSpec) -> tuple:
    """The forcing columns of every kernel of the spec's model, in the
    order of the plan's forcing table (:func:`~odelib_tpu_torch.rhs.
    forcing_columns` of its traced RHS and diffusion); () without forcings
    or where nothing traces (the CPU twins then run the functions
    eagerly, which evaluate the forcings themselves)."""
    if not spec.forcings:
        return ()
    from .rhs import RhsTraceError, forcing_columns
    try:
        prog = rhs_program(spec)
    except RhsTraceError:
        return ()
    diff = None
    if spec.diffusion is not None:
        try:
            diff = diffusion_program(spec)
        except RhsTraceError:
            diff = None
    return forcing_columns(prog, diff)


def forcing_rows(spec: ModelSpec, times) -> np.ndarray:
    """(len(times), F) float64: each forcing column of
    :func:`spec_columns` at each concrete time, folded in double as
    ``odelib_tpu``'s kernels fold it (:func:`~odelib_tpu_torch.rhs.
    fold_host`); the kernels' table rounds it to float32 once."""
    from .rhs import fold_host
    cols = spec_columns(spec)
    out = np.zeros((len(times), len(cols)))
    for i, t in enumerate(times):
        raw = eval_forcings(spec.forcings, float(t))
        out[i] = [fold_host(c, raw) for c in cols]
    return out


def column_values(spec: ModelSpec, t, like=None) -> dict:
    """Each forcing column of the spec at time ``t``: folded in double at
    a concrete time, at a tensor time in its dtype (the torch solvers);
    keyed by column, as :meth:`~odelib_tpu_torch.rhs.RhsProgram.evaluate`
    takes them."""
    from .rhs import fold_host, fold_torch
    cols = spec_columns(spec)
    if not isinstance(t, torch.Tensor):
        raw = eval_forcings(spec.forcings, float(t))
        return {c: fold_host(c, raw) for c in cols}
    if like is not None and t.dtype != like.dtype:
        t = t.to(like.dtype)
    raw = eval_forcings(spec.forcings, t)
    return {c: fold_torch(c, raw) for c in cols}


def traces(spec: ModelSpec) -> bool:
    """Whether the spec's RHS traces into the kernels' DAG
    (:func:`rhs_program`)."""
    from .rhs import RhsTraceError
    try:
        rhs_program(spec)
    except RhsTraceError:
        return False
    return True


def state_func(spec: ModelSpec):
    """``func(t, y (S, N), ps) -> (S, N)`` for the integrators, ``ps`` the
    per-slot values; a forced model's columns at ``t`` (float or tensor,
    :func:`column_values`). An RHS the tracer refuses is called per lane
    through ``torch.func.vmap`` (:func:`~odelib_tpu_torch.rhs.
    lane_function`, the JAX package's vmapped solve); where ``vmap``
    refuses it on the first call (Python control flow on a value,
    :func:`~odelib_tpu_torch.rhs.vmap_refused`), eagerly on the whole
    batch from then on. Any other error propagates."""
    return _batched(spec, spec.rhs, rhs_program(spec) if traces(spec)
                    else None)


def diffusion_func(spec: ModelSpec):
    """:func:`state_func` of an SDE model's diffusion, the diagonal noise
    ``g(t, y (S, N), ps) -> (S, N)``: the traced program where the drift
    and the diffusion both trace (the forcing columns are the drift's and
    the diffusion's), else the diffusion called per lane."""
    from .rhs import RhsTraceError
    prog = None
    if traces(spec):
        try:
            prog = diffusion_program(spec)
        except RhsTraceError:
            prog = None
    return _batched(spec, spec.diffusion, prog)


def diffusion_diagonal(spec: ModelSpec):
    """``dg(t, y (S, N), ps) -> (S, N)``, d g_s / d y_s of the diffusion
    (the Milstein correction's derivative, ``jax.jacfwd``'s diagonal in
    the JAX package): the traced diffusion's
    :meth:`~odelib_tpu_torch.rhs.RhsProgram.diagonal`
    (:func:`~odelib_tpu_torch.rhs.diagonal_evaluator`), or for a diffusion
    that does not trace (or has an operation without a derivative rule)
    the diagonal of :func:`~odelib_tpu_torch.rhs.lane_jacobian`."""
    from .rhs import RhsTraceError, diagonal_evaluator, lane_jacobian
    d = None
    if traces(spec):
        try:
            diffusion_program(spec).diagonal()
            d = diagonal_evaluator(spec.diffusion, len(spec.snames),
                                   spec.pshapes, spec.forcings)
        except RhsTraceError:
            d = None
    if d is None:
        jac = lane_jacobian(spec.diffusion, spec.pshapes, spec.forcings)
        return lambda t, y, ps: torch.diagonal(jac(t, y, ps), dim1=0,
                                               dim2=1).t()
    if not spec_columns(spec):
        return lambda t, y, ps: torch.stack(d(t, list(y), ps))
    return lambda t, y, ps: torch.stack(
        d(t, list(y), ps, column_values(spec, t, y)))


def _batched(spec: ModelSpec, fn, program):
    """``f(t, y (S, N), ps) -> (S, N)`` of ``fn`` (the RHS or the
    diffusion): its traced ``program``'s evaluator, or with ``program``
    None the function per lane, then eagerly where ``vmap`` refuses it
    (:func:`state_func`)."""
    from .rhs import eager_function, lane_function, vmap_refused
    if program is None:
        lanes = lane_function(fn, spec.pshapes, spec.forcings)
        eager = eager_function(fn, spec.pshapes, spec.forcings)
        mode = []

        def f(t, y, ps):
            if not mode:
                try:
                    out = lanes(t, y, ps)
                    mode.append(lanes)
                    return out
                except RuntimeError as e:
                    if not vmap_refused(e):
                        raise
                    mode.append(lambda t_, y_, p_: torch.stack(
                        eager(t_, list(y_), p_)))
            return mode[0](t, y, ps)
        return f
    f = program.evaluate
    if not spec_columns(spec):
        return lambda t, y, ps: torch.stack(f(t, list(y), ps))
    return lambda t, y, ps: torch.stack(
        f(t, list(y), ps, column_values(spec, t, y)))


def state_jac(spec: ModelSpec):
    """``jac(t, y (S, N), ps) -> (S, S, N)``: the RHS's Jacobian in the
    states from the traced DAG's forward-mode columns
    (:meth:`~odelib_tpu_torch.rhs.RhsProgram.jacobian`), for the implicit
    integrators; for an RHS the tracer refuses, ``torch.func.jacfwd`` of
    each lane (:func:`~odelib_tpu_torch.rhs.lane_jacobian`)."""
    from .rhs import jacobian_evaluator, lane_jacobian
    S = len(spec.snames)
    if not traces(spec):
        return lane_jacobian(spec.rhs, spec.pshapes, spec.forcings)
    J = jacobian_evaluator(spec.rhs, S, spec.pshapes, spec.forcings)
    forced = bool(spec_columns(spec))

    def jac(t, y, ps):
        u = column_values(spec, t, y) if forced else None
        cols = J(t, list(y), ps, u)
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
    ps = spec.slots(thetas)
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


def sdeint_theta(spec: ModelSpec, theta, y0, times, key, *, substeps=4,
                 method="euler", device="cuda"):
    """Stochastic paths of the spec's SDE (it needs ``diffusion=``):
    ``theta`` (P,) or (N, P) flat parameters (a tensor keeps its device,
    an array goes to ``device``), ``y0`` (S,) with the '<s>0' overrides,
    ``key`` (2,) or (N, 2), in float64 unless ``theta`` is a float32
    tensor. Euler-Maruyama or Milstein (``method``) with ``substeps`` per
    interval of ``times`` (:func:`~odelib_tpu_torch.ops.sde.sde_paths`);
    the doses apply at their nearest grid points as in
    :func:`integrate_theta`. Returns raw-state ys (T, S) for one theta and
    key, (N, T, S) for a batch, NaN-tailed after a failure."""
    if spec.diffusion is None:
        raise ValueError("spec has no diffusion function — pass "
                         "diffusion= to make_spec for SDE simulation")
    from .ops.sde import sde_paths
    dtype = theta.dtype if isinstance(theta, torch.Tensor) \
        and theta.dtype == torch.float32 else torch.float64
    theta = device_tensor(theta, dtype, device)
    one = theta.ndim == 1 and torch.as_tensor(key).ndim == 1
    theta = torch.atleast_2d(theta)
    keys = torch.as_tensor(key, dtype=torch.int64).to(theta.device)
    keys = keys.expand(theta.shape[0], 2) if keys.ndim == 1 else keys
    theta = theta.expand(keys.shape[0], -1)
    y0 = torch.as_tensor(np.asarray(y0, np.float64) if not isinstance(
        y0, torch.Tensor) else y0, dtype=dtype, device=theta.device)
    ys = sde_paths(spec, theta, spec.override_inits(y0, theta), times, keys,
                   substeps=substeps, method=method)
    return ys[0] if one else ys


def _col(a, dtype, device):
    """A field of :class:`ObsData` as a tensor: an array is copied to
    ``device``, a tensor already there in ``dtype`` is taken as it is."""
    return torch.as_tensor(a if isinstance(a, torch.Tensor)
                           else np.asarray(a), dtype=dtype, device=device)


def device_obs(obs: ObsData, dtype, device) -> ObsData:
    """:class:`ObsData` with every field a tensor on ``device`` (the values
    in ``dtype``, the indices and censor flags int64), made once for the
    samplers' repeated :func:`fit_metrics`."""
    i64 = torch.int64
    return ObsData(
        log_abundance=_col(obs.log_abundance, dtype, device),
        log_sigma=_col(obs.log_sigma, dtype, device),
        abundance=_col(obs.abundance, dtype, device),
        t_index=_col(obs.t_index, i64, device),
        state_index=_col(obs.state_index, i64, device),
        sstot=_col(obs.sstot, dtype, device),
        censor=None if obs.censor is None else _col(obs.censor, i64, device))


def observe(spec: ModelSpec, obs: ObsData, ys):
    """Predictions at the observation points: (T, S_raw, N) -> (N, n_obs),
    after summation."""
    post = spec.apply_summations(ys.permute(2, 0, 1))      # (N, T, S_post)
    return post[:, _col(obs.t_index, torch.int64, ys.device),
                _col(obs.state_index, torch.int64, ys.device)]


def score_pred(spec: ModelSpec, obs: ObsData, pred):
    """Chi of linear-space predictions (N, n_obs) under the spec's
    observation model and the observations' censoring -> (N,)."""
    from . import stats
    dt, dev = pred.dtype, pred.device
    return stats.obs_negloglik(
        spec.obs_model, spec.obs_param, _col(obs.log_abundance, dt, dev),
        torch.log(pred), _col(obs.log_sigma, dt, dev),
        _col(obs.abundance, dt, dev), pred,
        censor=None if obs.censor is None
        else _col(obs.censor, torch.int64, dev))


def fit_metrics(spec: ModelSpec, obs: ObsData, ys, num_params):
    """chi, R^2 and AIC of trajectories ``ys`` (T, S_raw, N) -> three (N,)
    tensors (``odelib_tpu``'s ``fit_metrics``): chi under the spec's
    observation model (:func:`score_pred`), R^2 over the uncensored points
    and ``2 chi + 2 num_params``. ``obs`` from :func:`device_obs` costs no
    copy to the device."""
    from . import stats
    pred = observe(spec, obs, ys)
    dt, dev = pred.dtype, pred.device
    chi = score_pred(spec, obs, pred)
    mask = None if obs.censor is None else \
        _col(obs.censor, torch.int64, dev) == 0
    rsq = stats.rsqrd_flat(pred, _col(obs.abundance, dt, dev),
                           _col(obs.sstot, dt, dev), mask=mask)
    return chi, rsq, stats.AIC(chi, num_params)


def chi_of_theta(spec: ModelSpec, obs: ObsData, thetas, y0, times, **ikw):
    """One survey evaluation per row of ``thetas`` (N, P): integrate from
    ``y0`` (S,) with the '<s>0' overrides, observe and score -> chi (N,),
    on ``thetas``' device and dtype."""
    y0 = torch.as_tensor(y0, dtype=thetas.dtype, device=thetas.device)
    ys = integrate_theta(spec, thetas, spec.override_inits(y0, thetas),
                         times, **ikw)
    return score_pred(spec, obs, observe(spec, obs, ys))
