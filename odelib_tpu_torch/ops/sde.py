"""Fixed-grid SDE integration with diagonal noise, batched over paths.

Counterpart of ``odelib_tpu/ops/sde.py``: ``dy = f(t, y) dt + g(t, y) dW``
by Euler-Maruyama, or Milstein (the diagonal correction
``0.5 g_s (d g_s / d y_s) (xi^2 - 1) h``), on the output grid, its
intervals times ``substeps`` flattened into one loop of substeps. The
increment of global substep ``j`` is ``normal(fold_in(key, j), (S,))`` of
the port's ``jax.random`` stream (:mod:`odelib_tpu_torch.random`), so a
path is the reference's path for the same key; a batch of keys is a batch
of independent paths, every path a lane of each substep. A dose row joins
the state as the integration leaves its grid point (reported rows are the
pre-dose values), and a diverged path turns to NaN with ``ok`` False,
never raising.

The step sizes and start times are host values: ``h = (t[i+1] - t[i]) /
substeps`` is divided on the host in the grid's dtype, as the reference
divides by a dtype scalar, and enters the step as a Python number (CUDA
would otherwise divide a tensor by a scalar through its reciprocal).
:func:`euler_maruyama` is the one step the paths here and the particle
filter (:mod:`odelib_tpu_torch.samplers.pf`) take.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .. import random as jr

__all__ = ["SDESolution", "sdeint_fixed", "sde_paths", "flat_schedule",
           "euler_maruyama"]

_NP = {torch.float64: np.float64, torch.float32: np.float32}


class SDESolution(NamedTuple):
    ys: Any   # (..., T, S) states at the output grid (ys[..., 0, :] == y0)
    ok: Any   # (...,) bool: every output value of the path finite


def check_method(method: str, substeps) -> int:
    """The reference's checks of ``method`` and ``substeps``; the
    substeps as an int."""
    if method not in ("euler", "milstein"):
        raise ValueError(f"method must be 'euler' or 'milstein', "
                         f"got {method!r}")
    substeps = int(substeps)
    if substeps < 1:
        raise ValueError("substeps must be >= 1")
    return substeps


def flat_schedule(ts, substeps: int, dtype=torch.float64):
    """The grid's intervals x substeps flattened, in ``dtype`` on the host:
    each substep's interval ``ii`` and index in it ``kk``, its start time,
    its step ``h`` and ``sqrt(h)``, and the flat index of each interval's
    last substep (``odelib_tpu/ops/sde.py``'s static index arrays)."""
    npd = _NP[dtype]
    ts = np.asarray(ts, npd)
    n_int = len(ts) - 1
    ii = np.repeat(np.arange(n_int), substeps)
    kk = np.tile(np.arange(substeps), n_int)
    h = (ts[1:] - ts[:-1])[ii] / npd(substeps)
    t0 = ts[ii] + kk.astype(npd) * h
    return ii, kk, t0, h, np.sqrt(h), np.arange(1, n_int + 1) * substeps - 1


def euler_maruyama(y, f, g, x, h: float, sqrt_h: float, dg=None):
    """One step ``y + h f + sqrt(h) g x``, with ``dg`` (d g / d y's
    diagonal) plus Milstein's ``0.5 g dg (x^2 - 1) h``, in the
    reference's order of operations."""
    y1 = y + h * f + sqrt_h * g * x
    if dg is not None:
        y1 = y1 + 0.5 * g * dg * (x * x - 1.0) * h
    return y1


def _stacked(v, like):
    """A function's value as a tensor of ``like``'s shape and dtype: a
    sequence of per-state values stacks on the last axis."""
    if not isinstance(v, torch.Tensor):
        v = torch.stack([torch.as_tensor(c, dtype=like.dtype,
                                         device=like.device) for c in v], -1)
    return torch.broadcast_to(v.to(like.dtype), like.shape)


def _diagonal(g, t, y, args):
    """d g_s / d y_s of a per-path function ``g(t, y (..., S), args)``:
    one forward-mode derivative along each state's one-hot tangent on
    every path (``jax.jacfwd``'s diagonal)."""
    cols = []
    for s in range(y.shape[-1]):
        e = torch.zeros_like(y)
        e[..., s] = 1.0
        _, tan = torch.func.jvp(lambda yy: _stacked(g(t, yy, args), yy),
                                (y,), (e,))
        cols.append(tan[..., s])
    return torch.stack(cols, -1)


def sdeint_fixed(drift, diffusion, y0, ts, key, args=(), *, substeps=4,
                 method="euler", dose=None, device="cuda") -> SDESolution:
    """Integrate ``dy = f(t, y) dt + g(t, y) dW`` on the output grid
    ``ts`` for each key of ``key``.

    ``drift(t, y, args)`` and ``diffusion(t, y, args)`` take ``y`` of shape
    (..., S) (the paths on the leading axes; a function of one path's
    states written elementwise takes them as they are) and return its
    shape, or a sequence of S per-state values; ``t`` is a 0-dim tensor.
    The noise is diagonal: state ``i`` receives ``g_i dW_i``. ``y0`` (S,)
    or (..., S): a tensor runs on its device, an array on ``device`` (the
    card by default); its dtype is kept (float64 otherwise). ``key`` (2,)
    or (..., 2), broadcast against ``y0``'s leading axes: the increment of
    global substep ``j`` is ``normal(fold_in(key, j), (S,))``. ``method``
    'euler' (strong order 0.5) or 'milstein' (the derivative by
    ``torch.func.jvp``); ``substeps`` uniform substeps an interval;
    ``dose`` (T, S): ``dose[i]`` joins the state when integration leaves
    ``ts[i]``. Returns :class:`SDESolution` with ``ys`` (..., T, S)."""
    from ..model import device_tensor
    substeps = check_method(method, substeps)
    dtype = y0.dtype if isinstance(y0, torch.Tensor) \
        and y0.dtype in _NP else torch.float64
    y0 = device_tensor(y0, dtype, device)
    dev = y0.device
    key = torch.as_tensor(key, dtype=torch.int64).to(dev)
    S = y0.shape[-1]
    batch = torch.broadcast_shapes(tuple(key.shape[:-1]),
                                   tuple(y0.shape[:-1]))
    ii, kk, t0, h, sq, ends = flat_schedule(ts, substeps, dtype)
    J = len(h)
    y = y0.expand(batch + (S,))
    if J == 0:
        ys = y[..., None, :]
        return SDESolution(ys=ys, ok=torch.isfinite(ys).all(-1).all(-1))
    xi = jr.normal(jr.fold_in(key[..., None, :],
                              torch.arange(J, device=dev)), (S,), dtype)
    xi = xi.expand(batch + (J, S))
    dose_rows = None if dose is None else \
        np.asarray(dose, _NP[dtype])[ii] * (kk == 0)[:, None]
    out, e = [y], 0
    for j in range(J):
        if dose_rows is not None and kk[j] == 0:
            y = y + torch.as_tensor(dose_rows[j], device=dev)
        t = torch.tensor(t0[j], dtype=dtype, device=dev)
        x = xi[..., j, :]
        dg = _diagonal(diffusion, t, y, args) if method == "milstein" \
            else None
        y = euler_maruyama(y, _stacked(drift(t, y, args), y),
                           _stacked(diffusion(t, y, args), y), x,
                           float(h[j]), float(sq[j]), dg).to(dtype)
        if j == ends[e]:
            out.append(y)
            e += 1
    ys = torch.stack(out, -2)
    return SDESolution(ys=ys, ok=torch.isfinite(ys).all(-1).all(-1))


def sde_functions(spec, milstein: bool):
    """The spec's drift, diffusion and (with ``milstein``) the diffusion's
    diagonal derivative, each ``(t, y (S, N), ps) -> (S, N)``
    (:func:`~odelib_tpu_torch.model.state_func`, ``diffusion_func``,
    ``diffusion_diagonal``)."""
    from ..model import diffusion_diagonal, diffusion_func, state_func
    return (state_func(spec), diffusion_func(spec),
            diffusion_diagonal(spec) if milstein else None)


def propagate(fns, y, ps, t0, h, sq, xs, dose_rows=None, keep=None):
    """The substeps ``0 .. len(h) - 1`` of the (S, N) states ``y``: each
    adds its dose row (``dose_rows[j]``, (S,) or None), evaluates the
    drift and diffusion (``fns`` of :func:`sde_functions`) at ``t0[j]``
    and takes :func:`euler_maruyama` with the increments ``xs[j]`` (S, N).
    Returns the final states, and with ``keep`` (a set of substep
    indices) also the states after each of those substeps."""
    f, g, dg = fns
    dtype = y.dtype
    kept = []
    for j in range(len(h)):
        if dose_rows is not None and dose_rows[j] is not None:
            y = y + dose_rows[j][:, None]
        t = float(t0[j])
        y = euler_maruyama(y, f(t, y, ps), g(t, y, ps), xs[j], float(h[j]),
                           float(sq[j]),
                           None if dg is None else dg(t, y, ps)).to(dtype)
        if keep is not None and j in keep:
            kept.append(y)
    return y, kept


def sde_paths(spec, thetas, y0, times, keys, *, substeps=4,
              method="euler"):
    """Paths of a spec's SDE: ``thetas`` (N, P) flat parameters, ``y0``
    (S, N) initial states, ``keys`` (N, 2), on the thetas' device and
    dtype; the spec's doses snap to the grid ``times`` as
    :func:`~odelib_tpu_torch.model.dose_matrix` places them. Path ``n``
    draws substep ``j``'s increment from ``normal(fold_in(keys[n], j),
    (S,))``. Returns raw-state ys (N, T, S), NaN from a failure on."""
    from ..model import dose_matrix
    substeps = check_method(method, substeps)
    dtype, dev = thetas.dtype, thetas.device
    S = len(spec.snames)
    ii, kk, t0, h, sq, ends = flat_schedule(times, substeps, dtype)
    J = len(h)
    if J == 0:
        return y0.t()[:, None, :]
    xs = jr.normal(jr.fold_in(keys[:, None, :],
                              torch.arange(J, device=dev)), (S,), dtype)
    xs = xs.permute(1, 2, 0)                               # (J, S, N)
    dose = dose_matrix(spec, times)
    rows = None
    if dose is not None:
        rows = [torch.as_tensor(dose[ii[j]], dtype=dtype, device=dev)
                if kk[j] == 0 else None for j in range(J)]
    fns = sde_functions(spec, method == "milstein")
    _, kept = propagate(fns, y0, spec.slots(thetas), t0, h, sq, xs, rows,
                        keep=set(int(e) for e in ends))
    return torch.stack([y0] + kept).permute(2, 0, 1)
