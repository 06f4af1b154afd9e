"""ODE integration on a fixed output grid, batched over lanes.

Counterpart of ``odeint_grid`` (adaptive; Dopri5 only, the Kvaerno methods
are ROADMAP queue 1, item 14) and ``odeint_fixed`` (fixed steps, dopri5 or
rk4; kvaerno3 is item 14) in ``odelib_tpu/ops/integrate.py``. The JAX
``odeint_grid`` is one solve vmapped over lanes; here every lane is a
column of an (S, N) state and steps in lock-step, with a per-lane done mask
taking the place of the per-lane ``while_loop``: a lane that reached its
output time, failed or spent ``max_steps`` keeps its state exactly while
the others advance.
Step control (safety 0.9, factor clip [0.2, 10], RMS error norm, Hairer's
initial step), the failure model (NaN from the failure on, ``ok`` False)
and bolus doses (``dose[i]`` joins the state when the solve leaves
``ts[i]``; a dosed adaptive solve steps to the output points) are the JAX
package's.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .runge_kutta import Dopri5

_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 10.0


class ODESolution(NamedTuple):
    ys: Any           # (T, S) or (T, S, N) solution values at ts
    ok: Any           # bool (or (N,)): False if the solve failed anywhere
    num_steps: Any    # step attempts (per lane)
    accepted_at: Any  # (T,) or (T, N) cumulative accepted steps at each ts


def _rms_norm(x):
    return torch.sqrt(torch.mean(x * x, dim=0))


def _initial_step(func, t0, y0, f0, args, rtol, atol):
    """Hairer-style automatic initial step (HNW vol. 1, p. 169)."""
    scale = atol + rtol * torch.abs(y0)
    d0 = _rms_norm(y0 / scale)
    d1 = _rms_norm(f0 / scale)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5),
                     torch.full_like(d0, 1e-6), 0.01 * d0 / d1)
    y1 = y0 + h0 * f0
    f1 = func(t0 + h0, y1, args)
    d2 = _rms_norm((f1 - f0) / scale) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= 1e-15, torch.clamp(h0 * 1e-3, min=1e-6),
                     (0.01 / dmax) ** 0.2)
    return torch.minimum(100.0 * h0, h1)


def _dose_rows(dose, ts, y):
    """``dose`` (T, S) as (S, 1) rows in ``y``'s dtype and device, or
    None."""
    if dose is None:
        return None
    d = torch.as_tensor(dose, dtype=y.dtype, device=y.device)
    if d.shape != (len(ts), y.shape[0]):
        raise ValueError(f"dose must be (len(ts), S) = ({len(ts)}, "
                         f"{y.shape[0]}), got {tuple(d.shape)}")
    return [row[:, None] for row in d]


def odeint_grid(func, y0, ts, args=(), *, rtol=1e-7, atol=1e-9,
                max_steps=4096, method="dopri5", dose=None):
    """Integrate dy/dt = func(t, y, args) and report y at every time in
    ``ts`` (increasing, ``ts[0]`` the initial time).

    ``y0`` is (S,) for one solve or (S, N) for N lanes; ``func`` receives
    ``t`` of shape (N,) and ``y`` of shape (S, N) and returns (S, N).
    ``args`` are passed through (per-lane parameters broadcast against
    (N,)). ``dose`` (optional, (len(ts), S)): ``dose[i]`` is added when
    the solve leaves ``ts[i]`` (the RHS is evaluated again there), so
    ``ys[i]`` is the pre-dose left limit; a dosed solve steps exactly to
    each output point. Returns :class:`ODESolution` with ``ys``
    (T, S[, N]).
    """
    if method != "dopri5":
        raise NotImplementedError(
            f"method={method!r}: only adaptive dopri5 is ported (Kvaerno: "
            "ROADMAP queue 1, item 14)")
    single = y0.ndim == 1
    y = y0[:, None] if single else y0
    dtype, dev = y.dtype, y.device
    ts = torch.as_tensor(ts, dtype=dtype, device=dev)
    doses = _dose_rows(dose, ts, y)
    N = y.shape[1]
    tiny = torch.finfo(dtype).tiny ** 0.5
    err_exp = -1.0 / Dopri5.ERROR_ORDER

    t = ts[0].expand(N).clone()
    f = Dopri5.first_stage(func, t, y, args)
    h = torch.clamp(_initial_step(func, t, y, f, args, rtol, atol), min=tiny)
    t_prev, h_prev = t.clone(), torch.ones_like(t)
    dense = Dopri5.dense_zero(y)
    nsteps = torch.zeros(N, dtype=torch.int64, device=dev)
    nacc = torch.zeros_like(nsteps)
    ok = torch.ones(N, dtype=torch.bool, device=dev)
    ys, acc_at = [y.clone()], [nacc.clone()]
    for i, target in enumerate(ts[1:]):
        if doses is not None:
            y = y + doses[i]
            f = Dopri5.first_stage(func, t, y, args)
        while True:
            active = ok & (t < target) & (nsteps < max_steps)
            if not bool(active.any()):
                break
            # a dosed solve steps to the output point: the impulse there
            # ends every dense polynomial
            h_try = h if doses is None else torch.minimum(h, target - t)
            y_new, f_new, err, dense_new = Dopri5.step(func, t, y, f, h_try,
                                                       args)
            scale = atol + rtol * torch.maximum(torch.abs(y),
                                                torch.abs(y_new))
            ratio = _rms_norm(err / scale)
            bad = ~torch.isfinite(ratio) | ~torch.all(torch.isfinite(y_new),
                                                      dim=0)
            ratio = torch.where(bad, torch.full_like(ratio, torch.inf),
                                ratio)
            accept = ratio <= 1.0
            factor = torch.where(
                ratio == 0.0, torch.full_like(ratio, _MAX_FACTOR),
                torch.clamp(_SAFETY * ratio ** err_exp, _MIN_FACTOR,
                            _MAX_FACTOR))
            factor = torch.where(accept, factor, torch.clamp(factor, max=1.0))
            h_next = h_try * factor
            if doses is not None:
                # an accepted truncated step keeps the controller's h
                h_next = torch.where(accept & (h_try < h), h, h_next)
            still_ok = ok & (h_next > tiny) & torch.isfinite(h_next)
            take = active & accept
            t_prev = torch.where(take, t, t_prev)
            h_prev = torch.where(take, h_try, h_prev)
            t = torch.where(take, t + h_try, t)
            y = torch.where(take, y_new, y)
            f = torch.where(take, f_new, f)
            dense = torch.where(take, dense_new, dense)
            h = torch.where(active, h_next, h)
            ok = torch.where(active, still_ok, ok)
            nsteps = nsteps + active.long()
            nacc = nacc + take.long()
        reached = t >= target
        theta = torch.clamp((target - t_prev) / h_prev, 0.0, 1.0)
        y_t = Dopri5.interp(dense, theta)
        ys.append(torch.where(reached, y_t, torch.full_like(y_t, torch.nan)))
        ok = ok & reached
        acc_at.append(nacc.clone())
    ys = torch.stack(ys)
    acc_at = torch.stack(acc_at)
    if single:
        return ODESolution(ys=ys[..., 0], ok=bool(ok[0]),
                           num_steps=int(nsteps[0]),
                           accepted_at=acc_at[:, 0])
    return ODESolution(ys=ys, ok=ok, num_steps=nsteps, accepted_at=acc_at)


def odeint_fixed(func, y0, ts, args=(), *, substeps=1, method="rk4",
                 dose=None):
    """Fixed-step integration on the grid ``ts``, every interval split into
    ``substeps`` equal steps (an int, or one int per interval: a static
    schedule). ``method`` is 'rk4' or 'dopri5' (its error estimate
    unused). Shapes, ``func`` and ``dose`` as :func:`odeint_grid` (the dose
    joins before an interval's first substep); the step sizes and
    times are computed in the state's dtype as ``odelib_tpu``'s
    ``odeint_fixed`` computes them. Returns :class:`ODESolution` with
    ``ok`` False where a value is not finite and ``accepted_at`` None."""
    if method == "rk4":
        def substep(t, y, h):
            k1 = func(t, y, args)
            k2 = func(t + 0.5 * h, y + 0.5 * h * k1, args)
            k3 = func(t + 0.5 * h, y + 0.5 * h * k2, args)
            k4 = func(t + h, y + h * k3, args)
            return y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    elif method == "dopri5":
        def substep(t, y, h):
            f0 = Dopri5.first_stage(func, t, y, args)
            return Dopri5.step(func, t, y, f0, h, args)[0]
    elif method == "kvaerno3":
        raise NotImplementedError(
            "fixed-step kvaerno3 is not ported yet (ROADMAP queue 1, item 14)")
    else:
        raise ValueError(f"unknown fixed method {method!r}")
    single = y0.ndim == 1
    y = y0[:, None] if single else y0
    ts = torch.as_tensor(ts, dtype=y.dtype, device=y.device)
    n_int = ts.shape[0] - 1
    sched = [int(substeps)] * n_int if isinstance(substeps, int) \
        else [int(v) for v in substeps]
    if len(sched) != n_int or min(sched, default=1) < 1:
        raise ValueError(f"substeps must be >= 1, one per interval "
                         f"({n_int})")
    doses = _dose_rows(dose, ts, y)
    ys = [y]
    for i in range(n_int):
        if doses is not None:
            y = y + doses[i]
        h = (ts[i + 1] - ts[i]) / sched[i]
        for k in range(sched[i]):
            y = substep(ts[i] + k * h, y, h)
        ys.append(y)
    ys = torch.stack(ys)
    ok = torch.isfinite(ys).flatten(0, 1).all(dim=0)
    if single:
        return ODESolution(ys=ys[..., 0], ok=bool(ok[0]),
                           num_steps=sum(sched), accepted_at=None)
    return ODESolution(ys=ys, ok=ok, num_steps=sum(sched), accepted_at=None)
