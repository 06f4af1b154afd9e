"""ODE integration on a fixed output grid, batched over lanes.

Counterpart of ``odeint_grid`` (adaptive Dopri5, Kvaerno3 and Kvaerno5,
and 'auto'), ``odeint_fixed`` (fixed steps: rk4, dopri5 or kvaerno3) and
``odeint_grid_batch`` (the two-pass stiff fallback) in
``odelib_tpu/ops/integrate.py``. The JAX
``odeint_grid`` is one solve vmapped over lanes; here every lane is a
column of an (S, N) state and steps in lock-step, with a per-lane done mask
taking the place of the per-lane ``while_loop``: a lane that reached its
output time, failed or spent ``max_steps`` keeps its state exactly while
the others advance.
Step control (safety 0.9, factor clip [0.2, 10], RMS error norm, Hairer's
initial step), the failure model (NaN from the failure on, ``ok`` False)
bolus doses (``dose[i]`` joins the state when the solve leaves
``ts[i]``; a dosed adaptive solve steps to the output points) and the
implicit methods' stepping to each output point are the JAX package's.
The implicit steppers take their Jacobian from ``jac(t, y, args)`` ->
(S, S, N) where the caller has one (the traced RHS's columns,
:func:`~odelib_tpu_torch.model.state_jac`), else from the forward-mode
columns of ``func`` (``torch.func.jvp``, as the JAX package's
``jax.jacfwd``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..rhs import jvp_columns
from .runge_kutta import STEPPERS, Dopri5, kvaerno3_fixed_step

_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 10.0


class ODESolution(NamedTuple):
    ys: Any           # (T, S) or (T, S, N) solution values at ts
    ok: Any           # bool (or (N,)): False if the solve failed anywhere
    num_steps: Any    # step attempts (per lane)
    accepted_at: Any  # (T,) or (T, N) cumulative accepted steps at each ts
    # (K,) or (K, N) end times of the first K accepted steps (with
    # ``record_step_times=K``; entries past the accepted count are NaN)
    step_times: Any = None


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


def _jacobian(func, jac):
    """``jac`` as ``(t, y, args) -> (S, S, N)``, or the forward-mode
    columns of ``func`` where it is None."""
    if jac is not None:
        return jac
    return lambda t, y, args: torch.stack(
        jvp_columns(lambda yy: func(t, yy, args), y), dim=1)


def _take_lanes(args, idx, N):
    """``args`` with every tensor of leading size N cut to lanes ``idx``
    (lists and tuples recursively; anything else is shared)."""
    if isinstance(args, (list, tuple)):
        return type(args)(_take_lanes(a, idx, N) for a in args)
    if isinstance(args, torch.Tensor) and args.ndim and args.shape[0] == N:
        return args[idx]
    return args


def odeint_grid(func, y0, ts, args=(), *, rtol=1e-7, atol=1e-9,
                max_steps=4096, method="dopri5", dose=None,
                record_step_times=0, jac=None):
    """Integrate dy/dt = func(t, y, args) and report y at every time in
    ``ts`` (increasing, ``ts[0]`` the initial time).

    ``y0`` is (S,) for one solve or (S, N) for N lanes; ``func`` receives
    ``t`` of shape (N,) and ``y`` of shape (S, N) and returns (S, N).
    ``args`` are passed through (per-lane parameters broadcast against
    (N,)). ``method`` 'dopri5', the L-stable 'kvaerno3' or 'kvaerno5'
    (which step to each output point: their cubic-Hermite dense output
    does not hold across long steps; ``jac`` as the module says), or
    'auto': Dopri5, and Kvaerno5 for the lanes Dopri5 failed (their
    solution, counts included, replaces Dopri5's, as the JAX package's
    ``lax.cond`` picks per lane). ``dose`` (optional, (len(ts), S)):
    ``dose[i]`` is added when the solve leaves ``ts[i]`` (the RHS is
    evaluated again there), so ``ys[i]`` is the pre-dose left limit; a
    dosed solve steps exactly to each output point.
    ``record_step_times=K`` records the end times of the first K
    accepted steps (``auto_stiff_grid``'s input). Returns
    :class:`ODESolution` with ``ys`` (T, S[, N]).
    """
    kw = dict(rtol=rtol, atol=atol, max_steps=max_steps, dose=dose,
              record_step_times=record_step_times, jac=jac)
    if y0.ndim == 1:
        sol = odeint_grid(func, y0[:, None], ts, args, method=method, **kw)
        return ODESolution(
            ys=sol.ys[..., 0], ok=bool(sol.ok[0]),
            num_steps=int(sol.num_steps[0]), accepted_at=sol.accepted_at[:, 0],
            step_times=None if sol.step_times is None
            else sol.step_times[:, 0])
    if method == "auto":
        sol = odeint_grid(func, y0, ts, args, method="dopri5", **kw)
        bad = torch.nonzero(~sol.ok).flatten()
        if len(bad) == 0:
            return sol
        stiff = odeint_grid(func, y0[:, bad], ts,
                            _take_lanes(args, bad, y0.shape[1]),
                            method="kvaerno5", **kw)
        ys, ok, ns, acc = (sol.ys.clone(), sol.ok.clone(),
                           sol.num_steps.clone(), sol.accepted_at.clone())
        ys[..., bad], ok[bad], ns[bad], acc[:, bad] = (
            stiff.ys, stiff.ok, stiff.num_steps, stiff.accepted_at)
        st = sol.step_times
        if st is not None:
            st = st.clone()
            st[:, bad] = stiff.step_times
        return ODESolution(ys=ys, ok=ok, num_steps=ns, accepted_at=acc,
                           step_times=st)
    if method not in STEPPERS:
        raise ValueError(f"unknown method {method!r}: 'dopri5', "
                         "'kvaerno3', 'kvaerno5' or 'auto'")
    stepper = STEPPERS[method]
    implicit = getattr(stepper, "IMPLICIT", False)
    step_args = (_jacobian(func, jac),) if implicit else ()
    y = y0
    dtype, dev = y.dtype, y.device
    ts = torch.as_tensor(ts, dtype=dtype, device=dev)
    doses = _dose_rows(dose, ts, y)
    # implicit steppers and dosed solves step to the output points
    step_to_output = implicit or doses is not None
    N = y.shape[1]
    tiny = torch.finfo(dtype).tiny ** 0.5
    err_exp = -1.0 / stepper.ERROR_ORDER

    t = ts[0].expand(N).clone()
    f = stepper.first_stage(func, t, y, args)
    h = torch.clamp(_initial_step(func, t, y, f, args, rtol, atol), min=tiny)
    t_prev, h_prev = t.clone(), torch.ones_like(t)
    dense = stepper.dense_zero(y)
    nsteps = torch.zeros(N, dtype=torch.int64, device=dev)
    nacc = torch.zeros_like(nsteps)
    ok = torch.ones(N, dtype=torch.bool, device=dev)
    K = int(record_step_times)
    step_ts = torch.full((K, N), torch.nan, dtype=dtype, device=dev) \
        if K else None
    ys, acc_at = [y.clone()], [nacc.clone()]
    for i, target in enumerate(ts[1:]):
        if doses is not None:
            y = y + doses[i]
            f = stepper.first_stage(func, t, y, args)
        while True:
            active = ok & (t < target) & (nsteps < max_steps)
            if not bool(active.any()):
                break
            h_try = torch.minimum(h, target - t) if step_to_output else h
            y_new, f_new, err, dense_new = stepper.step(
                func, t, y, f, h_try, args, *step_args)
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
            if step_to_output:
                # an accepted truncated step keeps the controller's h
                h_next = torch.where(accept & (h_try < h), h, h_next)
            still_ok = ok & (h_next > tiny) & torch.isfinite(h_next)
            take = active & accept
            if K:
                row = torch.clamp(nacc, max=K - 1)[None]
                step_ts.scatter_(0, row, torch.where(
                    take, t + h_try, step_ts.gather(0, row)[0])[None])
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
        y_t = stepper.interp(dense, theta)
        ys.append(torch.where(reached, y_t, torch.full_like(y_t, torch.nan)))
        ok = ok & reached
        acc_at.append(nacc.clone())
    return ODESolution(ys=torch.stack(ys), ok=ok, num_steps=nsteps,
                       accepted_at=torch.stack(acc_at), step_times=step_ts)


def odeint_fixed(func, y0, ts, args=(), *, substeps=1, method="rk4",
                 dose=None, jac=None):
    """Fixed-step integration on the grid ``ts``, every interval split into
    ``substeps`` equal steps (an int, or one int per interval: a static
    schedule). ``method`` is 'rk4', 'dopri5' (its error estimate unused)
    or 'kvaerno3' (the kernels' implicit stepper,
    :func:`~.runge_kutta.kvaerno3_fixed_step`, its Jacobian from ``jac``
    as :func:`odeint_grid`'s: the batched stiff path on a graded grid).
    Shapes, ``func`` and ``dose`` as :func:`odeint_grid` (the dose
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
        J = _jacobian(func, jac)

        def substep(t, y, h):
            S = y.shape[0]
            return torch.stack(kvaerno3_fixed_step(
                lambda tt, yy, a: list(func(tt, torch.stack(yy), a)), t,
                list(y), h, args,
                lambda tt, yy, a: list(J(tt, torch.stack(yy), a)
                                       .reshape(S * S, -1))))
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


def odeint_grid_batch(func, y0, ts, args_batch, *, rtol=1e-7, atol=1e-9,
                      max_steps=4096, method="auto", probe_max_steps=None,
                      stiff_method="kvaerno5", jac=None):
    """Batched adaptive solve with the two-pass partitioned stiff
    fallback of ``odelib_tpu``'s ``odeint_grid_batch``: under
    ``method='auto'`` every lane is solved by explicit Dopri5 with a
    probe budget of ``probe_max_steps`` step attempts (default
    ``min(max_steps, 512)``: stiffness shows as a collapsing step long
    before a non-stiff lane needs that many); the lanes that failed (one
    host read of the ok flags) are solved again, alone, by the L-stable
    ``stiff_method`` with ``max_steps``, and their results replace the
    probe's (their step counts add to it). Another ``method`` is one
    solve. ``y0`` (S,) shared or (S, N); ``args_batch`` the lanes'
    arguments (tensors of leading size N, or lists of them); ``func`` and
    ``jac`` as :func:`odeint_grid`. Returns :class:`ODESolution` with
    ``ys`` (T, S, N), ``ok`` and ``num_steps`` (N,) and ``accepted_at``
    None."""
    first = args_batch
    while isinstance(first, (list, tuple)):
        if not first:
            raise ValueError("args_batch must have at least one batched "
                             "tensor")
        first = first[0]
    N = first.shape[0]
    y0 = torch.as_tensor(y0, dtype=first.dtype, device=first.device)
    if y0.ndim == 1:
        y0 = y0[:, None].expand(-1, N).clone()
    kw = dict(rtol=rtol, atol=atol, jac=jac)
    if method != "auto":
        sol = odeint_grid(func, y0, ts, args_batch, method=method,
                          max_steps=max_steps, **kw)
        return sol._replace(accepted_at=None, step_times=None)
    probe = int(min(max_steps, 512) if probe_max_steps is None
                else probe_max_steps)
    fast = odeint_grid(func, y0, ts, args_batch, method="dopri5",
                       max_steps=probe, **kw)
    bad = torch.nonzero(~fast.ok).flatten()
    if len(bad) == 0:
        return fast._replace(accepted_at=None, step_times=None)
    stiff = odeint_grid(func, y0[:, bad], ts,
                        _take_lanes(args_batch, bad, N), method=stiff_method,
                        max_steps=max_steps, **kw)
    ys, ok, ns = fast.ys.clone(), fast.ok.clone(), fast.num_steps.clone()
    ys[..., bad], ok[bad] = stiff.ys, stiff.ok
    ns[bad] += stiff.num_steps
    return ODESolution(ys=ys, ok=ok, num_steps=ns, accepted_at=None)
