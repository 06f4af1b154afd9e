"""Static step-schedule calibration: adaptive step control moved ahead of
the run.

Counterpart of ``odelib_tpu/ops/schedule.py``. The fused kernels integrate
with a fixed step schedule (no per-chain adaptivity in the solve); the
schedule's robustness comes from one adaptive pass before the run:

1. run the adaptive solver (:func:`~.integrate.odeint_grid`) over a batch
   of representative parameter draws (the MCMC chains' seeds);
2. read how many accepted steps it spent inside each output interval
   (``ODESolution.accepted_at``);
3. take a robust upper quantile over the batch per interval as that
   interval's substep count.

Fast intervals get more substeps, quiet ones fewer. Exposed to users as
``ModelFramework(substeps='auto')`` / ``MCMC(substeps='auto')`` (a
kvaerno3 run calibrates with Kvaerno5). :func:`auto_stiff_grid` goes one
step further for batched stiff solves: the adaptive pilot's own step
times become the fixed-step grid.
"""
from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch

from ..model import dose_matrix, state_func, state_jac
from .integrate import odeint_grid


def _schedule(acc, ok, n_intervals, quantile, safety, min_substeps,
              max_substeps, what):
    """The per-interval schedule from accepted-step counts ``acc`` (N, T)
    of the lanes that integrated (``ok``), or a uniform 4 (warned) when
    none did."""
    if not ok.any():
        # nothing integrates under the adaptive solver: a uniform mid-range
        # schedule rather than an error (the JAX package's fallback)
        warnings.warn(f"substep calibration: no {what} integrated cleanly; "
                      "falling back to a uniform schedule of 4")
        return tuple([max(min_substeps, min(4, max_substeps))] * n_intervals)
    per_interval = np.diff(acc[ok], axis=1)     # (N_ok, T - 1)
    q = np.quantile(per_interval, quantile, axis=0)
    sched = np.clip(np.ceil(q * float(safety)).astype(int), min_substeps,
                    max_substeps)
    return tuple(int(s) for s in sched)


def calibrate_substeps(spec, y0, times, thetas, *, rtol: float = 1e-6,
                       atol: float = 1e-4, method: str = "dopri5",
                       quantile: float = 0.9, safety: float = 1.0,
                       min_substeps: int = 1, max_substeps: int = 64,
                       max_draws: int = 256, max_steps: int = 16384,
                       device=None) -> Tuple[int, ...]:
    """Per-interval substep schedule from an adaptive calibration pass.

    ``spec`` a :class:`~odelib_tpu_torch.model.ModelSpec`; ``y0`` the base
    initial state (each theta's '<sname>0' slots override it); ``times``
    the grid the fixed-step kernels will run on; ``thetas`` (N, P) draws
    spanning the region the chains will explore, capped at ``max_draws``
    (evenly strided). ``rtol``/``atol``/``method``/``max_steps`` set the
    adaptive solver whose accuracy the schedule should reproduce;
    ``quantile`` is the per-interval upper quantile of accepted-step counts
    over the draws, ``safety`` a multiplier on it, and the entries are
    clipped to [``min_substeps``, ``max_substeps``]. The solves run in
    float64 on ``device`` (default the CPU), with the spec's doses and,
    for the implicit methods, the traced RHS's Jacobian. Returns
    ``len(times) - 1`` ints, ready to pass as ``substeps=``.
    """
    thetas = np.asarray(thetas, np.float64)
    if thetas.ndim == 1:
        thetas = thetas[None]
    if len(thetas) > max_draws:
        idx = np.linspace(0, len(thetas) - 1, max_draws).round().astype(int)
        thetas = thetas[np.unique(idx)]
    th = torch.as_tensor(thetas, dtype=torch.float64, device=device)
    y0_i = spec.override_inits(torch.as_tensor(
        np.asarray(y0, np.float64), dtype=torch.float64, device=th.device),
        th)
    sol = odeint_grid(state_func(spec), y0_i, np.asarray(times, np.float64),
                      spec.slots(th), rtol=rtol, atol=atol,
                      max_steps=max_steps, method=method,
                      dose=dose_matrix(spec, times), jac=state_jac(spec))
    return _schedule(sol.accepted_at.t().cpu().numpy(),
                     sol.ok.cpu().numpy(), len(np.asarray(times)) - 1,
                     quantile, safety, min_substeps, max_substeps, "draw")


def schedule_cost(schedule) -> int:
    """Total RHS-step count of a schedule (what the kernel will pay)."""
    return int(np.sum(np.asarray(schedule, np.int64)))


def calibrate_substeps_fn(func, y0, times, args_batch, *,
                          rtol: float = 1e-6, atol: float = 1e-9,
                          method: str = "kvaerno5",
                          quantile: float = 0.9, safety: float = 1.0,
                          min_substeps: int = 1, max_substeps: int = 64,
                          max_steps: int = 16384) -> Tuple[int, ...]:
    """Generic-RHS version of :func:`calibrate_substeps` (no ModelSpec):
    one adaptive pass over the N pilot lanes of ``args_batch`` (a tensor,
    or a list of tensors, each of leading size N, on the device the solve
    runs on) yields the per-interval schedule. ``func(t, y, args)`` is
    :func:`~.integrate.odeint_grid`'s, on (S, N) states (the implicit
    methods take its forward-mode Jacobian columns); ``y0`` (S,) is
    shared by the lanes."""
    first = args_batch if isinstance(args_batch, torch.Tensor) \
        else args_batch[0]
    y0 = torch.as_tensor(y0, dtype=first.dtype, device=first.device)
    y0 = y0[:, None].expand(-1, first.shape[0]).clone()
    sol = odeint_grid(func, y0, np.asarray(times, np.float64), args_batch,
                      rtol=rtol, atol=atol, max_steps=max_steps,
                      method=method)
    return _schedule(sol.accepted_at.t().cpu().numpy(),
                     sol.ok.cpu().numpy(), len(np.asarray(times)) - 1,
                     quantile, safety, min_substeps, max_substeps,
                     "pilot lane")


def output_index(grid, times):
    """The index of each requested time's nearest node of ``grid``
    (sorted); ``ValueError`` if one is not within rtol 1e-4 of it (the
    check the JAX package's ``auto_stiff_grid`` makes by ``assert``)."""
    out_index = np.clip(np.searchsorted(grid, times), 0, len(grid) - 1)
    near = np.abs(grid[np.maximum(out_index - 1, 0)] - times) \
        < np.abs(grid[out_index] - times)
    out_index = np.where(near, np.maximum(out_index - 1, 0), out_index)
    if not np.allclose(grid[out_index], times, rtol=1e-4, atol=1e-12):
        raise ValueError("auto_stiff_grid: a requested time has no grid "
                         "node within rtol 1e-4")
    return out_index


def auto_stiff_grid(func, y0, times, pilot_args, *, rtol: float = 1e-6,
                    atol: float = 1e-9, method: str = "kvaerno5",
                    max_steps: int = 4096, max_nodes: int = 256,
                    quantile: float = 0.9, safety: float = 1.0,
                    max_substeps: int = 64):
    """(grid, schedule, out_index) for batched fixed-step stiff solves,
    as ``odelib_tpu``'s ``auto_stiff_grid``: one adaptive ``method``
    pilot over the few lanes of ``pilot_args`` (a tensor or list of
    tensors of leading size N, on the device the pilot runs on); the
    accepted-step times of its most demanding clean lane, thinned to
    ``max_nodes``, become the grid's nodes, merged with the requested
    ``times`` (a node within 1e-5 relative of a requested time gives way
    to it, so no interval collapses in float32), and a calibration pass
    over the pilot lanes on that grid sets the per-interval schedule. Run
    ``odeint_fixed(func, y0, grid, args, substeps=schedule,
    method='kvaerno3')`` and read the requested times at
    ``ys[out_index]``. A requested time that snaps to no node within
    rtol 1e-4 raises ``ValueError``."""
    times = np.asarray(times, np.float64)
    if times.ndim != 1 or len(times) < 2:
        raise ValueError("times must be a 1-D grid with >= 2 points")
    first = pilot_args if isinstance(pilot_args, torch.Tensor) \
        else pilot_args[0]
    N = first.shape[0]
    y0_l = torch.as_tensor(y0, dtype=first.dtype, device=first.device)
    sol = odeint_grid(func, y0_l[:, None].expand(-1, N).clone(), times,
                      pilot_args, rtol=rtol, atol=atol, max_steps=max_steps,
                      method=method, record_step_times=max_steps)
    st = sol.step_times.t().cpu().numpy()
    acc = sol.accepted_at.t().cpu().numpy()
    ok = sol.ok.cpu().numpy()
    if not ok.any():
        warnings.warn("auto_stiff_grid: no pilot lane integrated cleanly "
                      "under the adaptive oracle; returning the caller's "
                      "grid with a uniform schedule of 8")
        return (times, tuple([8] * (len(times) - 1)),
                np.arange(len(times), dtype=np.int64))
    # the most demanding clean pilot lane: a conservative node profile
    counts = np.where(ok, acc[:, -1], -1)
    lane = int(np.argmax(counts))
    nodes = np.sort(st[lane][:counts[lane]])
    nodes = nodes[np.isfinite(nodes)]
    if len(nodes) > max_nodes:
        keep = np.unique(np.linspace(0, len(nodes) - 1,
                                     max_nodes).round().astype(int))
        nodes = nodes[keep]
    # merge with the requested outputs within 1e-5 relative (about 100
    # float32 ulps): a node an ulp from a requested time would leave a
    # zero-width interval in float32, and h = 0 makes the stage solve
    # singular
    nodes = nodes[(nodes > times[0]) & (nodes < times[-1])]
    grid = np.concatenate([times, nodes])
    user_mask = np.zeros(len(grid), bool)
    user_mask[:len(times)] = True
    order = np.argsort(grid, kind="stable")
    grid, user_mask = grid[order], user_mask[order]
    keep = np.ones(len(grid), bool)
    last = 0
    for i in range(1, len(grid)):
        tol = 1e-5 * max(abs(grid[i]), abs(grid[last]), 1e-300)
        if grid[i] - grid[last] < tol:
            if user_mask[i] and not user_mask[last]:
                keep[last] = False       # the requested time wins
                last = i
            else:
                keep[i] = False
        else:
            last = i
    grid = grid[keep]
    out_index = output_index(grid, times)
    sched = calibrate_substeps_fn(
        func, y0, grid, pilot_args, rtol=rtol, atol=atol, method=method,
        quantile=quantile, safety=safety, max_substeps=max_substeps,
        max_steps=max_steps)
    return grid, sched, out_index
