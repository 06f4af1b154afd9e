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
``ModelFramework(substeps='auto')`` / ``MCMC(substeps='auto')``. Only the
adaptive Dopri5 solver is ported: the Kvaerno methods (the default of
:func:`calibrate_substeps_fn`, and what a kvaerno3 run calibrates with)
raise ``NotImplementedError`` (ROADMAP queue 1, item 14).
"""
from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch

from ..model import state_func
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
    float64 on ``device`` (default the CPU). Returns ``len(times) - 1``
    ints, ready to pass as ``substeps=``.
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
                      spec.unpack_theta(th), rtol=rtol, atol=atol,
                      max_steps=max_steps, method=method)
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
    :func:`~.integrate.odeint_grid`'s, on (S, N) states; ``y0`` (S,) is
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
