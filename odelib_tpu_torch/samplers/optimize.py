"""Multi-start gradient optimization (MAP / maximum-likelihood fitting).

Counterpart of ``odelib_tpu/samplers/optimize.py``: Adam on ``U(z) =
chi(e^z) [- log prior(e^z)]`` in log-parameter space from every start at
once. The reference vmaps one Adam state per start; here every start is a
lane of one batch, and each step takes ``U`` and ``dU/dz`` of all lanes
from one fixed-step solve and one backward pass
(:func:`~odelib_tpu_torch.samplers.hmc.potential`, or
:func:`~odelib_tpu_torch.samplers.hmc.potential_custom` over any
differentiable chi). A non-finite gradient is zeroed, so a diverged start
stalls; the best iterate seen is kept, so a late divergence cannot lose an
earlier good point. Everything computes in float64 on the device of
``theta0`` (an array goes to ``device``).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..model import device_tensor
from .hmc import FIXED_METHODS, _autograd_potential, custom_metrics
from .mh import metrics_fn

__all__ = ["MAPResult", "map_fit", "map_fit_custom"]

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


class MAPResult(NamedTuple):
    theta: Any       # (N, P) optimized parameter vectors (linear space)
    chi: Any         # (N,) chi at the optimum
    loss: Any        # (N,) final U (== chi when use_priors=False)
    converged: Any   # (N,) bool: finite loss and small final step


def _inputs(theta0, walk_mask, use_priors, prior_logpdf, device):
    theta0 = torch.atleast_2d(device_tensor(theta0, torch.float64, device))
    P = theta0.shape[-1]
    mask = torch.ones(P, dtype=theta0.dtype, device=theta0.device) \
        if walk_mask is None else torch.as_tensor(
            walk_mask, dtype=theta0.dtype).to(theta0.device).reshape(P)
    if use_priors and prior_logpdf is None:
        raise ValueError("use_priors=True requires prior_logpdf")
    return theta0, mask


def _map_core(metrics, use_priors, prior_logpdf, theta0, mask, *, steps,
              learning_rate):
    """Adam from every row of ``theta0`` (``odelib_tpu``'s ``_map_core``)
    over ``metrics(theta (N, P)) -> (chi, rsq, aic)``. Returns ``(theta,
    chi, best U, converged)``."""
    vag = _autograd_potential(metrics, use_priors, prior_logpdf)

    def u_of(z):
        with torch.no_grad():
            theta = torch.exp(z)
            u = metrics(theta)[0]
            return u - prior_logpdf(theta) if use_priors else u

    z = torch.log(theta0)
    m = torch.zeros_like(z)
    v = torch.zeros_like(z)
    best_z = z
    best_u = torch.full(z.shape[:1], math.inf, dtype=z.dtype,
                        device=z.device)
    last = torch.full_like(best_u, math.nan)
    for i in range(int(steps)):
        u, _, g = vag(z)
        g = torch.where(torch.isfinite(g), g, 0.0) * mask
        m = _B1 * m + (1 - _B1) * g
        v = _B2 * v + (1 - _B2) * g * g
        mh = m / (1 - _B1 ** (i + 1))
        vh = v / (1 - _B2 ** (i + 1))
        step = learning_rate * mh / (torch.sqrt(vh) + _EPS)
        better = torch.isfinite(u) & (u < best_u)
        best_z = torch.where(better[:, None], z, best_z)
        best_u = torch.where(better, u, best_u)
        z = z - step
        last = torch.amax(torch.abs(step), dim=-1)
    # the end point too (the loop tracked pre-step values)
    u_end = u_of(z)
    better = torch.isfinite(u_end) & (u_end < best_u)
    best_z = torch.where(better[:, None], z, best_z)
    best_u = torch.where(better, u_end, best_u)
    theta = torch.exp(best_z)
    with torch.no_grad():
        chi = metrics(theta)[0]
    converged = torch.isfinite(best_u) & (last < 1e-3)
    return theta, chi, best_u, converged


def map_fit(spec, obs, times, y0_base, theta0, *, steps: int = 500,
            learning_rate: float = 0.05, walk_mask=None, prior_logpdf=None,
            use_priors: bool = False, method: str = "fixed_dopri5",
            substeps=4, device="cuda") -> MAPResult:
    """Multi-start Adam on U(z) = chi(exp(z)) [- log prior]
    (``odelib_tpu``'s ``map_fit``).

    ``theta0``: (N, P) starting points (e.g. LHS prior draws), a tensor on
    its device or an array on ``device``. Returns the per-start optima
    (tensors there); pick ``argmin(chi)`` or keep the whole set to see the
    basin structure. ``walk_mask`` (P,) pins the slots where it is 0.
    ``prior_logpdf(theta (N, P)) -> (N,)`` enters with ``use_priors``. The
    solve is fixed-step (``method`` 'fixed_dopri5' or 'rk4', ``substeps``
    per interval or a per-interval schedule); an adaptive method raises.
    """
    theta0, mask = _inputs(theta0, walk_mask, use_priors, prior_logpdf,
                           device)
    num_params = int(torch.count_nonzero(theta0[0]))
    if method not in FIXED_METHODS:
        raise ValueError("map_fit requires a fixed-step differentiable "
                         "integrator: 'fixed_dopri5' or 'rk4'")
    metrics = metrics_fn(
        spec, obs, times, y0_base, num_params, theta0, method=method,
        substeps=substeps if isinstance(substeps, tuple) else int(substeps))
    theta, chi, loss, conv = _map_core(
        metrics, bool(use_priors), prior_logpdf, theta0, mask,
        steps=int(steps), learning_rate=float(learning_rate))
    return MAPResult(theta=theta, chi=chi, loss=loss, converged=conv)


def map_fit_custom(chi_fn, theta0, *, steps: int = 500,
                   learning_rate: float = 0.05, walk_mask=None,
                   prior_logpdf=None, use_priors: bool = False,
                   device="cuda") -> MAPResult:
    """:func:`map_fit` on any differentiable ``chi_fn(theta (N, D)) ->
    (N,)`` (a JointFit's summed chi; ``odelib_tpu``'s
    ``map_fit_custom``)."""
    theta0, mask = _inputs(theta0, walk_mask, use_priors, prior_logpdf,
                           device)
    theta, chi, loss, conv = _map_core(
        custom_metrics(chi_fn), bool(use_priors), prior_logpdf,
        theta0, mask, steps=int(steps), learning_rate=float(learning_rate))
    return MAPResult(theta=theta, chi=chi, loss=loss, converged=conv)
