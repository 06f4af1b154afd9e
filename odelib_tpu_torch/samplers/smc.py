"""Sequential Monte Carlo with adaptive likelihood tempering.

Counterpart of ``odelib_tpu/samplers/smc.py``: the model evidence (the
marginal likelihood behind Bayes factors) beside equal-weight posterior
particles. A particle population is annealed from the prior (beta = 0) to
the posterior (beta = 1) through targets ``prior(theta) * exp(-chi)^beta``;
each stage reweights, resamples systematically and rejuvenates the
particles with ``n_moves`` sweeps of covariance-adapted MH moves in log
space, each sweep one batched solve of every particle with the caller's
method (adaptive Dopri5 by default). The schedule is chosen on the host by
bisection on the incremental weights' effective sample size, and the
proposal's Cholesky factor comes from the population's covariance, both in
numpy as in the reference. The draws are ``jax.random``'s
(:mod:`odelib_tpu_torch.random`), with the reference's key walk, so a run
is the reference's up to the solver's rounding. Everything computes in
float64 on the device of ``theta0``.
"""
from __future__ import annotations

import warnings
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .. import random as jr
from ..model import device_tensor
from .hmc import _div
from .mh import metrics_fn, solver_kw

__all__ = ["SMCOutput", "smc_sample"]


class SMCOutput(NamedTuple):
    theta: Any            # (N, P) equal-weight posterior particles
    chi: Any              # (N,)
    rsquared: Any         # (N,)
    aic: Any              # (N,)
    log_evidence: float   # log integral of exp(-chi) against the prior
    betas: Any            # tempering schedule actually taken (list)
    acceptance: Any       # per-stage mutation acceptance rates (list)


def _stage(metrics, prior_logpdf, z, chi, rsq, aic, lp, key, beta, log_w,
           chol, walk_mask, n_moves):
    """One SMC stage (``odelib_tpu``'s ``_stage_impl``): systematic
    resampling by ``log_w``, then ``n_moves`` covariance-proposal MH sweeps
    at inverse temperature ``beta``. Returns the particles' state and the
    stage's mean acceptance (a host float)."""
    N = z.shape[0]
    dt, dev = z.dtype, z.device
    key, k_r = jr.split(key).unbind(-2)

    # systematic resampling: one uniform offset, N strata
    w = torch.exp(log_w - torch.max(log_w))
    w = torch.where(torch.isfinite(w), w, 0.0)
    cdf = torch.cumsum(w, 0) / torch.sum(w)
    u = _div(jr.uniform(k_r, (), dt)
             + torch.arange(N, dtype=dt, device=dev), N)
    idx = torch.clamp(torch.searchsorted(cdf, u), 0, N - 1)
    z, chi, rsq, aic, lp = z[idx], chi[idx], rsq[idx], aic[idx], lp[idx]

    acc = 0.0
    for k in jr.split(key, n_moves).unbind(-2):
        k_eps, k_u = jr.split(k).unbind(-2)
        eps = jr.normal(k_eps, tuple(z.shape), dt)
        prop = z + (eps @ chol.t()) * walk_mask[None, :]
        chi_n, rsq_n, aic_n = metrics(torch.exp(prop))
        lp_n = prior_logpdf(torch.exp(prop))
        log_r = beta * (chi - chi_n) + (lp_n - lp)
        ok = torch.exp(log_r) > jr.uniform(k_u, (N,), dt)   # NaN -> False
        z = torch.where(ok[:, None], prop, z)
        chi, rsq, aic, lp = (torch.where(ok, a, b) for a, b in (
            (chi_n, chi), (rsq_n, rsq), (aic_n, aic), (lp_n, lp)))
        # jnp.mean of a bool array is float32, the count times 1 / N as
        # XLA:CPU computes it, then added in float64
        acc = acc + float(np.float32(int(ok.sum()))
                          * (np.float32(1.0) / np.float32(N)))
    return z, chi, rsq, aic, lp, acc / n_moves


def _next_beta(chi: np.ndarray, beta: float, ess_target: float) -> float:
    """Largest beta' <= 1 whose incremental weights keep
    ESS >= ess_target * N, by bisection on the host (no solves)."""
    finite = np.isfinite(chi)
    chi_f = np.where(finite, chi, np.inf)

    def ess_frac(b):
        lw = -(b - beta) * chi_f
        lw = lw - lw.max()
        w = np.exp(lw)
        s = w.sum()
        if s <= 0:
            return 0.0
        return (s ** 2 / (w ** 2).sum()) / len(chi)

    if ess_frac(1.0) >= ess_target:
        return 1.0
    lo, hi = beta, 1.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if ess_frac(mid) >= ess_target:
            lo = mid
        else:
            hi = mid
    return max(lo, np.nextafter(beta, 1.0))


def smc_sample(
        spec, obs, times, y0_base, theta0, key, *, prior_logpdf,
        n_moves: int = 5, ess_target: float = 0.5, walk_mask=None,
        max_stages: int = 60, scale: Optional[float] = None,
        method: str = "dopri5", rtol: float = 1e-6, atol: float = 1e-4,
        max_steps: int = 4096, substeps=4, device="cuda") -> SMCOutput:
    """Anneal N prior-drawn particles to the posterior; returns equal-weight
    posterior particles and the log evidence (``odelib_tpu``'s
    ``smc_sample``).

    ``theta0`` (N, P): draws from the PRIOR, a tensor on its device or an
    array on ``device``; ``key`` a (2,) key (:func:`~odelib_tpu_torch.
    random.PRNGKey`). ``prior_logpdf(theta (N, P)) -> (N,)`` is required
    (the beta = 0 target). ``n_moves`` MH sweeps a stage (each N solves),
    ``ess_target`` the relative ESS the schedule keeps, ``scale`` the
    proposal's multiplier on the population covariance's Cholesky factor
    (default 2.38 / sqrt(walked dims)). ``log_evidence`` estimates ``log
    ∫ exp(-chi(z)) prior(z) dz`` over log-theta; Bayes factors between two
    models of the same data are ``exp(logZ_1 - logZ_2)``.
    """
    if not 0.0 < ess_target < 1.0:
        raise ValueError(f"ess_target must be in (0, 1), got {ess_target}")
    if prior_logpdf is None:
        raise ValueError("smc_sample requires prior_logpdf (the beta=0 "
                         "target is the prior)")
    theta0 = torch.atleast_2d(device_tensor(theta0, torch.float64, device))
    N, P = theta0.shape
    if N < 8:
        raise ValueError(f"SMC needs a real population, got N={N}")
    dt, dev = theta0.dtype, theta0.device
    walk_mask = torch.ones(P, dtype=dt, device=dev) if walk_mask is None \
        else torch.as_tensor(np.ravel(np.asarray(walk_mask, np.float64)),
                             dtype=dt, device=dev)
    n_walked = int(torch.count_nonzero(walk_mask))
    if scale is None:
        scale = 2.38 / np.sqrt(max(n_walked, 1))
    metrics = metrics_fn(spec, obs, times, y0_base,
                         int(torch.count_nonzero(theta0[0])), theta0,
                         **solver_kw(method, rtol, atol, max_steps, substeps))
    key = torch.as_tensor(key, dtype=torch.int64).to(dev)

    z = torch.log(theta0)
    chi, rsq, aic = metrics(torch.exp(z))
    lp = prior_logpdf(torch.exp(z))

    beta = 0.0
    log_Z = 0.0
    betas, accs = [0.0], []
    for _ in range(int(max_stages)):
        chi_h = chi.cpu().numpy()
        n_fin = int(np.isfinite(chi_h).sum())
        if n_fin < 8:
            raise ValueError(
                f"SMC population collapsed: only {n_fin}/{N} particles "
                f"have finite chi at beta={beta:.4f}. Try: \n"
                " 1. Narrower/better-centred priors \n"
                " 2. More particles \n"
                " 3. A stiffer solver method for this model")
        new_beta = _next_beta(chi_h, beta, float(ess_target))
        d = new_beta - beta
        # evidence increment: log mean of the incremental weights (equal
        # weights at the stage's start: every stage resamples)
        lw = np.where(np.isfinite(chi_h), -d * chi_h, -np.inf)
        m = lw.max()
        log_Z += m + np.log(np.mean(np.exp(lw - m)))

        # proposal geometry from the current population (host, O(N P^2))
        z_h = z.cpu().numpy()
        cov = np.cov(z_h[np.isfinite(chi_h)], rowvar=False).reshape(P, P)
        cov = cov + 1e-10 * np.eye(P)
        chol = torch.as_tensor(float(scale) * np.linalg.cholesky(cov),
                               dtype=dt, device=dev)

        key, k_stage = jr.split(key).unbind(-2)
        z, chi, rsq, aic, lp, acc = _stage(
            metrics, prior_logpdf, z, chi, rsq, aic, lp, k_stage, new_beta,
            torch.as_tensor(lw, dtype=dt, device=dev), chol, walk_mask,
            int(n_moves))
        betas.append(float(new_beta))
        accs.append(float(acc))
        beta = new_beta
        if beta >= 1.0:
            break
    else:
        warnings.warn(f"SMC hit max_stages={max_stages} at beta={beta:.4f} "
                      "< 1; evidence estimate is for the tempered target")

    return SMCOutput(theta=torch.exp(z), chi=chi, rsquared=rsq, aic=aic,
                     log_evidence=float(log_Z), betas=betas,
                     acceptance=accs)
