"""Adaptive Metropolis (Haario): each chain learns its proposal covariance
during burn-in.

Counterpart of ``odelib_tpu/samplers/amh.py``: the isotropic lognormal
walk of :mod:`~odelib_tpu_torch.samplers.mh` until ``adapt_start``
burn-in iterations have passed, then proposals from ``N(0, 2.38^2/d
Sigma)``, Sigma each chain's running covariance of log-theta (Welford's
mean and M2 over its burn-in states, the walked slots only) with a floor
of ``(0.1 rwalk_std)^2 I``, through a batched Cholesky factor. The
adaptation freezes at the end of burn-in, so the recorded chain is a
fixed-kernel Markov chain. Every chain is a lane of each iteration's
batched solve (any method, as the scan MH), carries its key and splits it
three ways an iteration, so its draws are the reference's ``jax.random``
stream; float64 on the device of ``theta0``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import random as jr
from .mh import (MHOutput, _mh_output, chain_inputs, check_run, metrics_fn,
                 solver_kw)

__all__ = ["adaptive_metropolis"]


def adaptive_metropolis(
        spec, obs, times, y0_base, theta0, keys, *, nits: int = 1000,
        burnin: Optional[int] = None, walk_mask=None,
        rwalk_std: float = 0.05, adapt_start: int = 50,
        prior_logpdf: Optional[Callable] = None, use_priors: bool = False,
        method: str = "dopri5", rtol: float = 1e-6, atol: float = 1e-4,
        max_steps: int = 4096, substeps=4, device="cuda") -> MHOutput:
    """Run C adaptive-Metropolis chains (``odelib_tpu``'s
    ``adaptive_metropolis``): the conventions of
    :func:`~odelib_tpu_torch.samplers.mh.metropolis_hastings` plus
    ``adapt_start``, the burn-in iterations of isotropic walk before the
    learned covariance takes over (``burnin`` should exceed it).
    ``keys`` (C, 2): chain c splits its key into the next key, the
    proposal's and the acceptance's every iteration."""
    burnin = check_run(nits, burnin, use_priors, prior_logpdf)
    nits = int(nits)
    theta0, keys, mask = chain_inputs(theta0, keys, walk_mask, device)
    C, P = theta0.shape
    dt, dev = theta0.dtype, theta0.device
    metrics = metrics_fn(spec, obs, times, y0_base,
                         int(torch.count_nonzero(theta0[0])), theta0,
                         **solver_kw(method, rtol, atol, max_steps,
                                     substeps))
    free = mask > 0
    rwalk_std, adapt_start = float(rwalk_std), int(adapt_start)
    s_d = 2.38 ** 2 / max(int(torch.count_nonzero(mask)), 1)
    eye = torch.eye(P, dtype=dt, device=dev)

    chi, rsq, aic = metrics(theta0)
    lt = torch.log(theta0)
    acc = torch.zeros(C, dtype=dt, device=dev)
    mean = torch.where(free, lt, 0.0)
    M2 = torch.zeros((C, P, P), dtype=dt, device=dev)
    n = 0.0      # the burn-in states seen, the same for every chain
    R = nits - 1 - burnin
    recs = (torch.empty((R, C, P), dtype=dt, device=dev),) + tuple(
        torch.empty((R, C), dtype=dt, device=dev) for _ in range(4))
    for it in range(1, nits):
        keys, k_eps, k_u = jr.split(keys, 3).unbind(-2)
        # the proposal's Cholesky factor: the scaled covariance with its
        # floor once enough history has accumulated, else the isotropic
        # walk's; a factorisation that fails keeps the isotropic walk
        L = rwalk_std * eye.expand(C, P, P)
        if n > adapt_start:
            cov = M2 / torch.full_like(M2, max(n - 1.0, 1.0))
            cov = s_d * cov + (0.1 * rwalk_std) ** 2 * eye
            Lc, info = torch.linalg.cholesky_ex(cov)
            ok = (info == 0) & torch.isfinite(Lc).flatten(1).all(-1)
            L = torch.where(ok[:, None, None], Lc, L)
        eps = (L @ jr.normal(k_eps, (P,), dt)[..., None])[..., 0]
        prop = lt + eps * mask
        chi_n, rsq_n, aic_n = metrics(torch.exp(prop))
        log_ratio = chi - chi_n
        if use_priors:
            log_ratio = log_ratio + (prior_logpdf(torch.exp(prop))
                                     - prior_logpdf(torch.exp(lt)))
        accept = torch.exp(log_ratio) > jr.uniform(k_u, (), dt)  # NaN: no
        lt = torch.where(accept[:, None], prop, lt)
        chi, rsq, aic = (torch.where(accept, a, b) for a, b in (
            (chi_n, chi), (rsq_n, rsq), (aic_n, aic)))
        acc = acc + accept.to(dt)
        if it <= burnin:
            # Welford over the walked slots (a static or zero-template
            # slot's log(0) would poison M2)
            n += 1.0
            zm = torch.where(free, lt, 0.0)
            d = zm - mean
            mean = mean + d / torch.full_like(d, n)
            M2 = M2 + d[:, :, None] * (zm - mean)[:, None, :]
        else:
            r = it - burnin - 1
            recs[0][r] = torch.exp(lt)
            recs[1][r], recs[2][r], recs[3][r] = chi, rsq, aic
            recs[4][r] = acc / torch.full_like(acc, float(it))
    return _mh_output(recs, nits, burnin, dev)
