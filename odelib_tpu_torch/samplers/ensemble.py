"""Affine-invariant ensemble sampler (Goodman-Weare stretch moves), the
scan form.

Counterpart of ``odelib_tpu/samplers/ensemble.py``: one W-walker ensemble
split into two halves; each iteration updates the first half against
partners drawn from the second, then the second against the first, each
half-update one batched solve of its W/2 proposals. Walks live in
log-theta, the target is ``exp(-(chi - log prior))`` and a NaN chi is
rejected. Draws are ``jax.random``'s (:mod:`odelib_tpu_torch.random`) in
the reference's split order. One card runs one ensemble: the reference's
``mesh=`` (one ensemble per device) raises. The main path's fused kernel
is ``ops/cuda_mh.py`` ``ensemble_fused``.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from .. import random as jr
from .mh import (MHOutput, chain_inputs, check_run, metrics_fn,
                 solver_kw)


def stretch_z(keys, shape, a, dtype):
    """z ~ g(z) proportional to 1/sqrt(z) on [1/a, a] by the inverse CDF
    ``((1 + (a - 1) u)^2) / a``, u uniform (the quotient a true division
    by a tensor: CUDA divides by a Python scalar through its
    reciprocal)."""
    u = jr.uniform(keys, shape, dtype)
    return (1.0 + (a - 1.0) * u) ** 2 / torch.full_like(u, a)


def ensemble_mh(spec, obs, times, y0_base, theta0, key, *, nits: int = 1000,
                burnin: Optional[int] = None, a: float = 2.0, walk_mask=None,
                init_jitter: float = 0.01, prior_logpdf=None,
                use_priors: bool = False, method: str = "dopri5",
                rtol: float = 1e-6, atol: float = 1e-4, max_steps: int = 4096,
                substeps=4, mesh=None, device="cuda") -> MHOutput:
    """Run one W-walker ensemble; returns ``MHOutput`` with the walker axis
    in the chains slot.

    ``theta0`` (W, P) positive starts (a tensor on its device, an array on
    ``device``, as :func:`~.mh.metropolis_hastings`); W must be even and
    at least 4, and should be at least twice the walked parameters (a
    warning below). ``key`` (2,): one key for the whole ensemble.
    ``init_jitter`` is the lognormal std applied to the walked slots of
    ``theta0`` from a split of the key (0 disables it). ``a`` is the
    stretch scale (> 1). The masked slots keep their value by selection,
    so an array parameter's -inf log entries stay out of the
    arithmetic."""
    if mesh is not None:
        raise NotImplementedError(
            "one card runs one ensemble; a chain mesh is not ported "
            "(ROADMAP queue 1, item 18)")
    burnin = check_run(nits, burnin, use_priors, prior_logpdf)
    if a <= 1.0:
        raise ValueError(f"stretch scale a must exceed 1, got {a}")
    theta0, key, mask = chain_inputs(theta0, key, walk_mask, device)
    key = key[0]
    W, P = theta0.shape
    if W < 4 or W % 2:
        raise ValueError(f"ensemble needs an even number of walkers >= 4, "
                         f"got {W}")
    n_walked = int(torch.count_nonzero(mask))
    if W < 2 * n_walked:
        warnings.warn(
            f"{W} walkers for {n_walked} walked parameters; use at least "
            f"{2 * n_walked} for reliable ensemble mixing")
    num = int(torch.count_nonzero(theta0[0]))
    dt, dev = theta0.dtype, theta0.device
    if init_jitter:
        key, k_init = jr.split(key)
        theta0 = theta0 * torch.exp(init_jitter * mask[None, :]
                                    * jr.normal(k_init, (W, P), dt))
    metrics = metrics_fn(spec, obs, times, y0_base, num, theta0,
                         **solver_kw(method, rtol, atol, max_steps,
                                     substeps))

    def energy(z):
        chi, rsq, aic = metrics(torch.exp(z))
        lp = prior_logpdf(torch.exp(z)) if use_priors \
            else torch.zeros_like(chi)
        return chi, rsq, aic, lp

    H = W // 2
    walked = (mask > 0)[None, :]
    lt = torch.log(theta0)
    chi, rsq, aic, lp = energy(lt)
    acc = torch.zeros(W, dtype=dt, device=dev)
    R = nits - 1 - burnin
    recs = (torch.empty((W, R, P), dtype=dt, device=dev),) + tuple(
        torch.empty((W, R), dtype=dt, device=dev) for _ in range(4))
    for it in range(1, nits):
        key, k_a, k_b = jr.split(key, 3)
        for lo, k in ((0, k_a), (H, k_b)):
            # walkers [lo, lo + H) against partners in the other half
            k_j, k_z, k_u = jr.split(k, 3)
            cur = lt[lo:lo + H]
            comp = lt[H - lo:2 * H - lo]
            partner = comp[jr.randint(k_j, (H,), 0, H)]
            z = stretch_z(k_z, (H,), float(a), dt)
            prop = torch.where(walked, cur + (1.0 - z)[:, None]
                               * (partner - cur), cur)
            chi_n, rsq_n, aic_n, lp_n = energy(prop)
            log_r = (n_walked - 1.0) * torch.log(z) \
                + (chi[lo:lo + H] - chi_n) + (lp_n - lp[lo:lo + H])
            u = jr.uniform(k_u, (H,), dt)
            accept = torch.exp(log_r) > u          # NaN -> False
            sl = slice(lo, lo + H)
            lt[sl] = torch.where(accept[:, None], prop, cur)
            chi[sl] = torch.where(accept, chi_n, chi[sl])
            rsq[sl] = torch.where(accept, rsq_n, rsq[sl])
            aic[sl] = torch.where(accept, aic_n, aic[sl])
            lp[sl] = torch.where(accept, lp_n, lp[sl])
            acc[sl] = acc[sl] + accept.to(dt)
        r = it - 1 - burnin
        if r >= 0:
            recs[0][:, r] = torch.exp(lt)
            recs[1][:, r], recs[2][:, r], recs[3][:, r] = chi, rsq, aic
            recs[4][:, r] = acc / torch.full_like(acc, float(it))
    return MHOutput(*recs,
                    iteration=torch.arange(1, nits, device=dev)[burnin:])
