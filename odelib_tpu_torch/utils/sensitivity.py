"""Sensitivity analysis: power-scaling, global Sobol indices and local
derivatives.

Counterpart of ``odelib_tpu/utils/sensitivity.py``:

* :func:`power_scale_sensitivity` and :func:`sobol_indices` are numpy
  copies of the reference's (Kallioinen et al. 2023; Saltelli 2010 and
  Jansen 1999 estimators with bootstrap standard errors).
* :func:`saltelli_design` draws the reference's design: its Latin
  hypercubes on ``jax.random``'s stream (:mod:`odelib_tpu_torch.random`:
  ``split``, ``uniform`` and ``permutation`` in the order of the JAX
  package's ``lhs_unit``), pushed through the port's ``ppf``.
* :func:`_eval_target` scores the design in one batched float64 solve
  (:func:`~odelib_tpu_torch.model.integrate_theta`) on the device of its
  thetas.
* :func:`local_sensitivity` is the (T, S_post, P) Jacobian of the
  trajectory by reverse-mode differentiation through the fixed-step
  solve, every output a lane of one batched solve and one backward pass
  (forward mode's dual tensors take torch's Python reference kernels for
  ``add``: 20-80 x slower here).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import random as jr
from ..model import ModelSpec, ObsData, fit_metrics, integrate_theta

__all__ = ["saltelli_design", "sobol_indices", "local_sensitivity",
           "power_scale_sensitivity"]


def _psis_weights(logw):
    """PSIS-smoothed, normalized importance weights of log-weights
    ``logw`` and their Pareto khat."""
    from .model_comparison import _psis_smooth_lw

    lw, khat = _psis_smooth_lw(np.asarray(logw, float))
    return np.exp(lw), khat


def _shift(z, w, m0, s0):
    """Normalized mean/sd shift of one dimension's draws ``z`` (mean
    ``m0``, std ``s0``) under the normalized weights ``w`` (the
    reference's ``_weighted_shift`` of the smoothed weights)."""
    if s0 <= 0.0:
        return 0.0
    m1 = float(np.sum(w * z))
    s1 = float(np.sqrt(max(np.sum(w * (z - m1) ** 2), 0.0)))
    return max(abs(m1 - m0) / s0, abs(s1 - s0) / s0)


def power_scale_sensitivity(z_draws, log_lik, log_prior, *,
                            alphas=(0.8, 1.25), labels=None,
                            threshold=0.05):
    """Power-scaling sensitivity over EXISTING posterior draws, no refit
    (Kallioinen, Paananen, Bürkner & Vehtari 2023): the draws are
    PSIS-reweighted to ``p(y|theta)^a p(theta)`` and ``p(y|theta)
    p(theta)^a`` for each ``a`` in ``alphas`` and each dimension's worst
    normalized mean/sd shift is recorded (threshold 0.05 flags it).

    Likelihood-sensitive only: the data drive the posterior (healthy);
    prior-sensitive only: the prior dominates; both: prior-data conflict;
    neither: the dimension is unidentified at this scale. Prior-scaling
    is per dimension (``log_prior`` (N, P), one column each); an (N,)
    ``log_prior`` is broadcast (joint scaling).

    ``z_draws`` (N, P) pooled log-parameter draws; ``log_lik`` (N,).
    Returns a DataFrame[parameter, prior_sens, lik_sens, khat,
    diagnosis]."""
    import pandas as pd

    z_draws = np.asarray(z_draws, float)
    log_lik = np.asarray(log_lik, float)
    log_prior = np.asarray(log_prior, float)
    N, P = z_draws.shape
    if log_prior.ndim == 1:
        log_prior = np.tile(log_prior[:, None], (1, P))
    ok = np.isfinite(log_lik) \
        & np.all(np.isfinite(log_prior), axis=1) \
        & np.all(np.isfinite(z_draws), axis=1)
    if ok.sum() < 16:
        raise ValueError(f"only {int(ok.sum())} finite draws — too few "
                         "for power-scaling")
    z_draws, log_lik, log_prior = z_draws[ok], log_lik[ok], log_prior[ok]
    if labels is None:
        labels = [f"theta[{j}]" for j in range(P)]

    # the likelihood's weights are the same for every dimension: smoothed
    # once per alpha
    lik_w = [_psis_weights((a - 1.0) * log_lik) for a in alphas]
    rows = []
    for j in range(P):
        z = np.ascontiguousarray(z_draws[:, j])
        lp_j = np.ascontiguousarray(log_prior[:, j])
        m0, s0 = float(z.mean()), float(z.std())
        ps, ls, kh = 0.0, 0.0, 0.0
        for a, (w_l, k2) in zip(alphas, lik_w):
            w_p, k1 = _psis_weights((a - 1.0) * lp_j)
            s_p = _shift(z, w_p, m0, s0)
            s_l = _shift(z, w_l, m0, s0)
            ps, ls = max(ps, s_p), max(ls, s_l)
            kh = max(kh, k1, k2)
        p_hit, l_hit = ps >= threshold, ls >= threshold
        diag = ("prior-data conflict" if p_hit and l_hit
                else "prior-dominated" if p_hit
                else "-" if l_hit
                else "unidentified?")
        rows.append({"parameter": labels[j],
                     "prior_sens": round(ps, 4),
                     "lik_sens": round(ls, 4),
                     "khat": round(kh, 3), "diagnosis": diag})
    return pd.DataFrame(rows)


def lhs_unit(key, n_dims: int, samples: int):
    """(samples, n_dims) float64 Latin hypercube on the unit cube from a
    key, ``odelib_tpu``'s ``lhs_unit`` on its stream: the key split into
    a permutation key and a uniform key, one uniform per cell, and the
    strata of dimension d ``permutation(split(k_perm, n_dims)[d],
    samples)``."""
    k_perm, k_u = jr.split(key).unbind(-2)
    u = jr.uniform(k_u, (samples, n_dims), torch.float64)
    strata = jr.permutation(jr.split(k_perm, n_dims), samples).t()
    return (strata.to(u.dtype) + u) / samples


def saltelli_design(key, dists, samples: int):
    """The Saltelli evaluation matrix ``[A; B; AB_1 .. AB_P]``, A and B
    independent Latin hypercubes (the key's two splits) through the
    priors' ``ppf``, AB_i A with column i from B. Returns (thetas (N (P +
    2), P) on the key's device, N, P)."""
    k_a, k_b = jr.split(key).unbind(-2)
    P = len(dists)

    def lhs(k):
        cube = lhs_unit(k, P, samples)
        return torch.stack([d.ppf(cube[:, i]) for i, d in enumerate(dists)],
                           dim=1)
    A, B = lhs(k_a), lhs(k_b)
    blocks = [A, B]
    for i in range(P):
        ABi = A.clone()
        ABi[:, i] = B[:, i]
        blocks.append(ABi)
    return torch.cat(blocks, dim=0), samples, P


def _eval_target(spec: ModelSpec, obs: ObsData, times, y0_base, thetas, *,
                 target, num_params, method, rtol, atol, max_steps,
                 substeps):
    """Scalar model output of every row of ``thetas`` (N, P), one batched
    solve on their device and dtype: ``target`` ('chi',) the fit's chi,
    or ('state'|'log_state', post-summation index) that state's (log)
    value at the last time."""
    y0 = torch.as_tensor(np.asarray(y0_base, np.float64),
                         dtype=thetas.dtype, device=thetas.device)
    ys = integrate_theta(spec, thetas, spec.override_inits(y0, thetas),
                         times, method=method, rtol=rtol, atol=atol,
                         max_steps=max_steps, substeps=substeps)
    if target[0] == "chi":
        return fit_metrics(spec, obs, ys, num_params)[0]
    v = spec.apply_summations(ys[-1].t())[:, target[1]]
    return torch.log(v) if target[0] == "log_state" else v


def sobol_indices(fA, fB, fAB, n_boot: int = 200, seed: int = 0):
    """First-order (S1) and total-order (ST) Sobol indices from Saltelli
    outputs: fA, fB of shape (N,), fAB of shape (P, N).

    S1_i = mean(fB * (fAB_i - fA)) / V      (Saltelli et al. 2010)
    ST_i = mean((fA - fAB_i)^2) / (2 V)     (Jansen 1999)

    NaN evaluations are dropped pairwise; the outputs are centred first
    (the S1 estimator's variance grows with the squared mean). Returns a
    dict of arrays S1, ST, S1_se, ST_se (bootstrap over samples) and
    ``n_effective``."""
    fA = np.asarray(fA, np.float64)
    fB = np.asarray(fB, np.float64)
    fAB = np.asarray(fAB, np.float64)
    P, N = fAB.shape
    ok = np.isfinite(fA) & np.isfinite(fB) & np.all(np.isfinite(fAB), 0)
    if ok.sum() < 16:
        raise ValueError(f"only {int(ok.sum())} finite Saltelli samples")
    fA, fB, fAB = fA[ok], fB[ok], fAB[:, ok]
    n = len(fA)
    mu = np.mean(np.concatenate([fA, fB]))
    fA, fB, fAB = fA - mu, fB - mu, fAB - mu

    def indices(idx):
        a, b, ab = fA[idx], fB[idx], fAB[:, idx]
        var = np.var(np.concatenate([a, b]))
        s1 = np.mean(b[None, :] * (ab - a[None, :]), axis=1) / var
        st = np.mean((a[None, :] - ab) ** 2, axis=1) / (2.0 * var)
        return s1, st

    s1, st = indices(np.arange(n))
    rng = np.random.default_rng(seed)
    bs1, bst = [], []
    for _ in range(n_boot):
        r = rng.integers(0, n, n)
        a, b = indices(r)
        bs1.append(a)
        bst.append(b)
    return {"S1": s1, "ST": st,
            "S1_se": np.std(bs1, axis=0), "ST_se": np.std(bst, axis=0),
            "n_effective": int(n)}


def local_sensitivity(spec: ModelSpec, theta, y0_base, times, *,
                      log_scale: bool = True, method: str = "fixed_dopri5",
                      substeps=4):
    """Time-resolved sensitivity tensor d y[t, s] / d theta_p (or d / d
    log theta_p with ``log_scale``), shape (T, S_post, P), by reverse-mode
    differentiation through the fixed-step solve (``method``
    'fixed_dopri5' or 'rk4'): T * S_post copies of ``theta``, one a lane
    of one batched solve, and one backward pass of the sum of lane k's
    k-th output, whose gradient in lane k is row k of the Jacobian (the
    lanes are independent). ``theta`` (P,) float64 tensor on the device
    to run on."""
    theta = torch.as_tensor(theta, dtype=torch.float64)
    P = theta.shape[0]
    T, S = len(times), len(spec.post_snames)
    n = T * S
    y0 = torch.as_tensor(np.asarray(y0_base, np.float64),
                         dtype=theta.dtype, device=theta.device)
    lanes = theta.expand(n, P)
    with torch.enable_grad():
        x = (torch.log(lanes) if log_scale else lanes.clone()
             ).requires_grad_(True)
        th = torch.exp(x) if log_scale else x
        ys = integrate_theta(spec, th, spec.override_inits(y0, th), times,
                             method=method, substeps=substeps)
        post = spec.apply_summations(ys.permute(2, 0, 1)).reshape(n, n)
        k = torch.arange(n, device=theta.device)
        J, = torch.autograd.grad(post[k, k].sum(), x)
    return J.reshape(T, S, P)
