"""Automatic Differentiation Variational Inference (ADVI) through the ODE
solve.

Counterpart of ``odelib_tpu/samplers/advi.py``: a Gaussian ``q(z)``
(mean-field diagonal or full-rank Cholesky) fitted to the log-parameter
posterior ``pi(z) ∝ exp(-chi(e^z)) [* prior(e^z)]`` (the density the MH
samplers walk) by maximizing the reparameterized ELBO with Adam
(Kucukelbir et al. 2017, JMLR 18). Each step's Monte-Carlo draws are the
lanes of one fixed-step solve, and the ELBO's gradient in the variational
parameters is one backward pass through it. The normals are
``jax.random``'s (:mod:`odelib_tpu_torch.random`): step ``i`` draws from
``fold_in(key, i)``, the posterior draws from ``fold_in(key, steps + 1)``
and the batch that chooses between the tail average and the best iterate
from ``fold_in(key, steps + 2)``. Static parameters and zero-template
entries are pinned (excluded from the family); a non-finite gradient
zeroes the step. Everything computes in float64 on ``device``.
"""
from __future__ import annotations

import math
import warnings
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import random as jr
from ..model import device_tensor
from .hmc import FIXED_METHODS, custom_metrics
from .mh import metrics_fn

__all__ = ["ADVIResult", "advi", "advi_custom", "psis_weights",
           "attach_advi_diagnostics", "resample_indices"]

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


class ADVIResult(NamedTuple):
    mu: Any          # (F,) variational mean over the FREE z dims
    L: Any           # (F, F) Cholesky factor of q's covariance
    elbo: Any        # (steps,) per-step MC ELBO estimate
    theta: Any       # (draws, P) posterior draws, linear space, full layout
    chi: Any         # (draws,) chi of each draw
    rsquared: Any    # (draws,)
    aic: Any         # (draws,)
    free_idx: Any    # (F,) flat-theta indices of the free dims
    converged: Any   # bool: best ELBO finite and tail-stable
    logw: Any        # (draws,) unnormalized log importance weights
                     # log p(z) - log q(z)


def _advi_core(metrics, prior_of, z0_full, free_idx, key, *, F, steps,
               learning_rate, n_mc, full_rank, draws):
    """ELBO ascent (``odelib_tpu``'s ``_advi_core``) over ``metrics(theta
    (n, P)) -> (chi, rsq, aic)``; ``prior_of`` may be None. Returns the
    fields of :class:`ADVIResult` but ``free_idx``."""
    dt, dev = z0_full.dtype, z0_full.device
    P = z0_full.shape[0]
    fidx = torch.as_tensor(free_idx, dtype=torch.int64, device=dev)
    tril_r, tril_c = (t.to(dev) for t in torch.tril_indices(F, F))
    # the raw diagonal's positions among the tril entries (row-major)
    diag_pos = torch.as_tensor(np.cumsum(np.arange(1, F + 1)) - 1,
                               device=dev)
    half_log_2pie = 0.5 * (1.0 + math.log(2.0 * math.pi))

    def theta_of(z_free):
        return torch.exp(z0_full.expand(len(z_free), P).index_copy(
            1, fidx, z_free))

    def logp(theta):
        chi, rsq, aic = metrics(theta)
        lp = -chi
        if prior_of is not None:
            lp = lp + prior_of(theta)
        return lp, chi, rsq, aic

    def unpack(lam):
        """(mu, L, log det L) of the packed variational parameters: mean-
        field ``[mu, log_sigma]``, full rank ``[mu, tril entries]`` with
        the raw diagonal stored as a log."""
        mu = lam[:F]
        if full_rank:
            raw = lam[F:]
            vals = raw.index_put((diag_pos,), torch.exp(raw[diag_pos]))
            L = torch.zeros((F, F), dtype=dt, device=dev).index_put(
                (tril_r, tril_c), vals)
            return mu, L, raw[diag_pos].sum()
        log_sig = lam[F:]
        return mu, torch.diag(torch.exp(log_sig)), log_sig.sum()

    def elbo_of(lam, k, n):
        mu, L, logdet = unpack(lam)
        eps = jr.normal(k, (n, F), dt)
        zs = mu[None, :] + eps @ L.t()
        lps = logp(theta_of(zs))[0]
        return lps.sum() / n + (F * half_log_2pie + logdet)

    def elbo_grad(lam, k):
        with torch.enable_grad():
            lam = lam.detach().requires_grad_(True)
            e = elbo_of(lam, k, n_mc)
            g, = torch.autograd.grad(e, lam)
        return e.detach(), g

    n_lam = F + (F * (F + 1) // 2 if full_rank else F)
    lam = torch.zeros(n_lam, dtype=dt, device=dev)
    lam[:F] = z0_full[fidx]
    # init scale sigma = 0.1 in z-space: log(0.1) on the (raw) diagonal
    if full_rank:
        lam[F + diag_pos] = math.log(0.1)
    else:
        lam[F:] = math.log(0.1)

    # cosine learning-rate decay (1 -> 0.1) and tail iterate-averaging
    # over the last quarter; the best iterate is the divergence fallback
    tail_start = (3 * steps) // 4
    n_tail = max(1, steps - tail_start)
    m = torch.zeros_like(lam)
    v = torch.zeros_like(lam)
    best_lam = lam
    best_e = torch.tensor(-math.inf, dtype=dt, device=dev)
    lam_sum = torch.zeros_like(lam)
    elbos = torch.empty(steps, dtype=dt, device=dev)
    for i in range(steps):
        e, g = elbo_grad(lam, jr.fold_in(key, i))
        elbos[i] = e
        # best-iterate tracking: e belongs to the PRE-step lam
        better = torch.isfinite(e) & (e > best_e)
        best_lam = torch.where(better, lam, best_lam)
        best_e = torch.where(better, e, best_e)
        g = torch.where(torch.isfinite(g).all(), g, 0.0)
        m = _B1 * m + (1 - _B1) * g
        v = _B2 * v + (1 - _B2) * g * g
        mh = m / (1 - _B1 ** (i + 1))
        vh = v / (1 - _B2 ** (i + 1))
        lr = learning_rate * (0.1 + 0.45 * (
            1.0 + math.cos(math.pi * i / steps)))
        lam = lam + lr * mh / (torch.sqrt(vh) + _EPS)
        lam_sum = lam_sum + (1.0 if i >= tail_start else 0.0) * lam
    lam_avg = lam_sum / n_tail
    with torch.no_grad():
        # tail average vs best iterate on a fresh, larger common batch
        n_eval = max(64, 4 * n_mc)
        k_eval = jr.fold_in(key, steps + 2)
        e_avg = elbo_of(lam_avg, k_eval, n_eval)
        e_best = elbo_of(best_lam, k_eval, n_eval)
        use_avg = torch.isfinite(e_avg) & (
            (e_avg >= e_best) | ~torch.isfinite(e_best))
        lam_star = torch.where(use_avg, lam_avg, best_lam)
        best_e = torch.where(use_avg, e_avg, e_best)
        mu, L, logdet_star = unpack(lam_star)

        # posterior draws from q, their metrics and log importance weights
        # log p(z) - log q(z), log q from eps: z = mu + L eps
        eps = jr.normal(jr.fold_in(key, steps + 1), (draws, F), dt)
        z_free = mu[None, :] + eps @ L.t()
        theta_d = theta_of(z_free)
        lp, chi_d, rsq_d, aic_d = logp(theta_d)
        logq = (-0.5 * (eps * eps).sum(-1) - logdet_star
                - 0.5 * F * math.log(2.0 * math.pi))
        logw = lp - logq
    # converged: the ELBO stopped climbing, the two halves of the tail
    # window against the MC noise floor (jnp.std: divides by n)
    q = max(2, steps // 8)
    h1, h2 = elbos[-2 * q:-q], elbos[-q:]
    se = torch.std(elbos[-2 * q:], correction=0) / math.sqrt(1.0 * q) + 1e-9
    drift = h2.mean() - h1.mean()
    converged = bool(torch.isfinite(best_e) & (drift < 4.0 * se + 0.1))
    return mu, L, elbos, theta_d, chi_d, rsq_d, aic_d, converged, logw


def _setup(theta_init, walk_mask, use_priors, prior_logpdf, device):
    theta_init = device_tensor(theta_init, torch.float64, device).ravel()
    P = theta_init.shape[0]
    mask = np.ones(P) if walk_mask is None else np.ravel(
        np.asarray(walk_mask, float))
    free_idx = np.where(mask != 0)[0]
    if free_idx.size == 0:
        raise ValueError("advi: every dimension is masked static")
    if use_priors and prior_logpdf is None:
        raise ValueError("use_priors=True requires prior_logpdf")
    return theta_init, free_idx


def _result(out, free_idx, device):
    mu, L, elbos, theta_d, chi_d, rsq_d, aic_d, conv, logw = out
    return ADVIResult(mu=mu, L=L, elbo=elbos, theta=theta_d, chi=chi_d,
                      rsquared=rsq_d, aic=aic_d,
                      free_idx=torch.as_tensor(free_idx, device=device),
                      converged=conv, logw=logw)


def advi(spec, obs, times, y0_base, theta_init, *, steps: int = 800,
         learning_rate: float = 0.05, n_mc: int = 8, full_rank: bool = True,
         draws: int = 1000, walk_mask=None, prior_logpdf=None,
         use_priors: bool = False, seed: int = 0,
         method: str = "fixed_dopri5", substeps=4,
         device="cuda") -> ADVIResult:
    """Fit a Gaussian ``q(z)`` to the log-parameter posterior and draw
    ``draws`` posterior draws from it (``odelib_tpu``'s ``advi``).

    ``theta_init``: (P,) starting point (linear space), ideally a MAP or
    min-chi point. ``walk_mask`` pins dims exactly like the MH samplers.
    ``prior_logpdf(theta (n, P)) -> (n,)`` enters with ``use_priors``. The
    key is ``PRNGKey(seed)``. Requires a fixed-step solve
    (``fixed_dopri5``/``rk4``). A tensor ``theta_init`` keeps its device,
    an array goes to ``device``; the results are tensors there.
    """
    theta_init, free_idx = _setup(theta_init, walk_mask, use_priors,
                                  prior_logpdf, device)
    if method not in FIXED_METHODS:
        raise ValueError("advi requires a fixed-step differentiable "
                         "integrator: 'fixed_dopri5' or 'rk4'")
    num_params = int(torch.count_nonzero(theta_init))
    metrics = metrics_fn(
        spec, obs, times, y0_base, num_params, theta_init, method=method,
        substeps=substeps if isinstance(substeps, tuple) else int(substeps))
    out = _advi_core(
        metrics, prior_logpdf if use_priors else None, torch.log(theta_init),
        free_idx, jr.PRNGKey(int(seed), device=theta_init.device),
        F=int(free_idx.size), steps=int(steps),
        learning_rate=float(learning_rate), n_mc=int(n_mc),
        full_rank=bool(full_rank), draws=int(draws))
    return _result(out, free_idx, theta_init.device)


def advi_custom(chi_fn, theta_init, *, steps: int = 800,
                learning_rate: float = 0.05, n_mc: int = 8,
                full_rank: bool = True, draws: int = 1000, walk_mask=None,
                prior_logpdf=None, use_priors: bool = False, seed: int = 0,
                device="cuda") -> ADVIResult:
    """:func:`advi` against any differentiable ``chi_fn(theta (n, D)) ->
    (n,)`` (a JointFit's summed chi; ``odelib_tpu``'s ``advi_custom``);
    the rsquared and aic draws come back NaN."""
    theta_init, free_idx = _setup(theta_init, walk_mask, use_priors,
                                  prior_logpdf, device)
    out = _advi_core(
        custom_metrics(chi_fn), prior_logpdf if use_priors else None,
        torch.log(theta_init), free_idx,
        jr.PRNGKey(int(seed), device=theta_init.device),
        F=int(free_idx.size), steps=int(steps),
        learning_rate=float(learning_rate), n_mc=int(n_mc),
        full_rank=bool(full_rank), draws=int(draws))
    return _result(out, free_idx, theta_init.device)


def psis_weights(logw):
    """Pareto-smooth the draws' raw log importance weights: ``(normalized
    log-weights, khat)`` (Yao et al. 2018); khat < 0.7 means the smoothed
    weights reliably correct q toward the true posterior."""
    from ..utils.model_comparison import _psis_smooth_lw

    logw = np.asarray(logw, float)
    finite = np.isfinite(logw)
    if not finite.any():
        return np.full_like(logw, -np.inf), float("inf")
    safe = np.where(finite, logw, logw[finite].min() - 50.0)
    return _psis_smooth_lw(safe)


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def attach_advi_diagnostics(df, res, *, seed, resample=False,
                            label="ADVI"):
    """The post-processing behind ``fit_advi`` (single-model and joint):
    PSIS-smooth the draws' importance weights, attach the
    ``df.attrs['advi']`` info dict, optionally importance-resample the
    rows, and warn on a failed convergence or khat > 0.7. Returns ``(df,
    khat)``."""
    lw, khat = psis_weights(_host(res.logw).astype(float))
    info = {
        "elbo": _host(res.elbo),
        "mu": _host(res.mu),
        "L": _host(res.L),
        "free_idx": _host(res.free_idx),
        "converged": bool(res.converged),
        "khat": khat,
        "psis_logw": lw,
    }
    if resample:
        df = df.iloc[resample_indices(lw, int(seed))]
        df = df.reset_index(drop=True)
    df.attrs["advi"] = info
    if not bool(res.converged):
        warnings.warn(f"{label} did not converge (non-finite or unstable "
                      "ELBO tail); inspect df.attrs['advi']['elbo'], "
                      "lower learning_rate or raise steps")
    if khat > 0.7:
        warnings.warn(
            f"{label} khat = {khat:.2f} > 0.7: the Gaussian approximation "
            "is unreliable for this posterior even after importance "
            "correction — use MCMC")
    return df, khat


def resample_indices(logw_norm, seed: int = 0):
    """Systematic resampling indices by normalized log-weights: weighted
    q-draws into unweighted draws from the corrected posterior."""
    w = np.exp(logw_norm - np.max(logw_norm))
    w = w / w.sum()
    n = len(w)
    rng = np.random.default_rng(seed)
    positions = (np.arange(n) + rng.uniform()) / n
    # cumsum(w)[-1] can land a float ulp below the largest position;
    # clip so the returned indices are always valid row positions
    return np.minimum(np.searchsorted(np.cumsum(w), positions), n - 1)
