"""Draw-based predictive model comparison: WAIC and PSIS-LOO.

Counterpart of ``odelib_tpu/utils/model_comparison.py``, copied line for
line (numpy only, so its results are the reference's bit for bit): WAIC
(Watanabe) and leave-one-out cross-validation estimated by Pareto-smoothed
importance sampling (Vehtari, Gelman & Gabry 2017) from a pointwise
log-likelihood matrix ``ll[s, i]`` = log p(obs_i | theta_s), ``compare``
to rank models by either, and the Pareto smoothing itself
(``_psis_smooth_lw``, which ADVI's ``psis_weights`` also uses). Per-point
Pareto k-hat diagnostics come free with PSIS: k > 0.7 flags observations
whose leave-one-out posterior is poorly approximated.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["waic", "psis_loo", "compare"]


def waic(loglik: np.ndarray) -> Dict[str, float]:
    """Widely Applicable Information Criterion from a pointwise
    log-likelihood matrix ``loglik`` of shape (draws S, observations N).

    Returns elpd_waic (predictive, higher better), p_waic (effective
    parameter count), waic (deviance scale, lower better) and the
    standard error of elpd_waic over observations.
    """
    ll = np.asarray(loglik, np.float64)
    if ll.ndim != 2:
        raise ValueError(f"loglik must be (draws, obs), got {ll.shape}")
    S, N = ll.shape
    m = ll.max(axis=0)
    lppd_i = m + np.log(np.mean(np.exp(ll - m), axis=0))
    p_i = ll.var(axis=0, ddof=1)
    elpd_i = lppd_i - p_i
    return {
        "elpd_waic": float(elpd_i.sum()),
        "p_waic": float(p_i.sum()),
        "waic": float(-2.0 * elpd_i.sum()),
        "se_elpd_waic": float(np.sqrt(N * elpd_i.var(ddof=1))),
    }


def _gpd_fit(x: np.ndarray):
    """Generalized-Pareto (k, sigma) fit to exceedances ``x`` > 0 by the
    Zhang & Stephens (2009) empirical-Bayes profile method, with the
    PSIS-paper weak-prior regularization of k-hat."""
    x = np.asarray(x, np.float64)
    x = np.sort(x[np.isfinite(x) & (x > 0)])
    n = len(x)
    if n < 5:
        return 0.5, max(float(x[-1]) if n else 1e-12, 1e-12)
    m = 30 + int(np.sqrt(n))
    j = np.arange(1, m + 1)
    xq = x[int(n / 4.0 + 0.5) - 1]
    theta = 1.0 / x[-1] + (1.0 - np.sqrt(m / (j - 0.5))) / (3.0 * xq)
    theta = theta[theta != 0.0]
    # Pareto-shape convention: k here IS the PSIS k-hat (xi); the scale
    # candidates theta relate by theta = -k/sigma
    k_j = np.mean(np.log1p(-theta[:, None] * x[None, :]), axis=1)
    l_j = n * (np.log(-theta / k_j) - k_j - 1.0)
    l_j = l_j - l_j.max()
    w = np.exp(l_j)
    w = w / w.sum()
    theta_hat = float(np.sum(w * theta))
    k = float(np.mean(np.log1p(-theta_hat * x)))
    sigma = -k / theta_hat if theta_hat != 0 else float(x[-1])
    # regularize k toward 0.5 with 10 pseudo-observations (avoids huge
    # k-hat noise at small tail sizes; Vehtari et al. 2017 appendix)
    k = (n * k + 5.0) / (n + 10.0)
    return k, max(float(sigma), 1e-12)


def _psis_smooth_lw(lw: np.ndarray):
    """Pareto-smooth one observation's log importance weights (S,).
    Returns (smoothed normalized log-weights, k-hat)."""
    S = len(lw)
    M = int(np.ceil(min(0.2 * S, 3.0 * np.sqrt(S))))
    if M < 5:
        return lw - _logsumexp(lw), 0.0
    lw = lw - lw.max()   # normalization-invariant; keeps exp() in range
    # the cutoff and the M largest by one selection, not a sort of all S
    # (the same values: of tied weights, which index is in the tail may
    # differ, and their smoothed values are equal); S > M here
    part = np.argpartition(lw, S - M - 1)
    u = lw[part[S - M - 1]]
    tail_idx = part[S - M:]
    lw_max_raw = lw[tail_idx].max()
    # fit in cutoff-relative scale: exceedances of w/e^u over 1 — the GPD
    # shape is scale-invariant, and this avoids exp(u) overflow/underflow
    # when the weights are extremely concentrated
    exceed = np.expm1(lw[tail_idx] - u)
    pos = exceed[exceed > 0]
    if len(pos) < 5:         # degenerate tail (ties at the cutoff)
        return lw - _logsumexp(lw), 0.0
    k, sigma = _gpd_fit(exceed)
    if not np.isfinite(k):
        return lw - _logsumexp(lw), 0.0
    # replace tail by expected order statistics of the fitted GPD
    q = (np.arange(1, M + 1) - 0.5) / M
    if abs(k) < 1e-8:
        smoothed = -sigma * np.log1p(-q)
    else:
        smoothed = sigma / k * ((1.0 - q) ** (-k) - 1.0)
    new_tail = u + np.log1p(smoothed)
    # PSIS truncation: no smoothed weight above the raw maximum
    new_tail = np.minimum(new_tail, lw_max_raw)
    out = lw.copy()
    out[tail_idx[np.argsort(lw[tail_idx])]] = np.sort(new_tail)
    return out - _logsumexp(out), float(k)


def _logsumexp(a):
    m = np.max(a)
    return m + np.log(np.sum(np.exp(a - m)))


def psis_loo(loglik: np.ndarray) -> Dict[str, object]:
    """PSIS leave-one-out expected log predictive density from a
    (draws S, observations N) pointwise log-likelihood matrix.

    Returns elpd_loo / p_loo / looic, its standard error, and the
    per-observation Pareto ``khat`` array (k > 0.7 = unreliable point).
    """
    ll = np.asarray(loglik, np.float64)
    if ll.ndim != 2:
        raise ValueError(f"loglik must be (draws, obs), got {ll.shape}")
    S, N = ll.shape
    elpd_i = np.empty(N)
    khat = np.empty(N)
    m = ll.max(axis=0)
    lppd_i = m + np.log(np.mean(np.exp(ll - m), axis=0))
    for i in range(N):
        lw, k = _psis_smooth_lw(-ll[:, i])
        elpd_i[i] = _logsumexp(lw + ll[:, i])
        khat[i] = k
    p_loo = float(lppd_i.sum() - elpd_i.sum())
    return {
        "elpd_loo": float(elpd_i.sum()),
        "p_loo": p_loo,
        "looic": float(-2.0 * elpd_i.sum()),
        "se_elpd_loo": float(np.sqrt(N * elpd_i.var(ddof=1))),
        "khat": khat,
        "n_bad_khat": int(np.sum(khat > 0.7)),
    }


def compare(criteria: Dict[str, Dict[str, float]],
            key: str = "elpd_loo", higher_better: bool = None):
    """Rank models by a predictive criterion: ``{name: result_dict}`` ->
    list of (name, value, delta_to_best), best first.

    Direction is inferred from the key: ``elpd_*``/``lppd`` are
    higher-is-better, ``waic``/``looic``/``aic`` (deviance scale) are
    lower-is-better. Pass ``higher_better`` explicitly for other keys.
    """
    if higher_better is None:
        if key.startswith(("elpd", "lppd", "log")):
            higher_better = True
        elif key in ("waic", "looic", "aic", "p_waic", "p_loo") \
                or key.endswith("ic"):
            higher_better = False
        else:
            raise ValueError(f"cannot infer ranking direction for "
                             f"{key!r}; pass higher_better=")
    sign = -1.0 if higher_better else 1.0
    items = sorted(criteria.items(), key=lambda kv: sign * kv[1][key])
    best = items[0][1][key]
    return [(name, d[key], d[key] - best) for name, d in items]
