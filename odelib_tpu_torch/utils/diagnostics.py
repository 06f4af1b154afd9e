"""MCMC convergence diagnostics: split-R-hat, effective sample size and
the per-parameter table.

A numpy copy of ``odelib_tpu/utils/diagnostics.py``'s ``split_rhat``,
``effective_sample_size`` (Gelman et al., *Bayesian Data Analysis* 3rd ed.
§11.4-11.5) and ``summarize`` (:meth:`ModelFramework.diagnostics`), over
the (chains, draws) layout of the posterior records.
They run on the host once per posterior, as the run-length extension of
``ModelFramework.MCMC`` and ``JointFit.MCMC`` (``until_rhat=...``,
``until_min_ess=...``; :func:`extend_until`) calls them.
"""
from __future__ import annotations

import warnings
from typing import Dict

import numpy as np
import pandas as pd
import torch

from .profiling import get_logger


def _split_chains(x: np.ndarray) -> np.ndarray:
    """(C, N) -> (2C, N//2): each chain split in half (an odd middle draw
    dropped)."""
    C, N = x.shape
    h = N // 2
    if h < 1:
        raise ValueError("need at least 2 draws per chain to split")
    return np.concatenate([x[:, :h], x[:, N - h:]], axis=0)


def split_rhat(x) -> float:
    """Split-chain potential scale reduction factor R-hat of ``x``
    (chains, draws); NaN when the within-chain variance is 0 (for
    instance a chain that never accepted)."""
    z = _split_chains(np.asarray(x, float))
    M, N = z.shape
    mean_c = z.mean(axis=1)
    var_c = z.var(axis=1, ddof=1)
    W = var_c.mean()
    B = N * mean_c.var(ddof=1)
    if not np.isfinite(W) or W <= 0:
        return float("nan")
    var_plus = (N - 1) / N * W + B / N
    return float(np.sqrt(var_plus / W))


def _autocov_fft(z: np.ndarray) -> np.ndarray:
    """Per-chain autocovariance by FFT of the demeaned (C, N) ``z``."""
    C, N = z.shape
    n_fft = int(2 ** np.ceil(np.log2(2 * N)))
    f = np.fft.rfft(z, n=n_fft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=n_fft, axis=1)[:, :N].real
    return acov / N


def effective_sample_size(x) -> float:
    """Multi-chain ESS of ``x`` (chains, draws): BDA3 eq. 11.8 with
    Geyer's initial positive sequence; NaN below 4 draws or for a
    degenerate variance."""
    z = np.asarray(x, float)
    if z.ndim == 1:
        z = z[None]
    C, N = z.shape
    if N < 4:
        return float("nan")
    mean_c = z.mean(axis=1, keepdims=True)
    acov = _autocov_fft(z - mean_c)
    W = acov[:, 0].mean()
    var_plus = W * (N - 1) / N + (mean_c[:, 0].var(ddof=1) if C > 1 else 0.0)
    if not np.isfinite(var_plus) or var_plus <= 0:
        return float("nan")
    # the combined lag-t correlation across chains (rho[0] == 1)
    rho = 1.0 - (W - acov.mean(axis=0)) / var_plus
    # Geyer: sum consecutive pairs while they stay positive
    tau = 1.0
    t = 1
    while t + 1 < N:
        pair = rho[t] + rho[t + 1]
        if pair < 0:
            break
        tau += 2.0 * pair
        t += 2
    return float(C * N / max(tau, 1.0))


def summarize(posterior: pd.DataFrame, pnames,
              chain_col: str = "chain#") -> pd.DataFrame:
    """Per-parameter diagnostic table of a posterior DataFrame: mean, std,
    median, ess, ess_per_draw and rhat, the chains cut to the shortest's
    length. Array-valued parameter columns are skipped (pass their
    flattened components' column names). Each chain's rows keep their
    order, gathered by one stable sort of the chain column (the JAX
    package masks the column once per chain, which at 10,000 chains of a
    5-million-row frame takes minutes)."""
    if chain_col not in posterior:
        raise ValueError(f"posterior has no {chain_col!r} column")
    chains = np.asarray(posterior[chain_col].to_numpy(), float)
    rows_in = np.flatnonzero(np.isfinite(chains))
    ids, inv = np.unique(chains[rows_in], return_inverse=True)
    rows_in = rows_in[np.argsort(inv, kind="stable")]
    bounds = np.cumsum(np.bincount(inv, minlength=len(ids)))[:-1]
    rows = {}
    for p in pnames:
        col = posterior[p].to_numpy()
        if col.dtype == object:
            continue
        col = np.asarray(col, float)
        per_chain = np.split(col[rows_in], bounds) if len(ids) else []
        n = min((len(v) for v in per_chain), default=0)
        stats: Dict[str, float] = {
            "mean": float(np.nanmean(col)),
            "std": float(np.nanstd(col, ddof=1)),
            "median": float(np.nanmedian(col)),
        }
        if n >= 4 and len(per_chain) >= 1:
            x = np.stack([v[:n] for v in per_chain])
            finite = np.isfinite(x).all()
            ess = effective_sample_size(x) if finite else float("nan")
            stats["ess"] = ess
            stats["ess_per_draw"] = (ess / x.size if np.isfinite(ess)
                                     else float("nan"))
            stats["rhat"] = (split_rhat(x) if finite and len(per_chain) >= 2
                             else float("nan"))
        else:
            stats["ess"] = stats["ess_per_draw"] = stats["rhat"] = \
                float("nan")
        rows[p] = stats
    return pd.DataFrame(rows).T[
        ["mean", "std", "median", "ess", "ess_per_draw", "rhat"]]


def extend_until(out, run_more, *, nits, mask, until_rhat, until_min_ess,
                 max_extensions, what="run"):
    """Extend a finished run in whole-run increments until the pooled
    posterior meets the split-R-hat / ESS targets or ``max_extensions``
    is spent, then warn (``odelib_tpu``'s ``_extend_until`` of
    ``ModelFramework`` and of ``JointFit``). ``out`` is the run's records
    (a NamedTuple with ``theta`` (C, R, P), ``acceptance_ratio`` (C, R),
    ``iteration`` (R,) and further (C, R, ...) records); each extension
    restarts every chain from its last state with a fresh stream
    (``run_more(theta_last, salt)``, no burn-in) and appends its records,
    with exact global running acceptance ratios and a continuing
    ``iteration`` column. Returns the stitched records, of ``out``'s type,
    as CPU tensors."""
    def host(x):
        return x.cpu().numpy()
    recs = {k: host(v) for k, v in out._asdict().items()}
    ar, iteration = recs.pop("acceptance_ratio"), recs.pop("iteration")
    total = int(iteration[-1])          # global proposals so far
    counts = ar[:, -1] * total          # accepts, burn-in included
    mask_flat = np.ravel(np.asarray(mask, float))
    walked = [j for j in range(recs["theta"].shape[-1]) if mask_flat[j] != 0]

    def worst():
        max_rh, min_ess = 0.0, float("inf")
        for j in walked:
            x = recs["theta"][:, :, j].astype(float)
            if np.allclose(x, x.flat[0]):   # a pinned slot
                continue
            z = np.log(x) if np.all(x > 0) else x
            max_rh = max(max_rh, float(split_rhat(z)))
            min_ess = min(min_ess, float(effective_sample_size(z)))
        return max_rh, min_ess

    for ext in range(max_extensions + 1):
        max_rh, min_ess = worst()
        if ((until_rhat is None or max_rh <= until_rhat)
                and (until_min_ess is None or min_ess >= until_min_ess)):
            if ext:
                get_logger().info("%s converged after %d extension(s): "
                                  "max split-rhat %.4f, min ESS %.0f", what,
                                  ext, max_rh, min_ess)
            break
        if ext == max_extensions:
            warnings.warn(
                f"{what}-length extension cap reached (max_extensions="
                f"{max_extensions}) without meeting the targets: max "
                f"split-rhat {max_rh:.4f} (target {until_rhat}), min ESS "
                f"{min_ess:.0f} (target {until_min_ess}) — the returned "
                "posterior holds everything sampled so far")
            break
        get_logger().info("extending %s (%d/%d): max split-rhat %.4f, min "
                          "ESS %.0f", what, ext + 1, max_extensions, max_rh,
                          min_ess)
        more = run_more(recs["theta"][:, -1, :], ext + 1)
        its = np.arange(1, nits)
        m_counts = host(more.acceptance_ratio) * its[None, :]
        ar = np.concatenate(
            [ar, (counts[:, None] + m_counts) / (total + its)[None, :]],
            axis=1)
        recs = {k: np.concatenate([v, host(getattr(more, k))], axis=1)
                for k, v in recs.items()}
        iteration = np.concatenate([iteration, total + its])
        counts = counts + m_counts[:, -1]
        total += nits - 1
    return type(out)(**{k: torch.as_tensor(v) for k, v in recs.items()},
                     acceptance_ratio=torch.as_tensor(ar),
                     iteration=torch.as_tensor(iteration))
