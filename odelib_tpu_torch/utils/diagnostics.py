"""MCMC convergence diagnostics: split-R-hat and effective sample size.

A numpy copy of ``odelib_tpu/utils/diagnostics.py``'s ``split_rhat`` and
``effective_sample_size`` (Gelman et al., *Bayesian Data Analysis* 3rd ed.
§11.4-11.5), over the (chains, draws) layout of the posterior records.
They run on the host once per posterior, as the run-length extension of
``ModelFramework.MCMC(until_rhat=..., until_min_ess=...)`` calls them.
"""
from __future__ import annotations

import numpy as np


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
