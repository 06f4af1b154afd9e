"""Goodness-of-fit statistics as batch-friendly torch reductions.

Counterpart of ``odelib_tpu/stats.py`` for the main path: the reduced
chi-square, AIC, the lognormal branch of the observation likelihood,
R^2 (dict and flat forms), adjusted R^2 and ``rawstats``. Inputs may be
numpy arrays or tensors; results are tensors.
"""
from __future__ import annotations

import torch


def _t(x, dtype=torch.float64):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, dtype=dtype)


def chi(O, C, S):
    """Reduced chi-square sum((O-C)^2 / (2 S^2)) over the last axis;
    invalid O entries are masked, invalid C propagates."""
    O, C, S = _t(O), _t(C), _t(S)
    valid = torch.isfinite(O)
    term = (torch.where(valid, O, 0.0) - C) ** 2 / (2.0 * S ** 2)
    return torch.sum(torch.where(valid, term, 0.0), dim=-1)


def AIC(chi_val, num_parameters):
    """Akaike information criterion: 2*chi + 2*k."""
    return 2.0 * _t(chi_val) + 2.0 * num_parameters


def obs_negloglik(obs_model, obs_param, log_O, log_C, S, O=None, C=None,
                  censor=None):
    """Negative log-likelihood of the observations (up to a constant),
    reduced over the last axis. Only the uncensored ``'lognormal'`` model
    is ported: the reference's reduced chi-square in log space."""
    if obs_model != "lognormal" or censor is not None:
        raise NotImplementedError(
            f"obs_model={obs_model!r} / censored scoring is not ported yet "
            "(ROADMAP queue 1, item 13)")
    log_O = _t(log_O)
    valid = torch.isfinite(log_O)
    z = (torch.where(valid, log_O, 0.0) - _t(log_C)) / _t(S)
    term = 0.5 * z * z
    return torch.sum(torch.where(valid, term, 0.0), dim=-1)


def Rsqrd(C_dict, O_dict):
    """R^2 across a dict of states: NaN residuals dropped (nansum);
    sstot is n_points * population variance per state."""
    ssres, sstot = 0.0, 0.0
    for sname in C_dict:
        C, O = _t(C_dict[sname]), _t(O_dict[sname])
        r = (C - O) ** 2
        ssres = ssres + torch.sum(torch.where(torch.isnan(r), 0.0, r), -1)
        sstot = sstot + O.shape[-1] * torch.var(O, dim=-1, unbiased=False)
    return 1.0 - ssres / sstot


def rsqrd_flat(C, O, sstot, mask=None):
    """Batched R^2 with states pre-concatenated and sstot precomputed."""
    r = (_t(C) - _t(O)) ** 2
    if mask is not None:
        r = torch.where(_t(mask), r, 0.0)
    ssres = torch.sum(torch.where(torch.isnan(r), 0.0, r), dim=-1)
    return 1.0 - ssres / _t(sstot)


def get_adjusted_rsquared(Rsqrd_val, num_samples, num_parameters):
    """Adjusted R^2."""
    n, p = num_samples, num_parameters
    return 1.0 - (1.0 - _t(Rsqrd_val)) * (n - 1) / (n - p - 1)


def rawstats(samples, dim=-1):
    """Posterior median and lognormal-formula std of a positive sample
    (ddof=1, like pandas ``Series.std``)."""
    logx = torch.log(_t(samples))
    log_mean = torch.mean(logx, dim=dim)
    n = logx.shape[dim] if logx.ndim else 1
    log_std = torch.std(logx, dim=dim, correction=1 if n > 1 else 0)
    median = torch.exp(log_mean)
    std = ((torch.exp(log_std ** 2) - 1.0)
           * torch.exp(2.0 * log_mean + log_std ** 2.0)) ** 0.5
    return median, std
