"""Goodness-of-fit statistics as batch-friendly torch reductions.

Counterpart of ``odelib_tpu/stats.py`` for the main path: the reduced
chi-square, AIC, the observation likelihood of every family with Tobit
censoring, R^2 (dict and flat forms), adjusted R^2 and ``rawstats``.
Inputs may be numpy arrays or tensors; results are tensors.
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


def _t_logcdf(t, nu):
    """log CDF of the Student-t with ``nu`` dof by the regularized
    incomplete beta: T(t) = I_x(nu/2, 1/2)/2 for t < 0 and 1 - I_x/2
    otherwise, x = nu/(nu + t^2)."""
    from .distributions import betainc
    x = nu / (nu + t * t)
    half_tail = 0.5 * betainc(0.5 * nu, 0.5, x)
    return torch.where(t < 0, torch.log(half_tail), torch.log1p(-half_tail))


def obs_negloglik(obs_model, obs_param, log_O, log_C, S, O=None, C=None,
                  censor=None):
    """Negative log-likelihood of the observations up to a theta-free
    constant, reduced over the last axis (``odelib_tpu.stats``' families):

    * ``'lognormal'``: the reference's reduced chi-square in log space;
    * ``'student_t'``: Student-t with ``obs_param`` dof in log space at
      scale ``S``;
    * ``'poisson'``: ``sum(C - O log C)`` on the linear ``O``, ``C``;
    * ``'negbinom'``: dispersion ``r = obs_param``,
      ``sum(r log1p(C/r) + O log1p(r/C))``.

    Invalid observations drop out; a non-finite or negative prediction at a
    valid observation gives a non-finite score; ``O = 0`` is a valid
    count. ``censor`` (int (N,), optional): 0 exact, 1 left-censored at the
    recorded limit (-log F), 2 right-censored (-log S) of the same model
    (Tobit). ``O``/``C`` default to ``exp(log_O)``/``exp(log_C)``."""
    cen = None if censor is None else _t(censor, torch.int64)
    if obs_model in ("lognormal", "student_t"):
        log_O = _t(log_O)
        valid = torch.isfinite(log_O)
        z = (torch.where(valid, log_O, 0.0) - _t(log_C)) / _t(S)
        if obs_model == "lognormal":
            term = 0.5 * z * z
            if cen is not None:
                term = torch.where(
                    cen == 1, -torch.special.log_ndtr(z),
                    torch.where(cen == 2, -torch.special.log_ndtr(-z), term))
        else:
            nu = float(obs_param)
            term = 0.5 * (nu + 1.0) * torch.log1p(z * z / nu)
            if cen is not None:
                term = torch.where(
                    cen == 1, -_t_logcdf(z, nu),
                    torch.where(cen == 2, -_t_logcdf(-z, nu), term))
        # NaN z (failed prediction) propagates through every branch
        return torch.sum(torch.where(valid, term, 0.0), dim=-1)
    O = torch.exp(_t(log_O)) if O is None else _t(O)
    C = torch.exp(_t(log_C)) if C is None else _t(C)
    valid = torch.isfinite(O)
    Ov = torch.where(valid, O, 0.0)
    if obs_model == "poisson":
        # O = 0: the O log C term vanishes, so C = 0 scores 0 there
        term = C - torch.where(Ov > 0, Ov * torch.log(C), 0.0)
        if cen is not None:
            # P(X <= k) = Q(k + 1, C), P(X > k) = P(k + 1, C)
            k1 = torch.floor(Ov) + 1.0
            Cs = torch.clamp(C, min=0.0)
            term = torch.where(
                cen == 1, -torch.log(torch.special.gammaincc(k1, Cs)),
                torch.where(cen == 2,
                            -torch.log(torch.special.gammainc(k1, Cs)),
                            term))
    elif obs_model == "negbinom":
        # log1p forms: log(r + C) - log(C) cancels when C >> r
        r = float(obs_param)
        term = r * torch.log1p(C / r) \
            + torch.where(Ov > 0, Ov * torch.log1p(r / C), 0.0)
        if cen is not None:
            # NB(r, p = r/(r + C)): P(X <= k) = I_p(r, k + 1),
            # P(X > k) = I_{1-p}(k + 1, r)
            from .distributions import betainc
            k1 = torch.floor(Ov) + 1.0
            Cs = torch.clamp(C, min=0.0)
            p = r / (r + Cs)
            term = torch.where(
                cen == 1, -torch.log(betainc(r, k1, p)),
                torch.where(cen == 2, -torch.log(betainc(k1, r, 1.0 - p)),
                            term))
    else:
        raise ValueError(f"unknown obs_model {obs_model!r}")
    # a negative intensity must not score finite (C - O log C would)
    term = torch.where(C >= 0, term, torch.nan)
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
