"""In-kernel priors: the per-slot table the kernels read and its torch twin.

Counterpart of ``_kernel_logpdf``/``kernel_priors_supported`` in
``odelib_tpu/ops/pallas_mh.py`` for its ten in-kernel families: LogNormal,
Normal, Uniform, Gamma, TruncNormal, Exponential, Cauchy, HalfNormal,
Weibull and Beta. Every hyperparameter and normalising constant is computed
on the host in float64 (``math.lgamma``, ``math.erf``) and rounded to
float32, exactly where the JAX kernel's Python floats meet its float32
theta; ``csrc/common.cuh``'s ``log_prior`` and :func:`logprior_plain` then
perform the same float32 operations in the same order. The MH, ensemble,
PT, joint and particle-filter kernels all read the table. ``DiscreteNormal``
and priors with array-valued hyperparameters have no in-kernel form.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import distributions as D
from .runge_kutta import const

# family, loc, scale, two shape values p1 and p2, the normalising constant
WIDTH = 6
(_NONE, _LOGNORMAL, _NORMAL, _UNIFORM, _GAMMA, _TRUNCNORMAL, _EXPONENTIAL,
 _CAUCHY, _HALFNORMAL, _WEIBULL, _BETA) = range(11)
_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def _ndtr(z: float) -> float:
    if not math.isfinite(z):
        return 1.0 if z > 0 else 0.0
    return 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))


def _row(d):
    """The float64 table row of one prior, or None without an in-kernel
    form."""
    if d is None:
        return (_NONE, 0.0, 1.0, 0.0, 0.0, 0.0)
    try:
        f = {k.name: float(getattr(d, k.name)) for k in dataclasses.fields(d)}
    except (TypeError, ValueError):
        return None     # an array-valued hyperparameter
    loc, scale = f.get("loc", 0.0), f.get("scale", 1.0)
    log_scale = math.log(scale) if scale > 0 else math.nan
    if isinstance(d, D.LogNormal):
        return (_LOGNORMAL, loc, scale, f["s"], 0.0,
                -math.log(f["s"]) - log_scale - _HALF_LOG_2PI)
    if isinstance(d, D.Normal):
        return (_NORMAL, loc, scale, 0.0, 0.0, -log_scale - _HALF_LOG_2PI)
    if isinstance(d, D.Uniform):
        return (_UNIFORM, loc, scale, loc + scale, 0.0, -log_scale)
    if isinstance(d, D.Gamma):
        return (_GAMMA, loc, scale, f["a"] - 1.0, 0.0,
                -math.lgamma(f["a"]) - log_scale)
    if isinstance(d, D.TruncNormal):
        a, b = f["a"], f["b"]
        return (_TRUNCNORMAL, loc, scale, a, b,
                -math.log(_ndtr(b) - _ndtr(a)) - log_scale - _HALF_LOG_2PI)
    if isinstance(d, D.Exponential):
        return (_EXPONENTIAL, loc, scale, 0.0, 0.0, -log_scale)
    if isinstance(d, D.Cauchy):
        return (_CAUCHY, loc, scale, 0.0, 0.0, -math.log(math.pi * scale))
    if isinstance(d, D.HalfNormal):
        return (_HALFNORMAL, loc, scale, 0.0, 0.0,
                0.5 * math.log(2.0 / math.pi) - log_scale)
    if isinstance(d, D.Weibull):
        return (_WEIBULL, loc, scale, f["c"] - 1.0, f["c"],
                math.log(f["c"]) - log_scale)
    if isinstance(d, D.Beta):
        a, b = f["a"], f["b"]
        return (_BETA, loc, scale, a - 1.0, b - 1.0,
                -(math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b))
                - log_scale)
    return None


def kernel_priors_supported(priors) -> bool:
    """True when every prior (None for none) has an in-kernel form."""
    return all(_row(d) is not None for d in priors)


def prior_table(priors) -> np.ndarray:
    """(P, WIDTH) float32 table of per-slot priors (None for no prior).
    Raises the reference's ``ValueError`` for a family without an in-kernel
    form."""
    rows = [_row(d) for d in priors]
    if any(r is None for r in rows):
        raise ValueError(
            "unsupported prior family for the fused kernel: every prior "
            "must be a kernel-supported family (LogNormal, Normal, Uniform, "
            "Gamma, TruncNormal, Exponential, Cauchy, HalfNormal, Weibull, "
            "Beta); use the XLA backend")
    return np.asarray(rows, np.float64).astype(np.float32).reshape(-1, WIDTH)


def require_kernel_priors(priors):
    """``backend='pallas'``'s check of ``use_priors=True``: ``priors`` as
    a tuple when every family has an in-kernel form, else the reference's
    ``ValueError`` (:func:`prior_table`'s)."""
    priors = tuple(priors)
    if not kernel_priors_supported(priors):
        prior_table(priors)
    return priors


def checked_priors(priors, n: int, what: str = "theta slot"):
    """A fused wrapper's ``priors=`` as a table, or None: one entry per
    slot (``ValueError`` otherwise), every family with an in-kernel form
    (:func:`prior_table`'s ``ValueError`` otherwise); all None is no
    priors."""
    if priors is None:
        return None
    priors = tuple(priors)
    if len(priors) != n:
        raise ValueError(f"priors must have one entry per {what} ({n}), "
                         f"got {len(priors)}")
    table = prior_table(priors)
    return None if all(d is None for d in priors) else table


def _log_prior(e, x):
    """One slot's log density from its table row ``e`` (float32 values),
    the operations of common.cuh's log_prior."""
    fam = int(e[0])
    loc, scale, p1, p2, c = (const(float(v), x) for v in e[1:])
    ninf = const(-math.inf, x)
    if fam == _LOGNORMAL:
        y = (x - loc) / scale
        ly = torch.log(torch.maximum(y, const(1e-37, x)))
        q = ly / p1
        return torch.where(y > 0, const(-0.5, x) * (q * q) - ly + c, ninf)
    if fam == _NORMAL:
        z = (x - loc) / scale
        return const(-0.5, x) * z * z + c
    if fam == _UNIFORM:
        return torch.where((x >= loc) & (x <= p1), c, ninf)
    if fam == _GAMMA:
        y = (x - loc) / scale
        ly = torch.log(torch.maximum(y, const(1e-37, x)))
        return torch.where(y > 0, p1 * ly - y + c, ninf)
    if fam == _TRUNCNORMAL:
        z = (x - loc) / scale
        return torch.where((z >= p1) & (z <= p2),
                           const(-0.5, x) * z * z + c, ninf)
    if fam == _EXPONENTIAL:
        y = (x - loc) / scale
        return torch.where(y >= 0, -y + c, ninf)
    if fam == _CAUCHY:
        z = (x - loc) / scale
        return -torch.log1p(z * z) + c
    if fam == _HALFNORMAL:
        z = (x - loc) / scale
        return torch.where(z >= 0, const(-0.5, x) * z * z + c, ninf)
    if fam == _WEIBULL:
        y = (x - loc) / scale
        ly = torch.log(torch.maximum(y, const(1e-37, x)))
        return torch.where(y > 0, p1 * ly - torch.exp(p2 * ly) + c, ninf)
    if fam == _BETA:
        y = (x - loc) / scale
        inside = (y > 0) & (y < 1)
        ys = torch.where(inside, y, const(0.5, x))
        return torch.where(inside, p1 * torch.log(ys)
                           + p2 * torch.log1p(-ys) + c, ninf)
    raise ValueError(f"unknown prior family {fam}")


def logprior_plain(table, theta):
    """Twin of the kernels' per-slot prior sum: ``theta`` is a list of P
    float32 tensors; slots without a prior add nothing, the others add to
    a zero start in slot order."""
    tot = torch.zeros_like(theta[0])
    for e, x in zip(np.asarray(table), theta):
        if int(e[0]) != _NONE:
            tot = tot + _log_prior(e, x)
    return tot
