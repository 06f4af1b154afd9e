"""In-kernel priors: the per-slot table the kernels read and its torch twin.

Counterpart of ``_kernel_logpdf`` in ``odelib_tpu/ops/pallas_mh.py`` for
the three families the port has (LogNormal, Normal, Uniform). The
normalising constants are computed on the host in float64 and rounded to
float32 with every other hyperparameter, exactly where the JAX kernel's
Python floats meet its float32 theta; ``csrc/common.cuh``'s ``log_prior``
and :func:`logprior_plain` then perform the same float32 operations.
So far only the particle-filter kernel (``csrc/pf.cu``) reads the table;
priors in the other kernels are ROADMAP queue 1, item 12.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import distributions as D
from .runge_kutta import const

WIDTH = 5      # family, loc, scale, s or upper edge, constant
_NONE, _LOGNORMAL, _NORMAL, _UNIFORM = range(4)
_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def prior_table(priors) -> np.ndarray:
    """(P, 5) float32 table of per-slot priors (None for no prior).
    Raises ``NotImplementedError`` for a family the kernels lack."""
    rows = []
    for d in priors:
        if d is None:
            rows.append((_NONE, 0.0, 1.0, 1.0, 0.0))
        elif isinstance(d, D.LogNormal):
            rows.append((_LOGNORMAL, d.loc, d.scale, d.s,
                         -math.log(d.s) - math.log(d.scale) - _HALF_LOG_2PI))
        elif isinstance(d, D.Normal):
            rows.append((_NORMAL, d.loc, d.scale, 1.0,
                         -math.log(d.scale) - _HALF_LOG_2PI))
        elif isinstance(d, D.Uniform):
            rows.append((_UNIFORM, d.loc, d.scale, d.loc + d.scale,
                         -math.log(d.scale)))
        else:
            raise NotImplementedError(
                f"in-kernel prior family {type(d).__name__} is not ported "
                "yet (ROADMAP queue 1, item 12)")
    return np.asarray(rows, np.float64).astype(np.float32).reshape(-1, WIDTH)


def logprior_plain(table, theta):
    """Twin of the kernels' per-slot prior sum: ``theta`` is a list of P
    float32 tensors; slots without a prior add nothing, the others add to
    a zero start in slot order."""
    tot = torch.zeros_like(theta[0])
    for e, x in zip(np.asarray(table), theta):
        fam = int(e[0])
        if fam == _NONE:
            continue
        c = [const(float(v), x) for v in e[1:]]
        if fam == _LOGNORMAL:
            y = (x - c[0]) / c[1]
            ly = torch.log(torch.maximum(y, const(1e-37, x)))
            q = ly / c[2]
            lp = torch.where(y > 0, const(-0.5, x) * (q * q) - ly + c[3],
                             const(-math.inf, x))
        elif fam == _NORMAL:
            z = (x - c[0]) / c[1]
            lp = const(-0.5, x) * z * z + c[3]
        else:
            lp = torch.where((x >= c[0]) & (x <= c[2]), c[3],
                             const(-math.inf, x))
        tot = tot + lp
    return tot
