"""Population-dynamics models: Lotka-Volterra, logistic growth, chemostat.
Counterpart of ``odelib_tpu/models/ecology.py``. Lotka-Volterra is the
framework's sweep model (``bench/suite.py`` config 3); a chemostat's
dilution rate ``d`` and feed ``Rin`` are known settings of each run, so
they have no prior and are fixed unless a fit walks them."""
from __future__ import annotations

import torch

from .. import distributions as D
from .base import ModelDef, register


def _lotka_volterra(t, y, ps):
    alpha, beta, delta, gamma = ps
    prey, pred = y[0], y[1]
    dprey = alpha * prey - beta * prey * pred
    dpred = delta * prey * pred - gamma * pred
    return torch.stack([dprey, dpred])


def _logistic(t, y, ps):
    r, K = ps
    N = y[0]
    return torch.stack([r * N * (1.0 - N / K)])


def _chemostat(t, y, ps):
    """Monod chemostat: substrate R fed at concentration Rin, dilution d;
    consumer N with max growth vmax, half-saturation Ks, yield gamma."""
    vmax, Ks, gamma, d, Rin = ps
    R, N = y[0], y[1]
    growth = vmax * R / (Ks + R)
    dR = d * (Rin - R) - growth * N / gamma
    dN = (growth - d) * N
    return torch.stack([dR, dN])


lotka_volterra = register(ModelDef(
    name="lotka_volterra", rhs=_lotka_volterra,
    pnames=("alpha", "beta", "delta", "gamma"), snames=("prey", "predator"),
    default_theta=(1.1, 0.4, 0.1, 0.4),
    default_y0=(10.0, 10.0), default_t_end=50.0,
    priors=lambda: {"alpha": D.LogNormal(s=1.0, scale=1.0),
                    "beta": D.LogNormal(s=1.0, scale=0.5),
                    "delta": D.LogNormal(s=1.0, scale=0.1),
                    "gamma": D.LogNormal(s=1.0, scale=0.5)},
    doc="Two-species predator-prey oscillator (Lotka 1925, Volterra "
        "1926)."))

logistic = register(ModelDef(
    name="logistic", rhs=_logistic,
    pnames=("r", "K"), snames=("N",),
    default_theta=(0.5, 1e6),
    default_y0=(1e3,), default_t_end=40.0,
    priors=lambda: {"r": D.LogNormal(s=1.0, scale=0.5),
                    "K": D.LogNormal(s=2.0, scale=1e6)},
    doc="Logistic (Verhulst) growth to carrying capacity K at rate r."))

chemostat = register(ModelDef(
    name="chemostat", rhs=_chemostat,
    pnames=("vmax", "Ks", "gamma", "d", "Rin"),
    snames=("R", "N"),
    default_theta=(1.0, 0.5, 1e6, 0.2, 5.0),
    default_y0=(5.0, 1e3), default_t_end=80.0,
    priors=lambda: {"vmax": D.LogNormal(s=1.0, scale=1.0),
                    "Ks": D.LogNormal(s=1.5, scale=0.5),
                    "gamma": D.LogNormal(s=2.0, scale=1e6),
                    "d": None, "Rin": None},
    doc="Monod chemostat: substrate-limited microbial growth under "
        "continuous dilution (Monod 1950, Novick & Szilard 1950); the "
        "dilution rate and feed concentration are known settings, fixed "
        "by default."))
