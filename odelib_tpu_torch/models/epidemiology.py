"""Compartmental epidemic models: SIR and SEIR (Kermack-McKendrick, with
frequency-dependent transmission). Counterpart of
``odelib_tpu/models/epidemiology.py``."""
from __future__ import annotations

import torch

from .. import distributions as D
from .base import ModelDef, register


def _sir(t, y, ps):
    beta, gamma = ps
    S, I, R = y[0], y[1], y[2]
    N = S + I + R
    inf = beta * S * I / N
    return torch.stack([-inf, inf - gamma * I, gamma * I])


def _seir(t, y, ps):
    beta, sigma, gamma = ps
    S, E, I, R = y[0], y[1], y[2], y[3]
    N = S + E + I + R
    inf = beta * S * I / N
    return torch.stack([-inf, inf - sigma * E, sigma * E - gamma * I,
                        gamma * I])


sir = register(ModelDef(
    name="sir", rhs=_sir,
    pnames=("beta", "gamma"), snames=("S", "I", "R"),
    default_theta=(0.3, 0.1),
    default_y0=(9.99e5, 1e3, 0.0), default_t_end=160.0,
    priors=lambda: {"beta": D.LogNormal(s=1.0, scale=0.3),
                    "gamma": D.LogNormal(s=1.0, scale=0.1)},
    doc="Kermack-McKendrick SIR with frequency-dependent transmission; "
        "R0 = beta/gamma."))

seir = register(ModelDef(
    name="seir", rhs=_seir,
    pnames=("beta", "sigma", "gamma"), snames=("S", "E", "I", "R"),
    default_theta=(0.3, 0.2, 0.1),
    default_y0=(9.99e5, 0.0, 1e3, 0.0), default_t_end=200.0,
    priors=lambda: {"beta": D.LogNormal(s=1.0, scale=0.3),
                    "sigma": D.LogNormal(s=1.0, scale=0.2),
                    "gamma": D.LogNormal(s=1.0, scale=0.1)},
    doc="SEIR with incubation rate sigma; the exposed class E is latent "
        "(infected but not yet infectious)."))
