"""Host-virus infection-state models, the reference's flagship family.
Counterpart of ``odelib_tpu/models/infection.py``: zero, one or two latent
infected classes between adsorption and lysis, with the demo's lognormal
priors."""
from __future__ import annotations

import torch

from .. import distributions as D
from .base import ModelDef, register


def _zero_i(t, y, ps):
    mu, phi, beta = ps
    S, V = y[0], y[1]
    dS = mu * S - phi * S * V
    dV = beta * phi * S * V - phi * S * V
    return torch.stack([dS, dV])


def _one_i(t, y, ps):
    mu, phi, beta, lam = ps
    S, I1, V = y[0], y[1], y[2]
    dS = mu * S - phi * S * V
    dI1 = phi * S * V - lam * I1
    dV = beta * lam * I1 - phi * S * V
    return torch.stack([dS, dI1, dV])


def _two_i(t, y, ps):
    mu, phi, beta, lam, tau = ps
    S, I1, I2, V = y[0], y[1], y[2], y[3]
    dS = mu * S - phi * S * V
    dI1 = phi * S * V - tau * I1
    dI2 = tau * I1 - lam * I2
    dV = beta * lam * I2 - phi * S * V
    return torch.stack([dS, dI1, dI2, dV])


def _priors_zero():
    return {"mu": D.LogNormal(s=3.0, scale=1e-8),
            "phi": D.LogNormal(s=3.0, scale=1e-8),
            "beta": D.LogNormal(s=1.0, scale=25.0)}


def _priors_one():
    return {"mu": D.LogNormal(s=3.0, scale=1e-8),
            "phi": D.LogNormal(s=3.0, scale=1e-8),
            "beta": D.LogNormal(s=1.0, scale=20.0),
            "lam": D.LogNormal(s=2.0, scale=0.1)}


def _priors_two():
    p = _priors_one()
    p["tau"] = D.LogNormal(s=2.0, scale=1.0)
    return p


zero_i = register(ModelDef(
    name="zero_i", rhs=_zero_i,
    pnames=("mu", "phi", "beta"), snames=("S", "V"),
    default_theta=(0.6, 2.4e-8, 24.0),
    default_y0=(5.2e6, 1.1e7), default_t_end=3.0,
    priors=_priors_zero,
    doc="Host-virus model without infected classes: growth mu, adsorption "
        "phi, burst size beta."))

one_i = register(ModelDef(
    name="one_i", rhs=_one_i,
    pnames=("mu", "phi", "beta", "lam"), snames=("S", "I1", "V"),
    default_theta=(0.6, 2.4e-8, 20.0, 3.0),
    default_y0=(5.2e6, 0.0, 1.1e7), default_t_end=3.0,
    priors=_priors_one,
    state_summations={"H": ["S", "I1"]},
    doc="One latent infected class I1 with lysis rate lam; observed host "
        "H = S + I1."))

two_i = register(ModelDef(
    name="two_i", rhs=_two_i,
    pnames=("mu", "phi", "beta", "lam", "tau"),
    snames=("S", "I1", "I2", "V"),
    default_theta=(0.6, 2.4e-8, 20.0, 3.0, 2.0),
    default_y0=(5.2e6, 0.0, 0.0, 1.1e7), default_t_end=3.0,
    priors=_priors_two,
    state_summations={"H": ["S", "I1", "I2"]},
    doc="Two sequential infected classes (transition tau, lysis lam); "
        "observed host H = S + I1 + I2."))
