"""Pharmacokinetic models: one-compartment oral absorption and the
two-compartment disposition model, with their literature priors.
Counterpart of ``odelib_tpu/models/pharmacology.py``; bolus doses are
given to the framework as ``dose_events``."""
from __future__ import annotations

import torch

from .. import distributions as D
from .base import ModelDef, register


def _pk_oral(t, y, ps):
    """First-order absorption into a single well-stirred compartment."""
    ka, ke, V = ps
    A, C = y[0], y[1]           # gut amount, central concentration
    dA = -ka * A
    dC = ka * A / V - ke * C
    return torch.stack([dA, dC])


def _pk_two_compartment(t, y, ps):
    """Central/peripheral disposition in clearance parameterization."""
    CL, Q, V1, V2 = ps
    C1, C2 = y[0], y[1]         # central, peripheral concentrations
    dC1 = -(CL + Q) / V1 * C1 + Q / V1 * C2
    dC2 = Q / V2 * C1 - Q / V2 * C2
    return torch.stack([dC1, dC2])


pk_oral = register(ModelDef(
    name="pk_oral", rhs=_pk_oral,
    pnames=("ka", "ke", "V"), snames=("A_gut", "C"),
    default_theta=(1.2, 0.25, 30.0),
    default_y0=(100.0, 0.0), default_t_end=24.0,
    priors=lambda: {"ka": D.LogNormal(s=1.0, scale=1.0),
                    "ke": D.LogNormal(s=1.0, scale=0.2),
                    "V": D.LogNormal(s=1.0, scale=30.0)},
    doc="One-compartment model with first-order oral absorption "
        "(Bateman 1924): gut amount A_gut absorbed at rate ka into a "
        "central compartment of volume V, eliminated at rate ke."))

pk_two_compartment = register(ModelDef(
    name="pk_two_compartment", rhs=_pk_two_compartment,
    pnames=("CL", "Q", "V1", "V2"), snames=("C1", "C2"),
    default_theta=(5.0, 10.0, 20.0, 50.0),
    default_y0=(5.0, 0.0), default_t_end=24.0,
    priors=lambda: {"CL": D.LogNormal(s=1.0, scale=5.0),
                    "Q": D.LogNormal(s=1.0, scale=10.0),
                    "V1": D.LogNormal(s=1.0, scale=20.0),
                    "V2": D.LogNormal(s=1.0, scale=50.0)},
    doc="Two-compartment IV-bolus disposition model in the clearance "
        "parameterization (CL systemic clearance, Q inter-compartmental "
        "clearance, V1/V2 central/peripheral volumes; Gibaldi & Perrier "
        "1982)."))
