"""Stiff chemical-kinetics systems: Robertson, Van der Pol, Oregonator.
Counterpart of ``odelib_tpu/models/chemistry.py``; they are fitted with
the implicit solvers (``method='kvaerno5'`` by default, the fused kernels'
fixed-step ``kvaerno3``). Robertson is ``bench/suite.py``'s stiff batch
(config 5)."""
from __future__ import annotations

import torch

from .. import distributions as D
from .base import ModelDef, register


def _robertson(t, y, ps):
    k1, k2, k3 = ps
    y1, y2, y3 = y[0], y[1], y[2]
    r1 = k1 * y1
    r2 = k2 * y2 * y2
    r3 = k3 * y2 * y3
    return torch.stack([-r1 + r3, r1 - r2 - r3, r2])


def _vanderpol(t, y, ps):
    (mu,) = ps
    x, v = y[0], y[1]
    return torch.stack([v, mu * ((1.0 - x * x) * v) - x])


def _oregonator(t, y, ps):
    """Field-Noyes Oregonator (BZ reaction), standard scaled form."""
    eps, epsp, q, f = ps
    x, z, v = y[0], y[1], y[2]
    dx = (q * z - x * z + x * (1.0 - x)) / eps
    dz = (-q * z - x * z + f * v) / epsp
    dv = x - v
    return torch.stack([dx, dz, dv])


robertson = register(ModelDef(
    name="robertson", rhs=_robertson,
    pnames=("k1", "k2", "k3"), snames=("y1", "y2", "y3"),
    default_theta=(0.04, 3e7, 1e4),
    default_y0=(1.0, 0.0, 0.0), default_t_end=1e5,
    priors=lambda: {"k1": D.LogNormal(s=1.0, scale=0.04),
                    "k2": D.LogNormal(s=1.0, scale=3e7),
                    "k3": D.LogNormal(s=1.0, scale=1e4)},
    stiff=True,
    doc="Robertson (1966) autocatalytic reaction, the classic stiff test "
        "problem; its rate constants span 9 orders of magnitude."))

vanderpol = register(ModelDef(
    name="vanderpol", rhs=_vanderpol,
    pnames=("mu",), snames=("x", "v"),
    default_theta=(1e3,),
    default_y0=(2.0, 0.0), default_t_end=3000.0,
    priors=lambda: {"mu": D.LogNormal(s=1.0, scale=1e3)},
    stiff=True,
    doc="Van der Pol relaxation oscillator; stiffness grows with mu "
        "(mu = 1000 is the standard stiff configuration)."))

oregonator = register(ModelDef(
    name="oregonator", rhs=_oregonator,
    pnames=("eps", "epsp", "q", "f"), snames=("x", "z", "v"),
    default_theta=(9.90e-2, 1.98e-5, 7.62e-5, 1.0),
    default_y0=(1.0, 2.0, 3.0), default_t_end=30.0,
    priors=lambda: {"eps": None, "epsp": None, "q": None,
                    "f": D.LogNormal(s=0.5, scale=1.0)},
    stiff=True,
    doc="Field-Noyes Oregonator model of the Belousov-Zhabotinsky "
        "oscillating reaction (scaled three-variable form); the scale "
        "parameters eps, eps' and q are fixed physical constants by "
        "default."))
