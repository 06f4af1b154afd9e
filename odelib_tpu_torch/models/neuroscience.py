"""Excitable-dynamics models: FitzHugh-Nagumo and Hindmarsh-Rose.
Counterpart of ``odelib_tpu/models/neuroscience.py``. Their states change
sign, so a log-space fit needs shifted data."""
from __future__ import annotations

import torch

from .. import distributions as D
from .base import ModelDef, register


def _fitzhugh_nagumo(t, y, ps):
    a, b, tau, I = ps
    v, w = y[0], y[1]
    dv = v - v * v * v / 3.0 - w + I
    dw = (v + a - b * w) / tau
    return torch.stack([dv, dw])


def _hindmarsh_rose(t, y, ps):
    a, b, c, d, r, s, I = ps
    x, yv, z = y[0], y[1], y[2]
    dx = yv - a * x * x * x + b * x * x - z + I
    dy = c - d * x * x - yv
    dz = r * (s * (x + 1.6) - z)
    return torch.stack([dx, dy, dz])


fitzhugh_nagumo = register(ModelDef(
    name="fitzhugh_nagumo", rhs=_fitzhugh_nagumo,
    pnames=("a", "b", "tau", "I"), snames=("v", "w"),
    default_theta=(0.7, 0.8, 12.5, 0.5),
    default_y0=(-1.0, 1.0), default_t_end=100.0,
    priors=lambda: {"a": D.LogNormal(s=0.5, scale=0.7),
                    "b": D.LogNormal(s=0.5, scale=0.8),
                    "tau": D.LogNormal(s=0.5, scale=12.5),
                    "I": D.LogNormal(s=0.5, scale=0.5)},
    doc="FitzHugh-Nagumo relaxation oscillator (FitzHugh 1961, Nagumo "
        "1962), the two-variable reduction of Hodgkin-Huxley "
        "excitability."))

hindmarsh_rose = register(ModelDef(
    name="hindmarsh_rose", rhs=_hindmarsh_rose,
    pnames=("a", "b", "c", "d", "r", "s", "I"), snames=("x", "y", "z"),
    default_theta=(1.0, 3.0, 1.0, 5.0, 0.001, 4.0, 2.0),
    default_y0=(-1.6, 4.0, 2.0), default_t_end=1000.0,
    priors=lambda: {"a": D.LogNormal(s=0.5, scale=1.0),
                    "b": D.LogNormal(s=0.5, scale=3.0),
                    "c": D.LogNormal(s=0.5, scale=1.0),
                    "d": D.LogNormal(s=0.5, scale=5.0),
                    "r": D.LogNormal(s=1.0, scale=0.001),
                    "s": D.LogNormal(s=0.5, scale=4.0),
                    "I": D.LogNormal(s=0.5, scale=2.0)},
    doc="Hindmarsh-Rose bursting neuron (Hindmarsh & Rose 1984): "
        "three-timescale spiking and bursting (r the slow adaptation "
        "rate)."))
