"""Prior distributions with scipy-compatible parametrizations.

Counterpart of ``odelib_tpu/distributions.py`` for the main path:
``Normal``, ``LogNormal`` (the demo priors) and ``Uniform``, each with
``logpdf``/``pdf``/``cdf``/``ppf``/``rvs``, plus the :func:`from_scipy`
bridge so ``parameter(scipy.stats.lognorm, {...})`` works. Hyperparameters
are plain floats (frozen, hashable dataclasses); inputs may be numpy arrays
or tensors and are computed in float64 unless a tensor brings its own dtype.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def _t(x):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, np.float64))


class Distribution:
    """Base class: subclasses define logpdf, cdf and ppf."""

    def logpdf(self, x):
        raise NotImplementedError

    def pdf(self, x):
        return torch.exp(self.logpdf(x))

    def cdf(self, x):
        raise NotImplementedError

    def ppf(self, q):
        raise NotImplementedError

    def rvs(self, generator=None, shape=(), dtype=torch.float64,
            device=None):
        """Inverse-CDF draws from uniforms of an explicit generator."""
        u = torch.rand(shape, generator=generator, dtype=dtype,
                       device=device)
        return self.ppf(u)

    @property
    def name(self):
        return type(self).__name__.lower()


_LOG_SQRT_2PI = 0.5 * math.log(2 * math.pi)


@dataclasses.dataclass(frozen=True)
class Normal(Distribution):
    """scipy.stats.norm(loc, scale)."""
    loc: float = 0.0
    scale: float = 1.0

    def logpdf(self, x):
        z = (_t(x) - self.loc) / self.scale
        return -0.5 * z * z - math.log(self.scale) - _LOG_SQRT_2PI

    def cdf(self, x):
        return torch.special.ndtr((_t(x) - self.loc) / self.scale)

    def ppf(self, q):
        return self.loc + self.scale * torch.special.ndtri(_t(q))


@dataclasses.dataclass(frozen=True)
class LogNormal(Distribution):
    """scipy.stats.lognorm(s, loc, scale): X = loc + scale * exp(s*Z)."""
    s: float = 1.0
    loc: float = 0.0
    scale: float = 1.0

    def logpdf(self, x):
        y = (_t(x) - self.loc) / self.scale
        logy = torch.log(y)
        out = (-0.5 * (logy / self.s) ** 2 - logy - math.log(self.s)
               - math.log(self.scale) - _LOG_SQRT_2PI)
        return torch.where(y > 0, out, -math.inf)

    def cdf(self, x):
        y = (_t(x) - self.loc) / self.scale
        safe = torch.where(y > 0, y, 1.0)
        return torch.where(y > 0,
                           torch.special.ndtr(torch.log(safe) / self.s), 0.0)

    def ppf(self, q):
        return self.loc + self.scale * torch.exp(
            self.s * torch.special.ndtri(_t(q)))


@dataclasses.dataclass(frozen=True)
class Uniform(Distribution):
    """scipy.stats.uniform(loc, scale): support [loc, loc+scale]."""
    loc: float = 0.0
    scale: float = 1.0

    def logpdf(self, x):
        x = _t(x)
        inside = (x >= self.loc) & (x <= self.loc + self.scale)
        return torch.where(inside, -math.log(self.scale), -math.inf)

    def cdf(self, x):
        return torch.clamp((_t(x) - self.loc) / self.scale, 0.0, 1.0)

    def ppf(self, q):
        return self.loc + self.scale * _t(q)


_SCIPY_NAME_MAP = {"norm": Normal, "lognorm": LogNormal, "uniform": Uniform}


def from_scipy(stats_gen, hyperparameters=None):
    """Build a Distribution from a scipy.stats generator + hp dict, a
    frozen scipy distribution, a name string, or a Distribution (returned
    unchanged)."""
    if isinstance(stats_gen, Distribution):
        return stats_gen
    hp = dict(hyperparameters or {})
    name = stats_gen if isinstance(stats_gen, str) \
        else getattr(stats_gen, "name", None)
    if name is None and hasattr(stats_gen, "dist"):  # frozen scipy dist
        name = stats_gen.dist.name
        hp = {**_frozen_kwds(stats_gen), **hp}
    cls = _SCIPY_NAME_MAP.get(name)
    if cls is None:
        raise NotImplementedError(
            f"prior family {name!r} is not ported yet (supported: "
            f"{sorted(_SCIPY_NAME_MAP)}; ROADMAP queue 1, item 6)")
    field_names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(hp) - field_names
    if unknown:
        raise ValueError(f"Unknown hyperparameters {unknown} for {name}")
    for k, v in hp.items():
        if np.ndim(v) != 0:
            raise NotImplementedError(
                f"array-valued hyperparameter {k!r} is not ported yet "
                "(ROADMAP queue 1, item 13)")
    return cls(**{k: float(v) for k, v in hp.items()})


def _frozen_kwds(frozen):
    shapes = frozen.dist.shapes.split(",") if frozen.dist.shapes else []
    names = [s.strip() for s in shapes] + ["loc", "scale"]
    args = list(frozen.args) + [frozen.kwds.get(k)
                                for k in names[len(frozen.args):]]
    return {k: v for k, v in zip(names, args) if v is not None}
