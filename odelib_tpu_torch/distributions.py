"""Prior distributions with scipy-compatible parametrizations.

Counterpart of ``odelib_tpu/distributions.py``: ``Normal``, ``LogNormal``,
``TruncNormal`` (and ``Positive_Normal``), ``Uniform``, ``Gamma``,
``Exponential``, ``Cauchy``, ``HalfNormal``, ``Weibull``, ``Beta`` and
``DiscreteNormal``, each with ``logpdf``/``pdf``/``cdf``/``sf``/``ppf``/
``rvs``, plus the :func:`from_scipy` bridge so
``parameter(scipy.stats.gamma, {...})`` works. Hyperparameters are plain
floats (frozen, hashable dataclasses); inputs may be numpy arrays or
tensors and are computed in float64 unless a tensor brings its own dtype.
Array-valued hyperparameters (an array parameter's per-entry priors) give
an :class:`ArrayHyper`, one scalar distribution per entry, for host use
(the LHS ``ppf``, ``logpdf``); it has no in-kernel form.
The formulas are the JAX package's, so Latin-hypercube draws pushed
through ``ppf`` agree: Gamma's ``ppf`` is Wilson-Hilferty plus Newton in
log space on ``torch.special.gammainc``, Beta's is Newton in logit space
on :func:`betainc`, the regularized incomplete beta written here (torch
has none) as the JAX package's continued fraction. The ``fit`` methods
are not ported yet (ROADMAP queue 1, item 9).
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


def _lentz(num, small, threshold, max_iter):
    """Modified Lentz evaluation of the continued fraction with partial
    denominators 1 (0 at the start) and partial numerators ``num(n)``,
    iterating while any element moves by ``threshold`` or more (at most
    ``max_iter`` terms): the JAX package's
    ``lentz_thompson_barnett_algorithm``."""
    h = torch.full_like(num(1), small)
    c, d = h, torch.zeros_like(h)
    n = 1
    while n < max_iter:
        a = num(n)
        c = 1.0 + a / c
        c = torch.where(torch.abs(c) < small, torch.full_like(c, small), c)
        d = 1.0 + a * d
        d = torch.where(torch.abs(d) < small, torch.full_like(d, small), d)
        d = 1.0 / d
        delta = c * d
        h = h * delta
        n += 1
        if not bool((torch.abs(delta - 1.0) >= threshold).any()):
            break
    return h


def betainc(a, b, x):
    """Regularized incomplete beta I_x(a, b), elementwise (float64 unless
    the inputs are float32): the continued fraction of DLMF 8.17.22 by
    modified Lentz, on the side of (a + 1) / (a + b + 2) where it converges
    fast (8.17.4 otherwise), with the JAX package's iteration count (600
    in float64, 200 in float32) and stopping rule (every element's last
    factor within eps/2 of 1)."""
    x = _t(x)
    dtype = x.dtype if x.dtype == torch.float32 else torch.float64
    a, b, x = torch.broadcast_tensors(*(
        torch.as_tensor(v, dtype=dtype) for v in (a, b, x)))
    eps = torch.finfo(dtype).eps
    a_zero = (a == 0) | (b == math.inf)
    b_zero = (b == 0) | (a == math.inf)
    zero = (b_zero & (x != 1)) | (a_zero & (x == 0))
    one = (a_zero & (x != 0)) | (b_zero & (x == 1))
    nan = ((a < 0) | (b < 0) | (x < 0) | (x > 1) | (a_zero & b_zero)
           | torch.isnan(a) | torch.isnan(b) | torch.isnan(x))
    fast = x < (a + 1.0) / (a + b + 2.0)
    a, b = torch.where(fast, a, b), torch.where(fast, b, a)
    x = torch.where(fast, x, 1.0 - x)

    def num(n):
        if n == 1:
            return torch.ones_like(x)
        m = float((n - 1) // 2)
        if n % 2 == 0:
            if m == 0:
                return -(a + b) * x / (a + 1.0)
            return -(a + m) * (a + b + m) * x / ((a + 2 * m)
                                                 * (a + 2 * m + 1.0))
        return m * (b - m) * x / ((a + 2 * m - 1.0) * (a + 2 * m))

    cf = _lentz(num, eps / 2, eps / 2, 200 if dtype == torch.float32
                else 600)
    tiny = torch.finfo(dtype).tiny * 2
    lb_small = torch.lgamma(b) - torch.lgamma(a + b)
    lb = torch.lgamma(a) + lb_small
    factor = torch.where(
        a < tiny, torch.exp(torch.log1p(-x) * b - lb_small),
        torch.exp(torch.log(x) * a + torch.log1p(-x) * b - lb) / a)
    out = cf * factor
    out = torch.where(fast, out, 1.0 - out)
    out = torch.where(zero, torch.zeros_like(out), out)
    out = torch.where(one, torch.ones_like(out), out)
    return torch.where(nan, torch.full_like(out, math.nan), out)


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

    def sf(self, x):
        return 1.0 - self.cdf(x)

    def rvs(self, generator=None, shape=(), dtype=torch.float64,
            device=None):
        """Inverse-CDF draws from uniforms of an explicit generator."""
        u = torch.rand(shape, generator=generator, dtype=dtype,
                       device=device)
        return self.ppf(u)

    # logpmf aliases for discrete distributions
    def logpmf(self, x):
        return self.logpdf(x)

    def pmf(self, x):
        return self.pdf(x)

    @property
    def name(self):
        return type(self).__name__.lower()


_LOG_SQRT_2PI = 0.5 * math.log(2 * math.pi)


def _ndtr(z: float) -> float:
    return float(torch.special.ndtr(torch.tensor(z, dtype=torch.float64)))


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
class TruncNormal(Distribution):
    """scipy.stats.truncnorm(a, b, loc, scale); a, b in standard units."""
    a: float = 0.0
    b: float = math.inf
    loc: float = 0.0
    scale: float = 1.0

    def _phi_ab(self):
        return _ndtr(self.a), _ndtr(self.b)

    def logpdf(self, x):
        z = (_t(x) - self.loc) / self.scale
        pa, pb = self._phi_ab()
        norm = math.log(pb - pa) + math.log(self.scale)
        out = -0.5 * z * z - _LOG_SQRT_2PI - norm
        return torch.where((z >= self.a) & (z <= self.b), out, -math.inf)

    def cdf(self, x):
        z = (_t(x) - self.loc) / self.scale
        pa, pb = self._phi_ab()
        return torch.clamp((torch.special.ndtr(z) - pa) / (pb - pa), 0.0, 1.0)

    def ppf(self, q):
        pa, pb = self._phi_ab()
        return self.loc + self.scale * torch.special.ndtri(
            pa + _t(q) * (pb - pa))


def Positive_Normal(loc, scale):
    """Zero-truncated normal (upper bound loc + 100 scale, effectively
    unbounded), as the JAX package builds it."""
    mu, sigma = float(loc), float(scale)
    return TruncNormal(a=(0.0 - mu) / sigma,
                       b=((mu + sigma * 100.0) - mu) / sigma,
                       loc=mu, scale=sigma)


@dataclasses.dataclass(frozen=True)
class Uniform(Distribution):
    """scipy.stats.uniform(loc, scale): support [loc, loc+scale]."""
    loc: float = 0.0
    scale: float = 1.0

    def logpdf(self, x):
        x = _t(x)
        inside = (x >= self.loc) & (x <= self.loc + self.scale)
        return torch.where(inside, torch.full_like(x, -math.log(self.scale)),
                           -math.inf)

    def cdf(self, x):
        return torch.clamp((_t(x) - self.loc) / self.scale, 0.0, 1.0)

    def ppf(self, q):
        return self.loc + self.scale * _t(q)


@dataclasses.dataclass(frozen=True)
class Gamma(Distribution):
    """scipy.stats.gamma(a, loc, scale). ppf via Wilson-Hilferty + Newton."""
    a: float = 1.0
    loc: float = 0.0
    scale: float = 1.0

    def logpdf(self, x):
        y = (_t(x) - self.loc) / self.scale
        out = ((self.a - 1.0) * torch.log(torch.where(y > 0, y, 1.0)) - y
               - math.lgamma(self.a) - math.log(self.scale))
        return torch.where(y > 0, out, -math.inf)

    def cdf(self, x):
        y = (_t(x) - self.loc) / self.scale
        pos = y > 0
        a = torch.full_like(y, self.a)
        return torch.where(pos, torch.special.gammainc(
            a, torch.where(pos, y, 1.0)), 0.0)

    def ppf(self, q):
        a = self.a
        q = _t(q)
        eps = torch.finfo(q.dtype).eps
        q = torch.clamp(q, eps, 1.0 - eps)
        # Wilson-Hilferty initial guess
        z = torch.special.ndtri(q)
        c = 1.0 / (9.0 * a)
        x0 = torch.clamp(a * (1.0 - c + z * math.sqrt(c)) ** 3, min=1e-8 * a)
        a_t = torch.full_like(q, a)
        lg = math.lgamma(a)
        # Newton in log space for positivity: u = log x
        u = torch.log(x0)
        for _ in range(40):
            x = torch.exp(u)
            f = torch.special.gammainc(a_t, x) - q
            logp = (a - 1.0) * u - x - lg        # pdf at x (scale 1)
            du = torch.clamp(f / torch.exp(logp + u), -1.5, 1.5)
            u = u - du
        return self.loc + self.scale * torch.exp(u)


@dataclasses.dataclass(frozen=True)
class Exponential(Distribution):
    """scipy.stats.expon(loc, scale): rate = 1/scale."""
    loc: float = 0.0
    scale: float = 1.0

    def logpdf(self, x):
        y = (_t(x) - self.loc) / self.scale
        return torch.where(y >= 0, -y - math.log(self.scale), -math.inf)

    def cdf(self, x):
        y = (_t(x) - self.loc) / self.scale
        return torch.where(y >= 0, -torch.expm1(-torch.clamp(y, min=0.0)),
                           0.0)

    def ppf(self, q):
        return self.loc - self.scale * torch.log1p(-_t(q))


@dataclasses.dataclass(frozen=True)
class Cauchy(Distribution):
    """scipy.stats.cauchy(loc, scale)."""
    loc: float = 0.0
    scale: float = 1.0

    def logpdf(self, x):
        z = (_t(x) - self.loc) / self.scale
        return -torch.log1p(z * z) - math.log(math.pi * self.scale)

    def cdf(self, x):
        z = (_t(x) - self.loc) / self.scale
        return 0.5 + torch.atan(z) / math.pi

    def ppf(self, q):
        return self.loc + self.scale * torch.tan(math.pi * (_t(q) - 0.5))


@dataclasses.dataclass(frozen=True)
class HalfNormal(Distribution):
    """scipy.stats.halfnorm(loc, scale): |Z| scaled."""
    loc: float = 0.0
    scale: float = 1.0

    def logpdf(self, x):
        z = (_t(x) - self.loc) / self.scale
        out = (0.5 * math.log(2.0 / math.pi) - math.log(self.scale)
               - 0.5 * z * z)
        return torch.where(z >= 0, out, -math.inf)

    def cdf(self, x):
        z = (_t(x) - self.loc) / self.scale
        return torch.where(
            z >= 0, 2.0 * torch.special.ndtr(torch.clamp(z, min=0.0)) - 1.0,
            0.0)

    def ppf(self, q):
        return self.loc + self.scale * torch.special.ndtri(0.5 * (1.0
                                                                  + _t(q)))


@dataclasses.dataclass(frozen=True)
class Weibull(Distribution):
    """scipy.stats.weibull_min(c, loc, scale)."""
    c: float = 1.0
    loc: float = 0.0
    scale: float = 1.0

    def logpdf(self, x):
        y = (_t(x) - self.loc) / self.scale
        ly = torch.log(torch.where(y > 0, y, 1.0))
        out = (math.log(self.c) - math.log(self.scale)
               + (self.c - 1.0) * ly - torch.exp(self.c * ly))
        return torch.where(y > 0, out, -math.inf)

    def cdf(self, x):
        y = (_t(x) - self.loc) / self.scale
        return torch.where(
            y > 0, -torch.expm1(-torch.clamp(y, min=0.0) ** self.c), 0.0)

    def ppf(self, q):
        return self.loc + self.scale * (-torch.log1p(-_t(q))) ** (1.0
                                                                  / self.c)


@dataclasses.dataclass(frozen=True)
class Beta(Distribution):
    """scipy.stats.beta(a, b, loc, scale): support [loc, loc+scale]."""
    a: float = 1.0
    b: float = 1.0
    loc: float = 0.0
    scale: float = 1.0

    def _betaln(self):
        return (math.lgamma(self.a) + math.lgamma(self.b)
                - math.lgamma(self.a + self.b))

    def logpdf(self, x):
        y = (_t(x) - self.loc) / self.scale
        inside = (y > 0) & (y < 1)
        ys = torch.where(inside, y, 0.5)
        out = ((self.a - 1.0) * torch.log(ys)
               + (self.b - 1.0) * torch.log1p(-ys)
               - self._betaln() - math.log(self.scale))
        return torch.where(inside, out, -math.inf)

    def cdf(self, x):
        y = torch.clamp((_t(x) - self.loc) / self.scale, 0.0, 1.0)
        return betainc(self.a, self.b, y)

    def ppf(self, q):
        """Newton on the regularized incomplete beta, in logit space for
        (0, 1) positivity, seeded at the mean."""
        a, b = self.a, self.b
        q = _t(q)
        eps = torch.finfo(q.dtype).eps
        q = torch.clamp(q, eps, 1.0 - eps)
        betaln = self._betaln()
        x0 = min(max(a / (a + b), 1e-6), 1.0 - 1e-6)
        u = torch.zeros_like(q) + (math.log(x0) - math.log1p(-x0))
        for _ in range(50):
            x = torch.sigmoid(u)
            f = betainc(a, b, x) - q
            logp = (a - 1.0) * torch.log(x) + (b - 1.0) * torch.log1p(-x) \
                - betaln
            # dx/du = x(1-x): du = f / (pdf * x * (1-x))
            du = f / torch.exp(logp + torch.log(x) + torch.log1p(-x))
            u = u - torch.clamp(du, -2.0, 2.0)
        return self.loc + self.scale * torch.sigmoid(u)


@dataclasses.dataclass(frozen=True)
class DiscreteNormal(Distribution):
    """Integer-valued normal: pmf(k) proportional to
    exp(-((k - mu) / sigma)^2 / 2) at the integers; cdf and ppf by the
    continuity-corrected normal, P(K <= k) = Phi((k + 1/2 - mu) / sigma)."""
    mu: float = 0.0
    sigma: float = 1.0

    def logpdf(self, k):
        z = (_t(k) - self.mu) / self.sigma
        return -0.5 * z * z - math.log(self.sigma) - _LOG_SQRT_2PI

    def cdf(self, x):
        return torch.special.ndtr((torch.floor(_t(x)) + 0.5 - self.mu)
                                  / self.sigma)

    def ppf(self, q):
        # smallest integer k with cdf(k) >= q
        return torch.ceil(self.mu + self.sigma * torch.special.ndtri(_t(q))
                          - 0.5)

    def rvs(self, generator=None, shape=(), dtype=torch.float64,
            device=None):
        return torch.round(self.mu + self.sigma * torch.randn(
            shape, generator=generator, dtype=dtype, device=device))


# the JAX package keeps the name of the ready-made gamma instance
gamma = Gamma


@dataclasses.dataclass(frozen=True)
class ArrayHyper(Distribution):
    """A family with array-valued hyperparameters: ``elems`` holds one
    scalar-hyperparameter distribution per entry of ``shape`` (row-major),
    the hyperparameters broadcast to it. Each method works elementwise on
    values whose trailing axes are ``shape`` (the JAX package broadcasts
    its array hyperparameters the same way). :meth:`element` is entry
    k's distribution, which the LHS draws that entry from."""
    family: str
    shape: tuple
    elems: tuple

    def element(self, k: int) -> Distribution:
        return self.elems[k]

    def _each(self, fn, x):
        x = _t(x)
        nd = len(self.shape)
        x = torch.broadcast_to(x, tuple(x.shape[:x.ndim - nd]) + self.shape)
        flat = x.reshape(tuple(x.shape[:x.ndim - nd]) + (len(self.elems),))
        out = torch.stack([fn(d, flat[..., k])
                           for k, d in enumerate(self.elems)], dim=-1)
        return out.reshape(x.shape)

    def logpdf(self, x):
        return self._each(lambda d, v: d.logpdf(v), x)

    def cdf(self, x):
        return self._each(lambda d, v: d.cdf(v), x)

    def ppf(self, q):
        return self._each(lambda d, v: d.ppf(v), q)

    @property
    def name(self):
        return self.family

_SCIPY_NAME_MAP = {
    "norm": Normal,
    "lognorm": LogNormal,
    "truncnorm": TruncNormal,
    "uniform": Uniform,
    "gamma": Gamma,
    "Gamma Distribution": Gamma,  # the name of a custom gamma_gen instance
    "expon": Exponential,
    "cauchy": Cauchy,
    "halfnorm": HalfNormal,
    "weibull_min": Weibull,
    "beta": Beta,
}


def from_scipy(stats_gen, hyperparameters=None):
    """Build a Distribution from a scipy.stats generator + hp dict, a
    frozen scipy distribution, a name string, or a Distribution (returned
    unchanged). An unknown family raises ``ValueError``."""
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
        raise ValueError(
            f"no odelib_tpu_torch equivalent for scipy distribution "
            f"{name!r}. Supported: {sorted(_SCIPY_NAME_MAP)}; or pass an "
            "odelib_tpu_torch.distributions.Distribution instance.")
    field_names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(hp) - field_names
    if unknown:
        raise ValueError(f"Unknown hyperparameters {unknown} for {name}")
    if any(np.ndim(v) for v in hp.values()):
        keys = list(hp)
        vals = np.broadcast_arrays(*(np.asarray(hp[k], np.float64)
                                     for k in keys))
        return ArrayHyper(cls.__name__.lower(), tuple(vals[0].shape), tuple(
            cls(**{k: float(v.flat[i]) for k, v in zip(keys, vals)})
            for i in range(vals[0].size)))
    return cls(**{k: float(v) for k, v in hp.items()})


def _frozen_kwds(frozen):
    shapes = frozen.dist.shapes.split(",") if frozen.dist.shapes else []
    names = [s.strip() for s in shapes] + ["loc", "scale"]
    args = list(frozen.args) + [frozen.kwds.get(k)
                                for k in names[len(frozen.args):]]
    return {k: v for k, v in zip(names, args) if v is not None}
