"""The in-kernel prior table and its torch twin ``logprior_plain`` against
odelib_tpu's ``_kernel_logpdf`` for each of the ten in-kernel families, on
float32 grids that include the support's edges and points outside it:
-inf exactly where the reference gives -inf, otherwise rtol 1e-6 (XLA:CPU
folds the constants, so the last bit may differ)."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odelib_tpu.distributions as JD
import odelib_tpu_torch.distributions as D
from odelib_tpu.ops.pallas_mh import _kernel_logpdf
from odelib_tpu.ops.pallas_mh import \
    kernel_priors_supported as jax_supported
from odelib_tpu_torch.ops.priors import (WIDTH, checked_priors,
                                         kernel_priors_supported,
                                         logprior_plain, prior_table)

# name: (port prior, JAX prior, support edges, grid around them)
FAMILIES = {
    "lognormal": (D.LogNormal(s=0.8, loc=0.1, scale=2.0),
                  JD.LogNormal(s=0.8, loc=0.1, scale=2.0), (0.1,)),
    "normal": (D.Normal(loc=-0.3, scale=1.7), JD.Normal(loc=-0.3, scale=1.7),
               ()),
    "uniform": (D.Uniform(loc=0.2, scale=3.0), JD.Uniform(loc=0.2, scale=3.0),
                (0.2, 3.2)),
    "gamma": (D.Gamma(a=2.5, loc=0.1, scale=1.5),
              JD.Gamma(a=2.5, loc=0.1, scale=1.5), (0.1,)),
    "truncnorm": (D.TruncNormal(a=-1.0, b=1.5, loc=1.0, scale=0.5),
                  JD.TruncNormal(a=-1.0, b=1.5, loc=1.0, scale=0.5),
                  (0.5, 1.75)),
    "truncnorm_open": (D.TruncNormal(a=0.0, loc=0.5, scale=2.0),
                       JD.TruncNormal(a=0.0, loc=0.5, scale=2.0), (0.5,)),
    "exponential": (D.Exponential(loc=0.3, scale=2.0),
                    JD.Exponential(loc=0.3, scale=2.0), (0.3,)),
    "cauchy": (D.Cauchy(loc=1.0, scale=0.4), JD.Cauchy(loc=1.0, scale=0.4),
               ()),
    "halfnormal": (D.HalfNormal(loc=0.2, scale=1.3),
                   JD.HalfNormal(loc=0.2, scale=1.3), (0.2,)),
    "weibull": (D.Weibull(c=1.7, loc=0.0, scale=2.0),
                JD.Weibull(c=1.7, loc=0.0, scale=2.0), (0.0,)),
    "beta": (D.Beta(a=2.0, b=3.5, loc=0.1, scale=2.0),
             JD.Beta(a=2.0, b=3.5, loc=0.1, scale=2.0), (0.1, 2.1)),
}


def jax_priors(priors):
    """The JAX package's counterparts of port priors (None stays None),
    with the same hyperparameters."""
    return tuple(None if d is None else getattr(JD, type(d).__name__)(
        **dataclasses.asdict(d)) for d in priors)


def _grid(edges):
    x = np.linspace(-3.0, 6.0, 301)
    near = [e + d for e in edges for d in (-1e-3, 0.0, 1e-3)]
    nxt = [np.nextafter(np.float32(e), np.float32(s)) for e in edges
           for s in (-np.inf, np.inf)]
    return np.concatenate([x, near, nxt]).astype(np.float32)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_logprior_plain_matches_kernel_logpdf(name):
    d, jd, edges = FAMILIES[name]
    x = _grid(edges)
    # float32 in the kernel, where the closure meets float32 tiles
    ref = np.asarray(_kernel_logpdf(jd)(jnp.asarray(x)), np.float32)
    table = prior_table([d])
    assert table.shape == (1, WIDTH) and table.dtype == np.float32
    got = logprior_plain(table, [torch.as_tensor(x)]).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got == -np.inf, ref == -np.inf)
    assert np.isfinite(ref[ref != -np.inf]).all()
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6, atol=1e-6)
    # and the family's own float64 logpdf, inside the support away from
    # its edges (where float32's rounding of x moves the density most)
    away = fin & np.all([np.abs(x - e) > 0.05 for e in edges] + [fin],
                        axis=0)
    dens = d.logpdf(x.astype(np.float64)).numpy()
    np.testing.assert_allclose(got[away], dens[away], rtol=1e-5, atol=1e-5)


def test_slot_sum_matches_the_jax_kernel_sum():
    """Three slots, one without a prior: the slots with one add to a zero
    start in slot order, as the JAX kernels' logprior does."""
    x = [torch.as_tensor(v) for v in _grid((0.1, 0.5)).reshape(1, -1)
         * np.float32([[1.0], [0.7], [1.3]])]
    names = ("gamma", None, "beta")
    table = prior_table([FAMILIES[n][0] if n else None for n in names])
    got = logprior_plain(table, x).numpy()
    ref = jnp.zeros(x[0].shape, jnp.float32)
    for n, v in zip(names, x):
        if n:
            ref = ref + _kernel_logpdf(FAMILIES[n][1])(jnp.asarray(v.numpy()))
    ref = np.asarray(ref)
    np.testing.assert_array_equal(got == -np.inf, ref == -np.inf)
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6, atol=1e-6)


def test_supported_families_and_validation():
    ten = [FAMILIES[n][0] for n in sorted(FAMILIES)]
    assert kernel_priors_supported(ten + [None])
    assert jax_supported([FAMILIES[n][1] for n in sorted(FAMILIES)])
    dn = D.DiscreteNormal(0.0, 1.0)
    assert not kernel_priors_supported([dn])
    assert not jax_supported([JD.DiscreteNormal(0.0, 1.0)])
    # an array-valued hyperparameter has no in-kernel form, as in the JAX
    # package
    vec = D.Normal(loc=np.array([0.0, 1.0]), scale=1.0)
    assert not kernel_priors_supported([vec])
    assert not jax_supported([JD.Normal(loc=jnp.array([0.0, 1.0]))])
    with pytest.raises(ValueError, match="unsupported prior family"):
        prior_table([dn])
    with pytest.raises(ValueError, match="unsupported prior family"):
        checked_priors([None, dn], 2)
    with pytest.raises(ValueError, match="one entry per theta slot"):
        checked_priors([None], 2)
    assert checked_priors(None, 3) is None
    assert checked_priors([None] * 3, 3) is None
    t = checked_priors([None, FAMILIES["cauchy"][0]], 2)
    assert t.shape == (2, WIDTH) and t[0, 0] == 0 and t[1, 0] > 0
    # the constants are rounded to float32 from the host's float64
    g = FAMILIES["gamma"][0]
    assert t.dtype == np.float32
    assert prior_table([g])[0, 5] == np.float32(-math.lgamma(2.5)
                                                - math.log(1.5))
