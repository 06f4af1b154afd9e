"""The port's prior families against odelib_tpu.distributions and scipy, in
float64: logpdf, cdf and ppf (rtol 1e-10 for the closed forms, 1e-8 for
the Newton ppfs of Gamma and Beta), draws by a KS test, the scipy bridge
and the torch ``betainc`` against scipy's."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import scipy.stats
import torch

import odelib_tpu.distributions as JD
import odelib_tpu_torch.distributions as D

# name: (port distribution, JAX distribution, frozen scipy distribution or
# None, whether ppf is a Newton iteration)
CASES = {
    "truncnorm": (D.TruncNormal(a=-1.5, b=2.0, loc=0.3, scale=1.7),
                  JD.TruncNormal(a=-1.5, b=2.0, loc=0.3, scale=1.7),
                  scipy.stats.truncnorm(-1.5, 2.0, loc=0.3, scale=1.7), False),
    "positive_normal": (D.Positive_Normal(2.0, 1.5),
                        JD.Positive_Normal(2.0, 1.5),
                        scipy.stats.truncnorm(-2.0 / 1.5, 100.0, loc=2.0,
                                              scale=1.5), False),
    "gamma": (D.Gamma(a=2.5, loc=0.1, scale=3.0),
              JD.Gamma(a=2.5, loc=0.1, scale=3.0),
              scipy.stats.gamma(2.5, loc=0.1, scale=3.0), True),
    "gamma_small_a": (D.Gamma(a=0.7, scale=2.0), JD.Gamma(a=0.7, scale=2.0),
                      scipy.stats.gamma(0.7, scale=2.0), True),
    "expon": (D.Exponential(loc=0.5, scale=2.0),
              JD.Exponential(loc=0.5, scale=2.0),
              scipy.stats.expon(loc=0.5, scale=2.0), False),
    "cauchy": (D.Cauchy(loc=-1.0, scale=0.5), JD.Cauchy(loc=-1.0, scale=0.5),
               scipy.stats.cauchy(loc=-1.0, scale=0.5), False),
    "halfnorm": (D.HalfNormal(loc=0.2, scale=1.3),
                 JD.HalfNormal(loc=0.2, scale=1.3),
                 scipy.stats.halfnorm(loc=0.2, scale=1.3), False),
    "weibull_min": (D.Weibull(c=1.8, loc=0.0, scale=2.5),
                    JD.Weibull(c=1.8, loc=0.0, scale=2.5),
                    scipy.stats.weibull_min(1.8, scale=2.5), False),
    "beta": (D.Beta(a=2.0, b=5.0, loc=0.1, scale=2.0),
             JD.Beta(a=2.0, b=5.0, loc=0.1, scale=2.0),
             scipy.stats.beta(2.0, 5.0, loc=0.1, scale=2.0), True),
    "beta_u_shaped": (D.Beta(a=0.5, b=0.5), JD.Beta(a=0.5, b=0.5),
                      scipy.stats.beta(0.5, 0.5), True),
}
Q = np.linspace(0.02, 0.98, 49)


def _np(t):
    return np.asarray(t, np.float64)


@pytest.mark.parametrize("name", sorted(CASES))
def test_family_matches_odelib_tpu_and_scipy(name):
    d, jd, sd, newton = CASES[name]
    x = sd.ppf(Q)
    # points of the support and, where it has an edge, outside it
    xs = np.concatenate([x, [sd.support()[0] - 0.5, sd.support()[1] + 0.5]])
    xs = xs[np.isfinite(xs)]
    lp = d.logpdf(xs).numpy()
    np.testing.assert_allclose(lp, _np(jd.logpdf(jnp.asarray(xs))),
                               rtol=1e-10)
    fin = np.isfinite(lp)
    np.testing.assert_array_equal(fin, np.isfinite(sd.logpdf(xs)))
    np.testing.assert_allclose(lp[fin], sd.logpdf(xs)[fin], rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(d.cdf(x).numpy(), _np(jd.cdf(jnp.asarray(x))),
                               rtol=1e-10)
    np.testing.assert_allclose(d.cdf(x).numpy(), Q, rtol=1e-10)
    tol = 1e-8 if newton else 1e-10
    np.testing.assert_allclose(d.ppf(Q).numpy(), _np(jd.ppf(jnp.asarray(Q))),
                               rtol=tol)
    np.testing.assert_allclose(d.ppf(Q).numpy(), x, rtol=tol)
    np.testing.assert_allclose(d.sf(x).numpy(), 1.0 - Q, rtol=1e-9)
    np.testing.assert_allclose(d.pdf(x).numpy(), sd.pdf(x), rtol=1e-10)


@pytest.mark.parametrize("name", sorted(CASES))
def test_family_draws(name):
    d, _, sd, _ = CASES[name]
    g = torch.Generator().manual_seed(5)
    draws = d.rvs(g, (4000,)).numpy()
    assert scipy.stats.kstest(draws, sd.cdf).pvalue > 1e-3


def test_discrete_normal_matches_odelib_tpu():
    d, jd = D.DiscreteNormal(mu=3.2, sigma=1.7), JD.DiscreteNormal(3.2, 1.7)
    k = np.arange(-4.0, 11.0)
    np.testing.assert_allclose(d.logpmf(k).numpy(),
                               _np(jd.logpmf(jnp.asarray(k))), rtol=1e-10)
    np.testing.assert_allclose(d.pmf(k).numpy(),
                               _np(jd.pmf(jnp.asarray(k))), rtol=1e-10)
    x = k + 0.4
    np.testing.assert_allclose(d.cdf(x).numpy(), _np(jd.cdf(jnp.asarray(x))),
                               rtol=1e-10)
    np.testing.assert_array_equal(d.ppf(Q).numpy(),
                                  _np(jd.ppf(jnp.asarray(Q))))
    g = torch.Generator().manual_seed(2)
    draws = d.rvs(g, (4000,)).numpy()
    assert (draws == np.round(draws)).all()
    # the continuity-corrected normal's law
    assert scipy.stats.kstest(draws + np.random.default_rng(0).uniform(
        -0.5, 0.5, 4000), scipy.stats.norm(3.2, 1.7).cdf).pvalue > 1e-3


def test_betainc_matches_scipy():
    """The torch continued fraction over a grid of (a, b, x), both sides of
    the (a + 1) / (a + b + 2) switch and the edges 0 and 1."""
    a = np.array([0.05, 0.5, 1.0, 2.0, 5.0, 30.0, 200.0])
    b = np.array([0.1, 0.5, 3.0, 2.0, 1.0, 7.0, 150.0])
    x = np.concatenate([[0.0, 1e-8], np.linspace(0.01, 0.99, 25),
                        [1.0 - 1e-8, 1.0]])
    A, B, X = np.meshgrid(a, b, x, indexing="ij")
    got = D.betainc(torch.as_tensor(A), torch.as_tensor(B),
                    torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(got, scipy.special.betainc(A, B, X),
                               rtol=1e-10, atol=1e-14)
    assert math.isnan(float(D.betainc(2.0, 3.0, 1.5)))
    assert math.isnan(float(D.betainc(-1.0, 3.0, 0.5)))


def test_from_scipy_every_name():
    gens = {"norm": (scipy.stats.norm, {"loc": 1.0, "scale": 2.0}),
            "lognorm": (scipy.stats.lognorm, {"s": 0.5, "scale": 3.0}),
            "truncnorm": (scipy.stats.truncnorm, {"a": -1.0, "b": 2.0}),
            "uniform": (scipy.stats.uniform, {"loc": 1.0, "scale": 4.0}),
            "gamma": (scipy.stats.gamma, {"a": 2.0, "scale": 3.0}),
            "expon": (scipy.stats.expon, {"scale": 2.0}),
            "cauchy": (scipy.stats.cauchy, {"loc": 1.0}),
            "halfnorm": (scipy.stats.halfnorm, {"scale": 2.0}),
            "weibull_min": (scipy.stats.weibull_min, {"c": 1.5}),
            "beta": (scipy.stats.beta, {"a": 2.0, "b": 3.0})}
    assert set(gens) | {"Gamma Distribution"} == set(D._SCIPY_NAME_MAP)
    for name, (gen, hp) in gens.items():
        d = D.from_scipy(gen, hp)
        assert type(d) is D._SCIPY_NAME_MAP[name] and hash(d)
        assert type(d).__name__ == type(JD.from_scipy(gen, hp)).__name__
        # the frozen form and the name string give the same distribution
        assert D.from_scipy(gen(**hp)) == d == D.from_scipy(name, hp)
        x = gen(**hp).ppf(np.array([0.2, 0.5, 0.8]))
        np.testing.assert_allclose(d.logpdf(x).numpy(), gen(**hp).logpdf(x),
                                   rtol=1e-10)
    assert D.from_scipy("Gamma Distribution", {"a": 2.0}) == D.Gamma(a=2.0)
    with pytest.raises(ValueError, match="no odelib_tpu_torch equivalent"):
        D.from_scipy(scipy.stats.laplace, {})
    with pytest.raises(ValueError, match="Unknown hyperparameters"):
        D.from_scipy(scipy.stats.gamma, {"k": 2.0})
