"""Tempered SMC (odelib_tpu_torch/samplers/smc.py) against odelib_tpu's
``smc_sample`` on the CPU, both in float64 (x64) from the same particles
and key: the schedule ``betas`` within 1e-12, the per-stage acceptances
equal, ``log_evidence`` within 1e-8 and the particles (theta, chi, R^2,
AIC) within 1e-8 relative. tests/test_smc.py's conjugate problem with the
default adaptive Dopri5 and with fixed steps, and zero_i with a static
slot under rk4; the host bisection ``_next_beta`` against the reference's;
the refusals (no prior, ``ess_target`` outside (0, 1), fewer than 8
particles, a collapsed population) and the ``max_stages`` warning."""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from odelib_tpu.data import build_obsdata, format_dataframe
from odelib_tpu.data import obsdata_to_device
from odelib_tpu.model import make_spec
from odelib_tpu.samplers import smc_sample as jax_smc
from odelib_tpu.samplers.smc import _next_beta as jax_next_beta
from odelib_tpu_torch import random as R
from odelib_tpu_torch.data import build_obsdata_host
from odelib_tpu_torch.model import make_spec as t_make_spec
from odelib_tpu_torch.model import obsdata_from_arrays
from odelib_tpu_torch.rhs import adapt_rhs
from odelib_tpu_torch.samplers import smc as T

from test_torch_hmc import _jax_prior, _torch_prior
from test_torch_scan_mh import chains
from test_torch_survey import setup  # noqa: F401  (module fixture)

M0, S0P, SIG = np.log(2e6), 1.5, 0.3


def const_rhs(t, y, ps):
    return jnp.stack([0.0 * y[0]])


@pytest.fixture(scope="module")
def conjugate():
    """tests/test_smc.py's constant model y = S0 on 12 noisy points."""
    rng = np.random.default_rng(11)
    tobs = np.linspace(0.0, 3.0, 12)
    d = np.log(1e6) + rng.normal(0, SIG, len(tobs))
    rows = [{"organism": "S", "time": t, "abundance": np.exp(la),
             "log_sigma": SIG} for t, la in zip(tobs, d)]
    df = format_dataframe(pd.DataFrame(rows), ("S",))
    times = np.linspace(0.0, 3.0, 11)
    spec = make_spec(const_rhs, ("S0",), ("S",))
    tspec = t_make_spec(adapt_rhs(const_rhs), ("S0",), ("S",))
    obs, _ = build_obsdata(df, times, spec.post_snames)
    tobs_, _ = build_obsdata_host(df, times, tspec.post_snames)
    return spec, tspec, obs, obsdata_from_arrays(tobs_), times


def _jprior(theta):
    z = jnp.log(theta[0])
    return -0.5 * ((z - M0) / S0P) ** 2 - 0.5 * jnp.log(2 * jnp.pi * S0P ** 2)


def _tprior(theta):
    z = torch.log(theta[:, 0])
    return -0.5 * ((z - M0) / S0P) ** 2 - 0.5 * np.log(2 * np.pi * S0P ** 2)


def assert_same_smc(got, ref):
    np.testing.assert_allclose(got.betas, ref.betas, rtol=1e-12, atol=0)
    assert got.acceptance == ref.acceptance
    np.testing.assert_allclose(got.log_evidence, ref.log_evidence,
                               rtol=1e-8)
    for f in ("theta", "chi", "rsquared", "aic"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-8,
                                   err_msg=f)


@pytest.mark.parametrize("ikw", [
    dict(n_moves=2),
    dict(n_moves=3, method="fixed_dopri5", substeps=1)],
    ids=["adaptive-dopri5", "fixed-dopri5"])
def test_smc_conjugate_matches_reference(conjugate, ikw):
    spec, tspec, obs, tobs, times = conjugate
    rng = np.random.default_rng(3)
    theta0 = np.exp(M0 + S0P * rng.normal(size=(64, 1)))
    ref = jax_smc(spec, obs, jnp.asarray(times), jnp.asarray([1.0]),
                  jnp.asarray(theta0), jax.random.PRNGKey(7),
                  prior_logpdf=_jprior, **ikw)
    got = T.smc_sample(tspec, tobs, times, [1.0], theta0, R.PRNGKey(7),
                       prior_logpdf=_tprior, device="cpu", **ikw)
    assert len(got.betas) > 3 and got.betas[-1] == 1.0
    assert_same_smc(got, ref)


def test_smc_zero_i_static_slot_rk4(setup):  # noqa: F811
    """zero_i's three parameters around the fit, phi pinned by the walk
    mask, a lognormal prior on mu and beta, rk4 at 3 substeps."""
    spec, tspec, obs, tf, y0 = setup
    th0 = chains(32, seed=8, sd=0.3)
    kw = dict(n_moves=2, walk_mask=[1.0, 0.0, 1.0], method="rk4",
              substeps=3)
    ref = jax_smc(spec, obsdata_to_device(obs), jnp.asarray(tf),
                  jnp.asarray(y0), jnp.asarray(th0), jax.random.PRNGKey(1),
                  prior_logpdf=_jax_prior,
                  **dict(kw, walk_mask=jnp.asarray(kw["walk_mask"])))
    got = T.smc_sample(tspec, obsdata_from_arrays(obs), tf, y0, th0,
                       R.PRNGKey(1), prior_logpdf=_torch_prior,
                       device="cpu", **kw)
    assert_same_smc(got, ref)
    # the pinned slot only moves by resampling: every value a start's
    assert np.isin(got.theta[:, 1].numpy(),
                   np.exp(np.log(th0[:, 1]))).all()


def test_next_beta_matches_reference():
    rng = np.random.default_rng(2)
    chi = rng.gamma(2.0, 400.0, 300)
    chi[[5, 9]] = np.nan
    for beta in (0.0, 1e-4, 0.3):
        for target in (0.3, 0.5, 0.9):
            assert T._next_beta(chi, beta, target) \
                == jax_next_beta(chi, beta, target)


def test_smc_refusals_and_warning(conjugate):
    """Each refusal raises the reference's message: no prior, ess_target
    outside (0, 1), fewer than 8 particles, a collapsed population (every
    particle's solve fails); max_stages=1 warns as the reference does."""
    spec, tspec, obs, tobs, times = conjugate
    th0 = np.ones((16, 1))
    jargs = (spec, obs, jnp.asarray(times), jnp.asarray([1.0]))
    targs = (tspec, tobs, times, [1.0])
    for th, kw in ((th0, dict(prior=False)), (th0, dict(ess_target=1.5)),
                   (np.ones((4, 1)), {}), (np.full((16, 1), np.nan), {})):
        kw = dict(kw)
        prior = kw.pop("prior", True)
        with pytest.raises(ValueError) as got:
            T.smc_sample(*targs, th, R.PRNGKey(0), device="cpu",
                         prior_logpdf=_tprior if prior else None, **kw)
        with pytest.raises(ValueError) as ref:
            jax_smc(*jargs, jnp.asarray(th), jax.random.PRNGKey(0),
                    prior_logpdf=_jprior if prior else None, **kw)
        assert str(got.value) == str(ref.value)
    assert "population collapsed" in str(got.value)
    rng = np.random.default_rng(3)
    theta0 = np.exp(M0 + S0P * rng.normal(size=(32, 1)))
    kw = dict(max_stages=1, n_moves=1, method="fixed_dopri5", substeps=1)
    with pytest.warns(UserWarning, match="max_stages=1") as got:
        out = T.smc_sample(*targs, theta0, R.PRNGKey(0), prior_logpdf=_tprior,
                           device="cpu", **kw)
    with pytest.warns(UserWarning) as ref:
        jax_smc(*jargs, jnp.asarray(theta0), jax.random.PRNGKey(0),
                prior_logpdf=_jprior, **kw)
    assert [str(w.message) for w in got] == [str(w.message) for w in ref]
    assert len(out.betas) == 2 and out.betas[-1] < 1.0
