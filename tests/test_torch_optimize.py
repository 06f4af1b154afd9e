"""Multi-start Adam (odelib_tpu_torch/samplers/optimize.py) against
odelib_tpu's ``map_fit`` and ``map_fit_custom`` on the CPU, both in
float64 (x64) from the same theta0: theta, chi and loss within 1e-8
relative (gradients by two autodiff engines through the same fixed-step
solve), ``converged`` equal, NaN in the same lanes (a start far off the
fit whose solve fails). Plain, and with a prior, a static slot and rk4;
the custom-chi form; the refusals of an adaptive method and of
``use_priors`` without a prior."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odelib_tpu.data import obsdata_to_device
from odelib_tpu.model import chi_of_theta as jax_chi_of_theta
from odelib_tpu.samplers import map_fit as jax_map_fit
from odelib_tpu.samplers import map_fit_custom as jax_map_fit_custom
from odelib_tpu_torch.model import chi_of_theta, obsdata_from_arrays
from odelib_tpu_torch.samplers import optimize as T

from test_torch_hmc import _jax_prior, _torch_prior
from test_torch_scan_mh import chains
from test_torch_survey import setup  # noqa: F401  (module fixture)

RTOL = 1e-8
N = 12


def starts():
    """N starts around the fit, one far off it (its solve fails)."""
    th = chains(N, seed=5, sd=0.4)
    th[4] = [50.0, 1e-3, 1e4]
    return th


def assert_same_map(got, ref):
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(ref.converged))
    for f in ("theta", "chi", "loss"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f)
        np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=f)


CASES = {
    "plain": dict(steps=20, learning_rate=0.1),
    "priors-static-rk4": dict(steps=12, use_priors=True,
                              walk_mask=[1.0, 0.0, 1.0], method="rk4",
                              substeps=3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_map_fit_matches_reference(setup, case):  # noqa: F811
    spec, tspec, obs, tf, y0 = setup
    kw = CASES[case]
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("use_priors"):
        jkw["prior_logpdf"], tkw["prior_logpdf"] = _jax_prior, _torch_prior
    th0 = starts()
    ref = jax_map_fit(spec, obsdata_to_device(obs), jnp.asarray(tf),
                      jnp.asarray(y0), jnp.asarray(th0), **jkw)
    got = T.map_fit(tspec, obsdata_from_arrays(obs), tf, y0, th0,
                    device="cpu", **tkw)
    assert got.theta.shape == (N, 3) and got.theta.dtype == torch.float64
    assert_same_map(got, ref)
    chi = got.chi.numpy()
    assert np.isnan(chi[4]) and np.isfinite(np.delete(chi, 4)).all()
    if case == "priors-static-rk4":
        np.testing.assert_allclose(got.theta[:, 1].numpy(), th0[:, 1],
                                   rtol=4e-15)


def test_map_fit_custom_matches_reference(setup):  # noqa: F811
    """A custom chi: the fixed-step chi of two experiments (the fit data
    and the same with y0 x 1.1), summed, with a prior."""
    spec, tspec, obs, tf, y0 = setup
    jobs, tobs = obsdata_to_device(obs), obsdata_from_arrays(obs)
    ikw = dict(method="fixed_dopri5", substeps=3)

    def jchi(th):
        return sum(jax_chi_of_theta(spec, jobs, th, jnp.asarray(y0 * f),
                                    jnp.asarray(tf), **ikw)
                   for f in (1.0, 1.1))

    def tchi(th):
        a, b = (chi_of_theta(tspec, tobs, th, y0 * f, tf, **ikw)
                for f in (1.0, 1.1))
        return a + b

    th0 = starts()
    ref = jax_map_fit_custom(jchi, jnp.asarray(th0), steps=12,
                             use_priors=True, prior_logpdf=_jax_prior)
    got = T.map_fit_custom(tchi, th0, steps=12, use_priors=True,
                           prior_logpdf=_torch_prior, device="cpu")
    assert_same_map(got, ref)


def test_map_fit_refusals(setup):  # noqa: F811
    spec, tspec, obs, tf, y0 = setup
    tobs = obsdata_from_arrays(obs)
    with pytest.raises(ValueError, match="fixed-step"):
        T.map_fit(tspec, tobs, tf, y0, np.ones((1, 3)), method="dopri5",
                  device="cpu")
    with pytest.raises(ValueError, match="requires prior_logpdf"):
        T.map_fit(tspec, tobs, tf, y0, np.ones((1, 3)), use_priors=True,
                  device="cpu")
    with pytest.raises(ValueError, match="requires prior_logpdf"):
        T.map_fit_custom(lambda th: th.sum(-1), np.ones((1, 3)),
                         use_priors=True, device="cpu")
    for fn in (lambda: jax_map_fit(spec, obsdata_to_device(obs),
                                   jnp.asarray(tf), jnp.asarray(y0),
                                   jnp.ones((1, 3)), use_priors=True),
               lambda: jax_map_fit_custom(jnp.sum, jnp.ones((1, 3)),
                                          use_priors=True)):
        with pytest.raises(ValueError, match="requires prior_logpdf"):
            fn()
    assert jax.devices()[0].platform == "cpu"
