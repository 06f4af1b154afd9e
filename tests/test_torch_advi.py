"""ADVI (odelib_tpu_torch/samplers/advi.py) against odelib_tpu's ``advi``
and ``advi_custom`` on the CPU, both in float64 (x64) from the same theta
and seed: the step, evaluation and posterior normals bitwise
``jax.random``'s; the ELBO trace, ``mu`` and ``L`` within 1e-8 relative;
the draws' theta, chi and log weights within 1e-8; ``converged`` equal;
PSIS ``khat`` within 1e-6 and the resampling indices equal. Full rank with
a prior and a static slot, mean field under rk4; the custom-chi form; the
refusals (every dimension static, ``use_priors`` without a prior, an
adaptive method)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odelib_tpu.data import obsdata_to_device
from odelib_tpu.model import chi_of_theta as jax_chi_of_theta
from odelib_tpu.samplers import advi as jax_advi
from odelib_tpu.samplers import advi_custom as jax_advi_custom
from odelib_tpu.samplers import psis_weights as jax_psis_weights
from odelib_tpu.samplers import resample_indices as jax_resample
from odelib_tpu_torch import random as R
from odelib_tpu_torch.model import chi_of_theta, obsdata_from_arrays
from odelib_tpu_torch.samplers.advi import (advi, advi_custom,
                                            psis_weights, resample_indices)

from test_torch_hmc import _jax_prior, _torch_prior
from test_torch_survey import setup  # noqa: F401  (module fixture)

RTOL = 1e-8
THETA = np.array([0.6, 2.4e-8, 24.0])


def assert_same_advi(got, ref, seed):
    np.testing.assert_array_equal(got.free_idx.numpy(),
                                  np.asarray(ref.free_idx))
    assert got.converged == bool(ref.converged)
    for f in ("elbo", "mu", "L", "theta", "chi", "rsquared", "aic",
              "logw"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f)
        np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=f)
    lw, khat = psis_weights(got.logw.numpy())
    lw_r, khat_r = jax_psis_weights(np.asarray(ref.logw))
    np.testing.assert_allclose(khat, khat_r, rtol=1e-6)
    np.testing.assert_array_equal(resample_indices(lw, seed),
                                  jax_resample(lw_r, seed))


def test_advi_normals_bitwise():
    """Every normal ADVI draws: the steps' (n_mc, F) from fold_in(key, i),
    the evaluation batch from fold_in(key, steps + 2) and the posterior
    draws from fold_in(key, steps + 1)."""
    steps, n_mc, F, draws = 12, 4, 3, 200
    jk, tk = jax.random.PRNGKey(7), R.PRNGKey(7)
    for i, n in [(i, n_mc) for i in range(steps)] + [
            (steps + 2, max(64, 4 * n_mc)), (steps + 1, draws)]:
        a = R.normal(R.fold_in(tk, i), (n, F), torch.float64).numpy()
        b = np.asarray(jax.random.normal(jax.random.fold_in(jk, i), (n, F),
                                         jnp.float64))
        np.testing.assert_array_equal(a, b)


CASES = {
    "full-rank-priors-static": dict(steps=16, use_priors=True, seed=3,
                                    walk_mask=[1.0, 0.0, 1.0]),
    "mean-field-rk4": dict(steps=12, full_rank=False, learning_rate=0.1,
                           method="rk4", substeps=3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_advi_matches_reference(setup, case):  # noqa: F811
    spec, tspec, obs, tf, y0 = setup
    kw = dict(CASES[case], n_mc=4, draws=200)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("use_priors"):
        jkw["prior_logpdf"], tkw["prior_logpdf"] = _jax_prior, _torch_prior
    ref = jax_advi(spec, obsdata_to_device(obs), jnp.asarray(tf),
                   jnp.asarray(y0), THETA, **jkw)
    got = advi(tspec, obsdata_from_arrays(obs), tf, y0, THETA,
                 device="cpu", **tkw)
    assert got.theta.shape == (200, 3) and got.elbo.shape == (kw["steps"],)
    assert_same_advi(got, ref, kw.get("seed", 0))
    if case == "full-rank-priors-static":
        assert got.L.shape == (2, 2)
        assert (got.theta[:, 1].numpy() == np.exp(np.log(THETA[1]))).all()


def test_advi_custom_matches_reference(setup):  # noqa: F811
    """A custom chi (the fixed-step chi of the fit data and of the same
    with y0 x 1.1, summed), full rank, with a prior: rsquared/aic NaN."""
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

    kw = dict(steps=10, n_mc=4, draws=100, use_priors=True, seed=2)
    ref = jax_advi_custom(jchi, THETA, prior_logpdf=_jax_prior, **kw)
    got = advi_custom(tchi, THETA, prior_logpdf=_torch_prior,
                        device="cpu", **kw)
    assert np.isnan(got.rsquared.numpy()).all()
    assert_same_advi(got, ref, 2)


def test_advi_refusals(setup):  # noqa: F811
    spec, tspec, obs, tf, y0 = setup
    tobs = obsdata_from_arrays(obs)
    args = (tspec, tobs, tf, y0, THETA)
    with pytest.raises(ValueError, match="every dimension is masked"):
        advi(*args, walk_mask=[0.0, 0.0, 0.0], device="cpu")
    with pytest.raises(ValueError, match="requires prior_logpdf"):
        advi(*args, use_priors=True, device="cpu")
    with pytest.raises(ValueError, match="fixed-step"):
        advi(*args, method="dopri5", device="cpu")
    with pytest.raises(ValueError, match="every dimension is masked"):
        advi_custom(lambda th: th.sum(-1), THETA, walk_mask=np.zeros(3),
                      device="cpu")
    jargs = (spec, obsdata_to_device(obs), jnp.asarray(tf), jnp.asarray(y0),
             THETA)
    with pytest.raises(ValueError, match="every dimension is masked"):
        jax_advi(*jargs, walk_mask=[0.0, 0.0, 0.0])
    with pytest.raises(ValueError, match="fixed-step"):
        jax_advi(*jargs, method="dopri5")


def test_psis_and_resampling_match_reference():
    """psis_weights on seeded raw log weights with -inf and NaN entries,
    and resample_indices, bitwise the reference's."""
    rng = np.random.default_rng(4)
    logw = rng.standard_t(3, 500) * 2.0
    logw[[3, 77]] = -np.inf
    logw[10] = np.nan
    lw, khat = psis_weights(logw)
    lw_r, khat_r = jax_psis_weights(logw)
    np.testing.assert_array_equal(lw, lw_r)
    assert khat == khat_r
    np.testing.assert_array_equal(resample_indices(lw, 9),
                                  jax_resample(lw_r, 9))
    lw0, k0 = psis_weights(np.full(5, -np.inf))
    assert k0 == float("inf") and np.isneginf(lw0).all()
