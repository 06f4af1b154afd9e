"""Adaptive Metropolis (odelib_tpu_torch/samplers/amh.py) against
odelib_tpu's ``adaptive_metropolis`` on the CPU, both in float64 (x64)
from the same theta0 and keys: accept sequences exact, theta and chi
within 1e-8 relative (measured ~1e-13). Adaptive Dopri5 with the adapted
covariance proposing inside burn-in, a static slot (its covariance row
and column zero, its value fixed), fixed-step Dopri5 with priors; then
``MCMC(sampler='amh')`` end to end, the posterior frame column by column,
and checkpoint_every warned away as in the reference."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odelib_tpu.data import obsdata_to_device
from odelib_tpu.samplers import adaptive_metropolis as jax_amh
from odelib_tpu_torch.model import obsdata_from_arrays
from odelib_tpu_torch.samplers import amh as T

from test_torch_hmc import _jax_prior, _torch_prior
from test_torch_hmc_api import INITS, assert_same_frame, both
from test_torch_scan_mh import assert_same, chains, keys
from test_torch_survey import setup  # noqa: F401  (module fixture)

CASES = {
    "dopri5": {},
    "static-slot": dict(walk_mask=[1.0, 0.0, 1.0]),
    "fixed-dopri5-priors": dict(method="fixed_dopri5", use_priors=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_amh_matches_reference(setup, case):  # noqa: F811
    spec, tspec, obs, tf, y0 = setup
    kw = dict(nits=30, burnin=20, adapt_start=6, **CASES[case])
    jkw, tkw = dict(kw), dict(kw)
    if "walk_mask" in kw:
        jkw["walk_mask"] = jnp.asarray(kw["walk_mask"])
    if kw.get("use_priors"):
        jkw["prior_logpdf"], tkw["prior_logpdf"] = _jax_prior, _torch_prior
    th0 = chains(16)
    jk, tk = keys(16)
    ref = jax_amh(spec, obsdata_to_device(obs), jnp.asarray(tf),
                  jnp.asarray(y0), jnp.asarray(th0), jk, **jkw)
    got = T.adaptive_metropolis(tspec, obsdata_from_arrays(obs), tf, y0,
                                th0, tk, device="cpu", **tkw)
    assert got.theta.shape == (16, 9, 3)
    assert_same(got, ref)
    assert 0 < float(got.acceptance_ratio[:, -1].mean()) < 1
    if case == "static-slot":
        fixed = got.theta[:, :, 1].numpy()
        assert (fixed == fixed[:, :1]).all()
        np.testing.assert_allclose(fixed[:, 0], th0[:, 1], rtol=4e-15)


def test_amh_adapted_proposal_differs_from_the_walk(setup):  # noqa: F811
    """adapt_start past burn-in leaves the isotropic walk: the same
    chains then follow another path (the adapted covariance proposes)."""
    spec, tspec, obs, tf, y0 = setup
    _, tk = keys(8)
    args = (tspec, obsdata_from_arrays(obs), tf, y0, chains(8), tk)
    a = T.adaptive_metropolis(*args, nits=20, burnin=12, adapt_start=4,
                              device="cpu")
    b = T.adaptive_metropolis(*args, nits=20, burnin=12, adapt_start=50,
                              device="cpu")
    assert not torch.equal(a.theta, b.theta)


def test_mcmc_amh_matches_reference():
    ref_fw, fw = both()
    run = dict(chain_inits=INITS, iterations_per_chain=12, sampler="amh",
               adapt_start=3, print_report=False)
    ref = ref_fw.MCMC(backend="xla", **run)
    got = fw.MCMC(profile=True, **run)
    assert "chains[amh]" in fw.last_profile
    assert_same_frame(got, ref)
    with pytest.warns(UserWarning, match="without periodic checkpoints"):
        again = fw.MCMC(checkpoint_every=3, checkpoint_path=None, **run)
    assert_same_frame(again, ref)
