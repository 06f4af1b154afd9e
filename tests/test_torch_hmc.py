"""HMC (odelib_tpu_torch/samplers/hmc.py) against odelib_tpu's
``hamiltonian_mc`` and ``hamiltonian_mc_custom`` on the CPU, both in
float64 (x64) from the same theta0 and keys: accept sequences exact,
theta and chi within 1e-8 relative (gradients by two autodiff engines
through the same fixed-step solve; measured ~1e-10). Diagonal and dense
mass, ChEES, priors, a static slot and rk4; the potential's value and
gradient against ``jax.value_and_grad`` (NaN lanes where JAX's are);
chunked and killed-and-resumed runs bitwise their whole run (port only);
the warmup-boundary rejuvenation of a stuck chain; an adaptive method
refused. The API's ``MCMC(sampler='hmc')`` and ``get_chi_sensitivity``
are in tests/test_torch_hmc_api.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odelib_tpu.data import obsdata_to_device
from odelib_tpu.samplers import hamiltonian_mc as jax_hmc
from odelib_tpu.samplers import hamiltonian_mc_custom as jax_hmc_custom
from odelib_tpu.samplers.hmc import _make_vag_u
from odelib_tpu_torch import random as R
from odelib_tpu_torch.model import obsdata_from_arrays
from odelib_tpu_torch.samplers import hmc as T

from test_torch_scan_mh import assert_same, chains, keys
from test_torch_survey import setup  # noqa: F401  (module fixture)

C = 16


def _jax_prior(th):
    """A lognormal prior on mu and beta, the reference's (theta (P,))."""
    return (-0.5 * (jnp.log(th[0] / 0.6) / 0.5) ** 2 - jnp.log(th[0])
            - 0.5 * (jnp.log(th[2] / 24.0) / 0.3) ** 2 - jnp.log(th[2]))


def _torch_prior(th):
    """The same on a batch (theta (N, P))."""
    return (-0.5 * (torch.log(th[:, 0] / 0.6) / 0.5) ** 2
            - torch.log(th[:, 0])
            - 0.5 * (torch.log(th[:, 2] / 24.0) / 0.3) ** 2
            - torch.log(th[:, 2]))


CASES = {
    "diagonal": {},
    "dense": dict(dense_mass=True),
    "chees": dict(path_adapt=True, max_leapfrog=8),
    "dense-chees-priors": dict(dense_mass=True, path_adapt=True,
                               max_leapfrog=6, use_priors=True),
    "static-slot": dict(walk_mask=[1.0, 0.0, 1.0]),
    "rk4": dict(method="rk4", n_leapfrog=3),
}


def run_both(setup, th0, **kw):
    spec, tspec, obs, tf, y0 = setup
    jk, tk = keys(len(th0))
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("walk_mask") is not None:
        jkw["walk_mask"] = jnp.asarray(kw["walk_mask"])
    if kw.get("use_priors"):
        jkw["prior_logpdf"], tkw["prior_logpdf"] = _jax_prior, _torch_prior
    ref = jax_hmc(spec, obsdata_to_device(obs), jnp.asarray(tf),
                  jnp.asarray(y0), jnp.asarray(th0), jk, **jkw)
    got = T.hamiltonian_mc(tspec, obsdata_from_arrays(obs), tf, y0, th0,
                           tk, device="cpu", **tkw)
    return got, ref


@pytest.mark.parametrize("case", list(CASES))
def test_hmc_matches_reference(setup, case):  # noqa: F811
    th0 = chains(C)
    got, ref = run_both(setup, th0, nits=13, burnin=6, **CASES[case])
    assert got.theta.shape == (C, 6, 3)
    assert_same(got, ref)
    acc = got.acceptance_ratio[:, -1].numpy()
    assert 0 < acc.mean() < 1
    if case == "static-slot":   # phi stays exp(log(theta0))
        fixed = got.theta[:, :, 1].numpy()
        assert (fixed == fixed[:, :1]).all()
        np.testing.assert_allclose(fixed[:, 0], th0[:, 1], rtol=4e-15)


def test_potential_matches_value_and_grad(setup):  # noqa: F811
    """U, the metrics and dU/dz of 16 lanes, one far off the fit whose
    solve fails: NaN in the same lanes as JAX's, nowhere else (the lanes
    are independent under the batched backward pass)."""
    spec, tspec, obs, tf, y0 = setup
    th = chains(C, seed=0, sd=0.3)
    th[3] = [50.0, 1e-3, 1e4]
    z = np.log(th)
    (u, (chi, rsq, aic)), g = jax.jit(_make_vag_u(
        spec, obsdata_to_device(obs), jnp.asarray(tf), jnp.asarray(y0),
        use_priors=False, prior_logpdf=None, num_params=3,
        ikw=dict(method="fixed_dopri5", substeps=4)))(jnp.asarray(z))
    vag = T.potential(tspec, obsdata_from_arrays(obs), tf, y0,
                      torch.as_tensor(th), num_params=3)
    tu, (tchi, trsq, taic), tg = vag(torch.as_tensor(z))
    g = np.asarray(g)
    np.testing.assert_array_equal(np.isnan(tg.numpy()), np.isnan(g))
    assert np.isnan(g).any() and np.isfinite(g[np.arange(C) != 3]).all()
    for a, b in ((tu, u), (tchi, chi), (trsq, rsq), (taic, aic), (tg, g)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)


def test_hmc_chunked_and_resumed_bitwise(setup, tmp_path):  # noqa: F811
    """chunk_iters and checkpoint_every cut the run (a chunk straddles the
    burn-in boundary); a kill after two chunks and a resume; all bitwise
    the whole run, the dense Cholesky factor and ChEES's state in the
    packed carry; a changed configuration is refused."""
    spec, tspec, obs, tf, y0 = setup
    obs = obsdata_from_arrays(obs)
    _, tk = keys(6)
    th0 = chains(6, seed=9)
    kw = dict(nits=9, burnin=3, dense_mass=True, path_adapt=True,
              max_leapfrog=4, n_leapfrog=2, device="cpu")
    whole = T.hamiltonian_mc(tspec, obs, tf, y0, th0, tk, **kw)
    chunked = T.hamiltonian_mc(tspec, obs, tf, y0, th0, tk, chunk_iters=3,
                               **kw)
    path = str(tmp_path / "hmc.progress")
    ck = dict(checkpoint_every=2, checkpoint_path=path, **kw)
    assert T.hamiltonian_mc_checkpointed(
        tspec, obs, tf, y0, th0, tk, _stop_after_chunks=2, **ck) is None
    resumed = T.hamiltonian_mc_checkpointed(
        tspec, obs, tf, y0, th0, tk, resume_from=path, **ck)
    for out in (chunked, resumed):
        for a, b in zip(out, whole):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="different HMC configuration"):
        T.hamiltonian_mc_checkpointed(
            tspec, obs, tf, y0, th0, tk, resume_from=path,
            **dict(ck, dense_mass=False))


def _stuck_chains():
    """tests/test_hmc.py's stuck chain: chain 0 seeded on a NaN plateau
    (|log theta| > 20) where every proposal is rejected."""
    rng = np.random.default_rng(0)
    th0 = np.exp(rng.normal(0, 1, (C, 1)))
    th0[0, 0] = np.exp(30.0)
    return th0


def _torch_chi(theta):
    z = torch.log(theta)[:, 0]
    return torch.where(torch.abs(z) > 20.0, torch.nan, 0.5 * z * z)


def test_hmc_rejuvenation_matches_reference():
    """The stuck chain never accepts during warmup and at its boundary
    restarts from another chain (``jax.random.permutation``); the port's
    run is the reference's. The comparison stops at 17 iterations: the
    stuck chain inflates the shared inverse mass (~54), which puts the
    leapfrog beyond its stability limit on this potential, so the two
    libraries' ulps in exp grow ~10x every 5 iterations (4e-11 at 15,
    3.5e-9 at 20; an acceptance first differs at 61; ROADMAP queue 3)."""
    def jax_chi(theta):
        z = jnp.log(theta)[0]
        return jnp.where(jnp.abs(z) > 20.0, jnp.nan, 0.5 * z * z)

    th0 = _stuck_chains()
    jk = jax.random.split(jax.random.PRNGKey(0), C)
    tk = R.split(R.PRNGKey(0), C)
    kw = dict(nits=18, burnin=9, n_leapfrog=4)
    ref = jax_hmc_custom(jax_chi, jnp.asarray(th0), jk, **kw)
    got = T.hamiltonian_mc_custom(_torch_chi, th0, tk, device="cpu", **kw)
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    for f in ("theta", "chi"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-8)
    assert np.isnan(got.rsquared.numpy()).all()
    # restarted at the boundary: off the plateau from the first record
    assert np.all(np.abs(np.log(got.theta[0, :, 0].numpy())) < 20.0)


def test_hmc_rejuvenation_rescues_stuck_chain():
    """tests/test_hmc.py's 200-iteration run, the port alone: chain 0
    leaves the plateau and mixes."""
    got = T.hamiltonian_mc_custom(_torch_chi, _stuck_chains(),
                                  R.split(R.PRNGKey(0), C), nits=200,
                                  burnin=100, n_leapfrog=4, device="cpu")
    z0 = np.log(got.theta[0, :, 0].numpy())
    assert np.all(np.abs(z0) < 20.0)
    assert float(got.acceptance_ratio[0, -1]) > 0.05


def test_hmc_refuses_an_adaptive_method(setup):  # noqa: F811
    spec, tspec, obs, tf, y0 = setup
    _, tk = keys(2)
    with pytest.raises(ValueError, match="fixed-step"):
        T.hamiltonian_mc(tspec, obsdata_from_arrays(obs), tf, y0, chains(2),
                         tk, nits=10, burnin=2, method="dopri5",
                         device="cpu")
    with pytest.raises(ValueError, match="requires prior_logpdf"):
        T.hamiltonian_mc(tspec, obsdata_from_arrays(obs), tf, y0, chains(2),
                         tk, nits=10, use_priors=True, device="cpu")
