"""Hierarchical (partial-pooling) joint fits, ``JointFit(hierarchical=...,
hyperpriors=...)``, and joint HMC, against odelib_tpu's on the CPU (x64):
tests/test_hierarchical.py's layout and validation, the pooling density
(within 1e-12 of the reference's ``_effective_prior`` closure, with and
without ``use_priors``, default and scipy hyperpriors), the seeding of
the hyper slots, ``backend='pallas'`` refused; the XLA joint MH with the
pooling density and joint HMC (``hamiltonian_mc_custom`` over the summed
chi, diagonal and dense with ChEES) from the same starts and keys:
accept sequences exact, values within 1e-8 relative; then
``JointFit.MCMC(sampler='hmc')`` end to end (no per-experiment chi
columns, the best hyper values kept) and checkpointed, killed and
resumed, bitwise."""
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.stats as st
import torch

import odelib_tpu
import odelib_tpu_torch
from odelib_tpu.distributions import LogNormal as JLogNormal
from odelib_tpu.samplers import hamiltonian_mc_custom as jax_hmc_custom
from odelib_tpu.samplers import joint_metropolis_hastings as jax_joint_mh
from odelib_tpu_torch.distributions import LogNormal
from odelib_tpu_torch.samplers import hamiltonian_mc_custom
from odelib_tpu_torch.samplers import joint_metropolis_hastings

from test_torch_scan_mh import keys

KS = (0.8, 1.0, 1.25)


def _decay_df(k, seed, y0=1e6, sig=0.15, n=10):
    rng = np.random.default_rng(seed)
    tobs = np.linspace(0.0, 3.0, n)
    return pd.DataFrame(
        [{"organism": "y", "time": t,
          "abundance": y0 * np.exp(-k * t) * np.exp(rng.normal(0, sig)),
          "log_sigma": sig} for t in tobs])


def _decay(t, y, ps):
    (k,) = ps
    return jnp.stack([-k * y[0]])


def _experiments(pkg, dist, **kw):
    """tests/test_hierarchical.py's three decay experiments."""
    return {f"e{i}": pkg.ModelFramework(
        ODE=_decay, parameter_names=["k"], state_names=["y"],
        dataframe=_decay_df(k, seed=10 + i), t_steps=32, ode_style="jax",
        random_seed=10 + i,
        k=pkg.parameter(stats_gen=dist(s=0.7, scale=1.0),
                        hyperparameters={}, random_seed=10 + i), **kw)
        for i, k in enumerate(KS)}


def _fits(seed=1, **kw):
    ref = odelib_tpu.JointFit(_experiments(odelib_tpu, JLogNormal),
                              hierarchical=["k"], random_seed=seed, **kw)
    got = odelib_tpu_torch.JointFit(
        _experiments(odelib_tpu_torch, LogNormal, device="cpu"),
        hierarchical=["k"], random_seed=seed, **kw)
    return ref, got


def _draws(C=16, seed=4):
    """C joint draws around the experiments' rates (numpy seed)."""
    rng = np.random.default_rng(seed)
    return np.array(KS + (1.0, 0.25)) * np.exp(rng.normal(0, 0.2, (C, 5)))


def _starts(jf, C=16, seed=4):
    """The draws with their hyper slots seeded as MCMC seeds them."""
    return jf._seed_hyper_slots(_draws(C, seed))


def test_layout_and_validation():
    ref, jf = _fits()
    assert jf.columns == ref.columns == ["e0:k", "e1:k", "e2:k",
                                         "k:pop_median", "k:pop_sigma"]
    assert jf.dim == 5 and jf._idx_maps == ref._idx_maps
    np.testing.assert_array_equal(jf._current_joint_theta(),
                                  ref._current_joint_theta())
    assert np.all(jf._walk_mask() == 1.0)
    m = jf._walk_mask(static_parameters=["k:pop_sigma"])
    assert m[jf._col_offsets["k:pop_sigma"]] == 0.0
    hyper = {jf._col_offsets["k:pop_median"],
             jf._col_offsets["k:pop_sigma"]}
    for idx in jf._idx_maps.values():
        assert hyper.isdisjoint(idx)
    th = _draws(seed=2)
    np.testing.assert_array_equal(jf._seed_hyper_slots(th.copy()),
                                  ref._seed_hyper_slots(th.copy()))
    fws = _experiments(odelib_tpu_torch, LogNormal, device="cpu")
    with pytest.raises(ValueError, match="both shared and hierarchical"):
        odelib_tpu_torch.JointFit(fws, shared=["k"], hierarchical=["k"])
    with pytest.raises(ValueError, match="non-hierarchical"):
        odelib_tpu_torch.JointFit(fws, hierarchical=["k"],
                                  hyperpriors={"zz": (None, None)})
    with pytest.raises(ValueError, match="lacks tied"):
        odelib_tpu_torch.JointFit(fws, hierarchical=["nope"])


@pytest.mark.parametrize("hyperpriors", [
    None, {"k": (st.lognorm(0.5, scale=2.0), (0.5, 0.2))}],
    ids=["default", "scipy"])
def test_pooling_density_matches_reference(hyperpriors):
    """The lognormal population law over z = log theta plus the
    hyperpriors (default: the first framework's prior on the median,
    LogNormal(s=1, scale=0.3) on the spread), within 1e-12 of the
    reference's closure; use_priors does not re-apply the pooled slots'
    priors."""
    if hyperpriors is not None:
        m, (s, sc) = hyperpriors["k"]
        ref, jf = (odelib_tpu.JointFit(
            _experiments(odelib_tpu, JLogNormal), hierarchical=["k"],
            hyperpriors={"k": (m, JLogNormal(s=s, scale=sc))}),
            odelib_tpu_torch.JointFit(
                _experiments(odelib_tpu_torch, LogNormal, device="cpu"),
                hierarchical=["k"],
                hyperpriors={"k": (m, LogNormal(s=s, scale=sc))}))
    else:
        ref, jf = _fits()
    th = _draws(seed=6)
    th[0, 3] = 50.0           # far from a scipy median hyperprior's scale
    for use_priors in (False, True):
        fj, on_j = ref._effective_prior(use_priors)
        ft, on_t = jf._effective_prior(use_priors)
        assert on_j and on_t
        want = np.array([float(fj(jnp.asarray(t))) for t in th])
        got = ft(torch.as_tensor(th)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert np.isfinite(got).all()


def test_backend_pallas_rejected():
    _, jf = _fits()
    run = dict(chain_inits=4, iterations_per_chain=6, fitsurvey_samples=16,
               print_report=False)
    with pytest.raises(ValueError, match="hierarchical"):
        jf.MCMC(backend="pallas", **run)
    with pytest.raises(ValueError, match="XLA backend"):
        jf.MCMC(backend="pallas", sampler="hmc", **run)


def test_hierarchical_joint_mh_matches_reference():
    ref, jf = _fits()
    th = _starts(jf)
    jk, tk = keys(len(th))
    fj, _ = ref._effective_prior(False)
    ft, _ = jf._effective_prior(False)
    ja, ta = ref._device_args({}), jf._device_args({})
    want = jax_joint_mh(*ja[:5], jnp.asarray(th), jk, nits=30, burnin=10,
                        prior_logpdf=fj, use_priors=True, method=ja[5],
                        substeps_list=ja[6])
    got = joint_metropolis_hastings(*ta[:5], th, tk, nits=30, burnin=10,
                                    prior_logpdf=ft, use_priors=True,
                                    method=ta[5], substeps_list=ta[6],
                                    device="cpu")
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(want.acceptance_ratio))
    for f in ("theta", "chi", "chi_parts"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-8)
    assert 0 < float(got.acceptance_ratio[:, -1].mean()) < 1


@pytest.mark.parametrize("kw", [
    {}, dict(dense_mass=True, path_adapt=True, max_leapfrog=6)],
    ids=["diagonal", "dense-chees"])
def test_joint_hmc_matches_reference(kw):
    """HMC over the summed chi with the pooling density (the JointFit
    closures of each package), from the same starts and keys."""
    ref, jf = _fits()
    th = _starts(jf)
    jk, tk = keys(len(th))
    fj, _ = ref._effective_prior(False)
    ft, _ = jf._effective_prior(False)
    run = dict(nits=11, burnin=5, step_size=0.05, use_priors=True, **kw)
    want = jax_hmc_custom(ref._joint_chi_fn({}), jnp.asarray(th), jk,
                          prior_logpdf=fj, **run)
    got = hamiltonian_mc_custom(jf._joint_chi_fn({}), th, tk,
                                prior_logpdf=ft, device="cpu", **run)
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(want.acceptance_ratio))
    for f in ("theta", "chi"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-8)
    assert np.isnan(got.rsquared.numpy()).all()
    assert 0 < float(got.acceptance_ratio[:, -1].mean()) < 1


def test_joint_hmc_through_the_api(tmp_path, monkeypatch):
    """JointFit.MCMC(sampler='hmc'): the joint columns with the hyper
    slots, no chi:<name> columns, the XLA route; the best hyper values
    kept; a checkpointed run killed after one chunk and resumed equals
    the uninterrupted one bitwise."""
    from odelib_tpu_torch import samplers
    _, jf = _fits(seed=16)
    run = dict(chain_inits=8, iterations_per_chain=8, fitsurvey_samples=64,
               sampler="hmc", n_leapfrog=2, step_size=0.05,
               print_report=True)
    post = jf.MCMC(profile=True, **run)
    assert list(post.columns) == jf.columns + [
        "chi", "iteration", "acceptance_ratio", "chain#", "all_rejected"]
    assert "chains[xla]" in jf.last_profile and len(post) == 8 * 3
    assert np.isfinite(post.chi).all()
    best = jf.set_best_params(post)
    assert jf._hyper_vals["k:pop_sigma"] == float(best["k:pop_sigma"])
    path = str(tmp_path / "joint")
    whole = jf.MCMC(**dict(run, print_report=False))
    ck = dict(run, print_report=False, checkpoint_every=3,
              checkpoint_path=path)
    real = samplers.hamiltonian_mc_custom_checkpointed
    with monkeypatch.context() as m:
        m.setattr(samplers, "hamiltonian_mc_custom_checkpointed",
                  lambda *a, **k: real(*a, _stop_after_chunks=1, **k))
        with pytest.raises(AttributeError):     # the killed run's None
            jf.MCMC(**ck)
    resumed = jf.MCMC(resume_from=path + ".progress", **ck)
    for c in whole.columns:
        np.testing.assert_array_equal(resumed[c].to_numpy(),
                                      whole[c].to_numpy(), err_msg=c)
