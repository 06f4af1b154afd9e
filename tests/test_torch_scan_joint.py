"""The XLA joint samplers (odelib_tpu_torch/samplers/joint.py) against
odelib_tpu's samplers/joint.py on the CPU, both in float64 (x64) from the
same keys: the random stream is bitwise, accept sequences exact, theta and
chi within 1e-8 relative (measured ~1e-14). Joint MH on the zero_i pair of
tests/test_torch_joint.py, plain and checkpointed (4 chunks, killed and
resumed: bitwise); joint PMMH on tests/test_joint.py's pair of a
deterministic growth model and a GBM sharing r; and JointFit.MCMC end to
end on the routes that run these samplers (backend='xla', a stochastic
member, until_min_ess on the xla route), both packages seeded from one
survey frame (their LHS draws differ: ROADMAP queue 3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import odelib_tpu
import odelib_tpu_torch
from odelib_tpu.distributions import LogNormal as JLogNormal
from odelib_tpu.samplers import joint as JJ
from odelib_tpu_torch import random as R
from odelib_tpu_torch.distributions import LogNormal
from odelib_tpu_torch.samplers import joint as TJ
from odelib_tpu_torch.samplers.pf import obs_blocks

from test_torch_joint import _fits

RTOL = 1e-8


def _keys(C, seed=0):
    jk = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed),
                                               i))(jnp.arange(C))
    return jk, R.fold_in(R.PRNGKey(seed), torch.arange(C))


def _args(jf):
    """(specs, idx maps, obs, grids, y0s, method, substeps) of a JointFit,
    as its MCMC passes them."""
    return jf._device_args({})


def _starts(jf, C, seed=0):
    return jf._current_joint_theta()[None] * np.exp(
        np.random.default_rng(seed).normal(0, 0.05, (C, jf.dim)))


def _assert_same(got, ref):
    np.testing.assert_array_equal(got.iteration.numpy(),
                                  np.asarray(ref.iteration))
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    for f in ("theta", "chi", "chi_parts"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=RTOL,
                                   err_msg=f)


@pytest.mark.parametrize("priors", [False, True], ids=["plain", "priors"])
def test_joint_mh_matches_reference(priors):
    ref_jf, jf = _fits("zero_i-pair")
    *targs, method, subs = _args(jf)
    *jargs, jmethod, jsubs = _args(ref_jf)
    C = 6
    jk, tk = _keys(C)
    th0 = _starts(jf, C)
    kw = dict(nits=12, rwalk_std=0.08)
    jkw, tkw = dict(kw), dict(kw)
    if priors:
        jkw.update(use_priors=True, prior_logpdf=ref_jf._joint_prior_logpdf())
        tkw.update(use_priors=True, prior_logpdf=jf._joint_prior_logpdf())
    ref = JJ.joint_metropolis_hastings(*jargs, jnp.asarray(th0), jk,
                                       method=jmethod, substeps_list=jsubs,
                                       **jkw)
    got = TJ.joint_metropolis_hastings(*targs, th0, tk, method=method,
                                       substeps_list=subs, device="cpu",
                                       **tkw)
    assert got.chi_parts.shape == (C, 5, 2)
    _assert_same(got, ref)
    acc = got.acceptance_ratio[:, -1].numpy()
    assert 0 < acc.mean() < 1
    np.testing.assert_allclose(got.chi.numpy(),
                               got.chi_parts.sum(-1).numpy(), rtol=1e-15)


def test_joint_mh_checkpointed_bitwise(tmp_path):
    """4 chunks of 3 (one straddling the burn-in), a kill after two and a
    resume (the keys carried in the file): bitwise the whole run; a
    changed configuration is refused."""
    _, jf = _fits("zero_i-pair")
    *targs, method, subs = _args(jf)
    _, tk = _keys(4, seed=1)
    th0 = _starts(jf, 4, seed=1)
    kw = dict(nits=13, burnin=5, method=method, substeps_list=subs,
              device="cpu")
    whole = TJ.joint_metropolis_hastings(*targs, th0, tk, **kw)
    path = str(tmp_path / "joint.progress")
    ck = dict(kw, checkpoint_every=3, checkpoint_path=path)
    chunks = TJ.joint_metropolis_hastings_checkpointed(*targs, th0, tk, **ck)
    assert TJ.joint_metropolis_hastings_checkpointed(
        *targs, th0, tk, _stop_after_chunks=2, **ck) is None
    resumed = TJ.joint_metropolis_hastings_checkpointed(
        *targs, th0, tk, resume_from=path, **ck)
    for out in (chunks, resumed):
        for a, b in zip(out, whole):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="different joint MCMC"):
        TJ.joint_metropolis_hastings_checkpointed(
            *targs, th0, tk, resume_from=path, **dict(ck, rwalk_std=0.1))


def _det_gbm(pkg, dist, **kw):
    """tests/test_joint.py's pair: a deterministic growth model and a GBM
    (diffusion=) sharing r."""
    r_true, sig = 0.5, 0.25
    rng = np.random.default_rng(7)
    ts = np.linspace(0.25, 2.0, 8)

    def growth(t, y, ps):
        return jnp.stack([ps[0] * y[0]])

    def gnoise(t, y, ps):
        return jnp.stack([ps[1] * y[0]])

    ab_det = 5.0 * np.exp(r_true * ts) * np.exp(rng.normal(0, 0.1, ts.size))
    z, zs, prev = np.log(10.0), [], 0.0
    for t in ts:
        z += (r_true - 0.5 * sig ** 2) * (t - prev) \
            + sig * np.sqrt(t - prev) * rng.normal()
        prev = t
        zs.append(z)
    ab_sto = np.exp(np.array(zs) + 0.1 * rng.normal(size=ts.size))

    def frame(ab):
        return pd.DataFrame({"organism": "X", "time": ts, "abundance": ab,
                             "log_sigma": 0.1})

    def r():
        return pkg.parameter(stats_gen=dist(s=0.5, scale=0.4),
                             hyperparameters={}, random_seed=0)
    fw_det = pkg.ModelFramework(
        ODE=growth, parameter_names=["r"], state_names=["X"],
        dataframe=frame(ab_det), t_steps=17, ode_style="jax",
        random_seed=0, r=r(), X=5.0, **kw)
    fw_sto = pkg.ModelFramework(
        ODE=growth, diffusion=gnoise, parameter_names=["r", "s"],
        state_names=["X"], dataframe=frame(ab_sto), t_steps=17,
        ode_style="jax", random_seed=1, r=r(),
        s=pkg.parameter(stats_gen=dist(s=0.4, scale=0.25),
                        hyperparameters={}, random_seed=1), X=10.0, **kw)
    return pkg.JointFit({"det": fw_det, "sto": fw_sto}, shared=["r"])


@pytest.mark.parametrize("adapt", [False, True], ids=["plain", "adapt"])
def test_joint_pmmh_matches_reference(adapt):
    ref_jf = _det_gbm(odelib_tpu, JLogNormal)
    jf = _det_gbm(odelib_tpu_torch, LogNormal, device="cpu")
    *targs, method, subs = _args(jf)
    *jargs, jmethod, jsubs = _args(ref_jf)
    C = 5
    jk, tk = _keys(C, seed=4)
    th0 = np.array([0.5, 0.25]) * np.exp(
        np.random.default_rng(4).normal(0, 0.1, (C, 2)))
    from odelib_tpu.samplers.pf import obs_blocks as j_obs_blocks
    kw = dict(nits=10, n_particles=16, sde_substeps=2, rwalk_std=0.1,
              adapt_proposal=adapt, adapt_rate=0.2, use_priors=True)
    ref = JJ.joint_pmmh(
        *jargs, jnp.asarray(th0), jk, method=jmethod, substeps_list=jsubs,
        stoch_blocks=(None, j_obs_blocks(
            ref_jf.frameworks["sto"]._obsdata_fit_host)),
        prior_logpdf=ref_jf._joint_prior_logpdf(), **kw)
    got = TJ.joint_pmmh(
        *targs, th0, tk, method=method, substeps_list=subs,
        stoch_blocks=(None, obs_blocks(
            jf.frameworks["sto"]._obsdata_fit_host)),
        prior_logpdf=jf._joint_prior_logpdf(), device="cpu", **kw)
    _assert_same(got, ref)
    assert np.isfinite(got.chi.numpy()).all()
    with pytest.raises(ValueError, match="exactly for the diffusion"):
        TJ.joint_pmmh(*targs, th0, tk, stoch_blocks=(None, None),
                      device="cpu")


def _seed_both(ref_jf, jf, n=24, seed=3):
    """One survey frame for both packages: draws around the current
    values with chi 0, 1, ..., so both seed the same chains."""
    th = jf._current_joint_theta()[None] * np.exp(
        np.random.default_rng(seed).normal(0, 0.05, (n, jf.dim)))
    chi = {"chi": np.arange(float(n))}
    ref_jf.fit_survey = lambda samples, **kw: ref_jf._df_from_thetas(th, chi)
    jf.fit_survey = lambda samples, **kw: jf._df_from_thetas(th, chi)


def _assert_frames(got, ref, cols):
    assert list(got.columns) == list(ref.columns)
    pd.testing.assert_index_equal(got.index, ref.index)
    for col in ref.columns:
        assert got[col].dtype == ref[col].dtype, col
    for col in ("iteration", "chain#", "all_rejected", "acceptance_ratio"):
        np.testing.assert_array_equal(got[col].to_numpy(),
                                      ref[col].to_numpy())
    for col in cols:
        np.testing.assert_allclose(got[col], ref[col], rtol=RTOL,
                                   err_msg=col)


@pytest.mark.parametrize("kind", ["xla", "xla-priors", "stochastic"])
def test_jointfit_mcmc_matches_reference(kind):
    """JointFit.MCMC end to end: backend='xla' (with and without priors)
    on the zero_i pair, and 'auto' with a stochastic member (joint PMMH):
    the reference's posterior frame and its report numbers."""
    if kind == "stochastic":
        ref_jf = _det_gbm(odelib_tpu, JLogNormal)
        jf = _det_gbm(odelib_tpu_torch, LogNormal, device="cpu")
        kw = dict(n_particles=16, sde_substeps=2, rwalk_std=0.1)
        cols = ["r", "sto:s", "chi", "chi:det", "chi:sto"]
    else:
        ref_jf, jf = _fits("zero_i-pair")
        kw = dict(backend="xla", substeps=1,
                  use_priors=kind == "xla-priors")
        cols = ["phi", "beta", "a:mu", "b:mu", "chi", "chi:a", "chi:b"]
    _seed_both(ref_jf, jf)
    run = dict(chain_inits=5, iterations_per_chain=10, burnin=4,
               print_report=False, **kw)
    got = jf.MCMC(profile=True, **run)
    ref = ref_jf.MCMC(**run)
    assert len(got) == 5 * 5
    assert f"chains[{'pmmh' if kind == 'stochastic' else 'xla'}]" \
        in jf.last_profile
    _assert_frames(got, ref, cols)
    assert np.isfinite(got["chi"]).all()


def test_jointfit_until_min_ess_on_the_xla_route():
    """until_min_ess on backend='xla': each extension restarts every
    chain from its last state with keys fold_in(PRNGKey(seed), salt *
    1_000_003 + i), no burn-in; the stitched frame is the reference's."""
    ref_jf, jf = _fits("zero_i-pair")
    _seed_both(ref_jf, jf)
    run = dict(chain_inits=4, iterations_per_chain=12, backend="xla",
               substeps=1, until_min_ess=200.0, max_extensions=2,
               print_report=False)
    with pytest.warns(UserWarning, match="extension cap"):
        got = jf.MCMC(**run)
    with pytest.warns(UserWarning, match="extension cap"):
        ref = ref_jf.MCMC(**run)
    per_chain = got[got["chain#"] == 0]["iteration"].to_numpy()
    assert per_chain.max() == 3 * 11 and (np.diff(per_chain) > 0).all()
    _assert_frames(got, ref, ["phi", "beta", "a:mu", "b:mu", "chi"])
