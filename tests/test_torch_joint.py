"""Joint fitting: the port's ``joint_metropolis_hastings_fused`` (torch
twin on the CPU) against ``odelib_tpu``'s Pallas kernel in interpret mode,
record by record, on a pair of one model and on a pair of different models;
``joint_survey`` and ``JointFit.fit_survey`` against the JAX package's in
float64; and ``JointFit.MCMC`` end to end. Kernel-versus-twin on the card is
in tests/test_torch_cuda.py and chip_smoke.py's joint phases."""
import re

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import odelib_tpu
import odelib_tpu.samplers as jax_samplers
import odelib_tpu_torch
from odelib_tpu import JointFit as JJointFit
from odelib_tpu.distributions import LogNormal as JLogNormal
from odelib_tpu.ops.pallas_joint import \
    joint_metropolis_hastings_fused as jax_joint_fused
from odelib_tpu.samplers.joint import joint_survey as jax_joint_survey
from odelib_tpu_torch import JointFit
from odelib_tpu_torch.distributions import LogNormal
from odelib_tpu_torch.ops import cuda_joint as TJ
from odelib_tpu_torch.samplers import joint_survey

from helpers import synthetic_df, zero_i

_PRI = dict(mu=((3.0, 1e-8)), phi=(3.0, 1e-8), beta=(1.0, 25.0))


def _zero_i_pair(pkg, dist, **kw):
    """zero_i on synthetic data (a; every other time point, so an 8-point
    grid) and on the same frame with perturbed log abundances and initial
    abundances x 1.13 (b)."""
    df_a = synthetic_df()
    df_a = df_a[np.isclose(np.mod(np.round(df_a["time"] / 0.2), 2), 0)]
    df_b = df_a.copy()
    df_b["abundance"] = df_b["abundance"] * np.exp(
        np.random.default_rng(7).normal(0, 0.1, len(df_b)))
    y0 = {s: float(df_a[(df_a.organism == s) & (df_a.time == 0)]
                   .abundance.iloc[0]) for s in ("S", "V")}
    fws = {}
    for nm, df, scale in (("a", df_a, 1.0), ("b", df_b, 1.13)):
        fws[nm] = pkg.ModelFramework(
            ODE=zero_i, parameter_names=["mu", "phi", "beta"],
            state_names=["S", "V"], dataframe=df, t_steps=32,
            ode_style="jax", random_seed=0,
            **{p: pkg.parameter(stats_gen=dist(s=s, scale=sc),
                                hyperparameters={}, random_seed=i)
               for i, (p, (s, sc)) in enumerate(_PRI.items())},
            **{s: v * scale for s, v in y0.items()}, **kw)
    return fws


def _decay(t, y, ps):
    (k,) = ps
    return jnp.stack([-k * y[0]])


def _logistic(t, y, ps):
    k, cap = ps
    return jnp.stack([k * y[0] * (1.0 - y[0] / cap)])


def _hetero_pair(pkg, dist, **kw):
    """tests/test_joint.py's heterogeneous pair: decay (a) and logistic
    growth (b), different grids and observation counts, sharing k."""
    rng = np.random.default_rng(20)
    t_a = np.linspace(0.0, 3.0, 12)
    df_a = pd.DataFrame([{"organism": "y", "time": t,
                          "abundance": 1e6 * np.exp(-t + rng.normal(0, 0.15)),
                          "log_sigma": 0.15} for t in t_a])
    rng = np.random.default_rng(21)
    t_b = np.linspace(0.0, 4.0, 7)
    yb = 1e6 / (1 + (1e6 / 1e4 - 1) * np.exp(-t_b))
    df_b = pd.DataFrame([{"organism": "y", "time": t,
                          "abundance": v * np.exp(rng.normal(0, 0.1)),
                          "log_sigma": 0.1} for t, v in zip(t_b, yb)])
    k = lambda: pkg.parameter(stats_gen=dist(s=0.7, scale=1.0),  # noqa: E731
                              hyperparameters={}, random_seed=0)
    return {"a": pkg.ModelFramework(
                ODE=_decay, parameter_names=["k"], state_names=["y"],
                dataframe=df_a, t_steps=32, ode_style="jax", k=k(), **kw),
            "b": pkg.ModelFramework(
                ODE=_logistic, parameter_names=["k", "cap"],
                state_names=["y"], dataframe=df_b, t_steps=24,
                ode_style="jax", k=k(), cap=pkg.parameter(init_value=1e6),
                **kw)}


_PAIRS = {"zero_i-pair": (_zero_i_pair, ["phi", "beta"]),
          "heterogeneous": (_hetero_pair, ["k"])}
# where the parity chains start: near the fit, in joint column order
_CENTRES = {"zero_i-pair": [2.4e-8, 24.0, 0.6, 0.6],
            "heterogeneous": [1.0, 1e6]}


def _fits(name):
    make, shared = _PAIRS[name]
    ref = JJointFit(make(odelib_tpu, JLogNormal), shared=shared,
                    random_seed=3)
    got = JointFit(make(odelib_tpu_torch, LogNormal, device="cpu"),
                   shared=shared, random_seed=3)
    return ref, got


def _host_args(jf):
    fws = list(jf.frameworks.values())
    return ([fw._spec for fw in fws],
            [jf._idx_maps[nm] for nm in jf.frameworks],
            [fw._obsdata_fit_host for fw in fws],
            [np.asarray(fw._times_fit) for fw in fws],
            [np.asarray(fw.get_inits()) for fw in fws])


@pytest.mark.parametrize("name", sorted(_PAIRS))
def test_joint_twin_matches_pallas_interpret(name):
    ref_jf, jf = _fits(name)
    assert jf.columns == ref_jf.columns and jf._idx_maps == ref_jf._idx_maps
    rng = np.random.default_rng(5)
    th0 = (np.array(_CENTRES[name])
           * np.exp(rng.normal(0, 0.05, (128, jf.dim)))).astype(np.float32)
    mask = jf._walk_mask(["b:cap"] if name == "heterogeneous" else ())
    kw = dict(nits=13, burnin=2, walk_mask=mask, rwalk_std=0.05,
              substeps_list=[1, 1])
    ref = jax_joint_fused(*_host_args(ref_jf), th0, seed=4,
                          tile_chains=128, interpret=True, **kw)
    got = TJ.joint_metropolis_hastings_fused(*_host_args(jf),
                                             torch.as_tensor(th0), 4, **kw)
    assert got.theta.shape == (128, 10, jf.dim)
    assert got.chi_parts.shape == (128, 10, 2)
    np.testing.assert_array_equal(got.iteration.numpy(),
                                  np.asarray(ref.iteration))
    # the accept sequences: the running ratio is an exact function of them
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    assert 0 < float(got.acceptance_ratio[:, -1].mean()) < 1
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               rtol=1e-5)
    # chi and its parts: the MH parity tolerance 5e-5 where both packages'
    # theta agree bitwise (the interpret-mode reference's XLA:CPU arithmetic
    # moves chi by a few 1e-5 near the fit, tests/test_torch_survey.py).
    # Where accepted walks have left theta ulps apart (Box-Muller's and
    # exp's math libraries, as in the ensemble), chi is the score of a
    # slightly different theta: zero_i's exponential growth makes that up
    # to 1e-4.
    same = (got.theta.numpy() == np.asarray(ref.theta)).all(-1)
    assert same.mean() > 0.4
    parts, ref_parts = got.chi_parts.numpy(), np.asarray(ref.chi_parts)
    np.testing.assert_allclose(got.chi.numpy()[same],
                               np.asarray(ref.chi)[same], rtol=5e-5)
    np.testing.assert_allclose(parts[same], ref_parts[same], rtol=5e-5)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(ref.chi),
                               rtol=1e-4)
    np.testing.assert_allclose(parts, ref_parts, rtol=1e-4)
    # the total is the parts added in experiment order, in float32
    np.testing.assert_array_equal(got.chi.numpy(),
                                  parts[..., 0] + parts[..., 1])
    if name == "heterogeneous":     # the static slot never moves
        fixed = got.theta[:, :, 1].numpy()
        assert (fixed == fixed[:, :1]).all()
        np.testing.assert_allclose(fixed[:, 0], th0[:, 1], rtol=1e-6)


@pytest.mark.parametrize("name", sorted(_PAIRS))
def test_joint_survey_matches_jax(name):
    """joint_survey and JointFit.fit_survey in float64 against the JAX
    package's on the same draws (fixed dopri5, 4 substeps)."""
    ref_jf, jf = _fits(name)
    draws = jf.fit_survey(32)
    thetas = jf._thetas_from_df(draws)
    args = list(_host_args(jf))
    ref_args = ref_jf._device_args({})
    ref = np.asarray(jax_joint_survey(
        *ref_args[:5], jnp.asarray(thetas), method=ref_args[5],
        substeps_list=ref_args[6]))
    got = joint_survey(*args, torch.as_tensor(thetas), method="fixed_dopri5",
                       substeps_list=[4, 4]).numpy()
    assert got.dtype == np.float64 and np.isfinite(ref).mean() > 0.5
    # prior draws that blow the solve up give NaN on both sides
    np.testing.assert_allclose(got, ref, rtol=1e-9, equal_nan=True)
    np.testing.assert_allclose(draws["chi"].to_numpy(), ref, rtol=1e-9,
                               equal_nan=True)


def _report_numbers(text):
    body = text.split("Joint Fitting Report")[1]
    return np.array([float(v) for v in
                     re.findall(r"[-+]?\d\.\d{3}e[-+]\d+", body)])


def test_joint_mcmc_matches_odelib_tpu(monkeypatch, capsys):
    """JointFit.MCMC end to end on the zero_i pair: both packages score the
    port's LHS draws (the JAX package's LHS draws come from jax.random),
    seed the same chains and run their joint kernels."""
    ref_jf, jf = _fits("zero_i-pair")
    seen = {}
    orig = jf.fit_survey

    def capture(samples, **kw):
        out = orig(samples, **kw)
        seen["thetas"] = jf._thetas_from_df(out)
        return out
    monkeypatch.setattr(jf, "fit_survey", capture)
    got = jf.MCMC(chain_inits=6, iterations_per_chain=12, burnin=4,
                  fitsurvey_samples=48, substeps=1)
    report = capsys.readouterr().out

    dists = ref_jf._dists()
    draw_dims = [j for j, d in enumerate(dists) if d is not None]
    monkeypatch.setattr(jax_samplers, "sample_lhs",
                        lambda key, ds, n: seen["thetas"][:, draw_dims])
    ref = ref_jf.MCMC(chain_inits=6, iterations_per_chain=12, burnin=4,
                      fitsurvey_samples=48, backend="pallas",
                      pallas_interpret=True, pallas_tile_chains=128,
                      substeps=1)
    ref_report = capsys.readouterr().out
    assert list(got.columns) == list(ref.columns) == [
        "phi", "beta", "a:mu", "b:mu", "chi", "chi:a", "chi:b", "iteration",
        "acceptance_ratio", "chain#", "all_rejected"]
    assert len(got) == len(ref) == 6 * 7
    pd.testing.assert_index_equal(got.index, ref.index)
    for col in ref.columns:
        assert got[col].dtype == ref[col].dtype, col
    for col in ("iteration", "chain#", "all_rejected", "acceptance_ratio"):
        np.testing.assert_array_equal(got[col].to_numpy(),
                                      ref[col].to_numpy())
    for col in ("phi", "beta", "a:mu", "b:mu"):
        np.testing.assert_allclose(got[col], ref[col], rtol=1e-5, err_msg=col)
    for col in ("chi", "chi:a", "chi:b"):
        np.testing.assert_allclose(got[col], ref[col], rtol=5e-5, err_msg=col)
    a, b = _report_numbers(report), _report_numbers(ref_report)
    assert a.size == b.size == 2 * 4 + 3    # 4 x (median, std) + best chis
    np.testing.assert_allclose(a, b, rtol=1e-3)
    best = jf.set_best_params(got)
    assert jf.frameworks["a"].parameters["phi"].val == best["phi"]
    assert jf.frameworks["b"].parameters["mu"].val == best["b:mu"]


def test_joint_unported_options_raise():
    _, jf = _fits("zero_i-pair")
    for kw, item in ((dict(sampler="hmc"), "item 16"),
                     (dict(backend="xla"), "item 15"),
                     (dict(use_priors=True), "item 12"),
                     (dict(checkpoint_every=5), "item 11"),
                     (dict(until_rhat=1.1), "item 11")):
        with pytest.raises(NotImplementedError, match=item):
            jf.MCMC(chain_inits=4, iterations_per_chain=6,
                    fitsurvey_samples=16, print_report=False, **kw)
    fws = _zero_i_pair(odelib_tpu_torch, LogNormal, device="cpu")
    with pytest.raises(NotImplementedError, match="item 16"):
        JointFit(fws, shared=["phi"], hierarchical=["beta"])
    with pytest.raises(ValueError, match="lacks tied"):
        JointFit(fws, shared=["lam"])
