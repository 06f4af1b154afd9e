"""The model-criticism methods through the user API against odelib_tpu's
on the CPU (x64), from posterior frames drawn with numpy around the fit:
``information_criteria`` (elpd, p and khat within 1e-8, ``n_bad_khat``
equal) under the lognormal, Student-t, Poisson and negative-binomial
observation models; ``posterior_predictive`` (its ``samples`` within
1e-8, ``coverage`` and the summary equal) on those and on an SDE model's
stochastic branch (one Euler path a draw, draw i keyed
``fold_in(PRNGKey(random_seed), i)``); ``prior_predictive`` with the
reference's LHS frame handed to the port (the two packages' LHS differ on
purpose); ``diagnostics`` (``summarize``) within 1e-10; and ``JointFit``'s
``posterior_predictive``, ``information_criteria`` and ``diagnostics``."""
import warnings

import numpy as np
import pandas as pd
import pytest
import scipy.stats

import odelib_tpu
import odelib_tpu_torch
from odelib_tpu.utils.diagnostics import summarize as ref_summarize
from odelib_tpu_torch.utils import summarize

from test_torch_hmc_api import both
from test_torch_joint import _fits
from test_torch_sbc import framework as decay_framework

RTOL = 1e-8


def frame(centre, n=240, sd=0.05, seed=0, chains=6):
    """A posterior frame around ``centre`` ({name: value}) with chi and
    ``chain#`` columns."""
    rng = np.random.default_rng(seed)
    post = pd.DataFrame({p: v * np.exp(sd * rng.normal(size=n))
                         for p, v in centre.items()})
    post["chi"] = rng.uniform(10.0, 20.0, n)
    post["chain#"] = np.repeat(np.arange(chains), -(-n // chains))[:n]
    return post


def assert_ic_equal(got, ref):
    assert list(got) == list(ref)
    for k in ("waic", "loo"):
        assert list(got[k]) == list(ref[k])
        for f, v in ref[k].items():
            if f == "n_bad_khat":
                assert got[k][f] == v
            else:
                np.testing.assert_allclose(got[k][f], v, rtol=RTOL,
                                           err_msg=f"{k} {f}")
    assert (got["n_draws"], got["n_obs"]) == (ref["n_draws"], ref["n_obs"])


def assert_pp_equal(got, ref):
    np.testing.assert_allclose(got["samples"], ref["samples"], rtol=RTOL)
    assert got["coverage"] == ref["coverage"]
    a, b = got["summary"], ref["summary"]
    assert list(a.columns) == list(b.columns)
    for c in b.columns:
        if not pd.api.types.is_float_dtype(b[c]):
            np.testing.assert_array_equal(a[c].to_numpy(), b[c].to_numpy())
        else:
            np.testing.assert_allclose(a[c].to_numpy(float),
                                       b[c].to_numpy(float), rtol=RTOL,
                                       err_msg=c)


OBS = {"lognormal": {}, "student_t": dict(obs_model="student_t",
                                          obs_param=4.0),
       "poisson": dict(obs_model="poisson"),
       "negbinom": dict(obs_model="negbinom", obs_param=5.0)}


@pytest.mark.parametrize("model", list(OBS))
def test_information_criteria_and_predictive_match_reference(model, capsys):
    """The decay model of tests/test_torch_sbc.py on each observation
    model, 64 of 240 rows drawn, the reports printed as the reference's."""
    ref_fw = decay_framework(odelib_tpu, **OBS[model])
    fw = decay_framework(odelib_tpu_torch, device="cpu", **OBS[model])
    post = frame({"k": 0.5, "N0": 50.0}, sd=0.1)
    ref = ref_fw.information_criteria(post, n_draws=64)
    ref_out = capsys.readouterr().out
    got = fw.information_criteria(post, n_draws=64)
    assert capsys.readouterr().out == ref_out
    assert_ic_equal(got, ref)
    assert len(got["loo"]["khat"]) == got["n_obs"] == 8
    ref = ref_fw.posterior_predictive(post, n_draws=50, ci=0.8)
    ref_out = capsys.readouterr().out
    got = fw.posterior_predictive(post, n_draws=50, ci=0.8)
    assert capsys.readouterr().out == ref_out
    assert_pp_equal(got, ref)
    assert got["samples"].shape == (50, 8)


def test_zero_i_criteria_and_predictive_match_reference():
    """zero_i on the demo (adaptive Dopri5), a frame with a NaN row that
    drops out, then rk4 with substeps 2."""
    ref_fw, fw = both()
    post = frame({"mu": 0.6, "phi": 2.4e-8, "beta": 24.0}, sd=0.03)
    post.loc[3, "mu"] = np.nan
    for kw in ({}, dict(method="rk4", substeps=2)):
        assert_ic_equal(fw.information_criteria(post, n_draws=60,
                                                print_report=False, **kw),
                        ref_fw.information_criteria(post, n_draws=60,
                                                    print_report=False,
                                                    **kw))
        assert_pp_equal(fw.posterior_predictive(post, print_report=False,
                                                **kw),
                        ref_fw.posterior_predictive(post,
                                                    print_report=False,
                                                    **kw))


def test_prior_predictive_with_the_reference_lhs(capsys):
    """The default adaptive solve, its steps capped (prior draws fail and
    run to the cap)."""
    ref_fw, fw = both()
    fw._lhs_samples = ref_fw._lhs_samples
    kw = dict(samples=40, ci=0.95, max_steps=256)
    ref = ref_fw.prior_predictive(**kw)
    ref_out = capsys.readouterr().out
    got = fw.prior_predictive(**kw)
    assert capsys.readouterr().out == ref_out
    assert "prior predictive" in ref_out
    assert_pp_equal(got, ref)


def _sde(pkg, **kw):
    """tests/test_torch_sde.py's GBM with its diffusion scale r, s."""
    def gbm(y, t, ps):
        return np.array([ps[0] * y[0]])

    def gnoise(y, t, ps):
        return np.array([ps[1] * y[0]])

    rng = np.random.default_rng(0)
    ts = np.linspace(0.0, 2.0, 9)[1:]
    ab = 10.0 * np.exp(0.455 * ts + 0.3 * np.sqrt(ts)
                       * rng.normal(size=ts.size))
    df = pd.DataFrame({"organism": "X", "time": ts, "abundance": ab,
                       "log_sigma": 0.2})
    return pkg.ModelFramework(
        ODE=gbm, diffusion=gnoise, parameter_names=["r", "s"],
        state_names=["X"], dataframe=df, t_steps=48, random_seed=1,
        r=pkg.parameter(scipy.stats.lognorm, {"s": 0.5, "scale": 0.5}),
        s=pkg.parameter(scipy.stats.lognorm, {"s": 0.5, "scale": 0.3}),
        X=10.0, **kw)


def test_sde_predictive_branch_matches_reference():
    """posterior_predictive replicates along one SDE path a draw (substeps
    3); information_criteria warns and scores the drift."""
    ref_fw, fw = _sde(odelib_tpu), _sde(odelib_tpu_torch, device="cpu")
    post = frame({"r": 0.5, "s": 0.3}, n=90, sd=0.1)
    kw = dict(n_draws=30, print_report=False, substeps=3)
    assert_pp_equal(fw.posterior_predictive(post, **kw),
                    ref_fw.posterior_predictive(post, **kw))
    with pytest.warns(UserWarning, match="drift-only"):
        got = fw.information_criteria(post, n_draws=30, print_report=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = ref_fw.information_criteria(post, n_draws=30,
                                          print_report=False)
    assert_ic_equal(got, ref)


def test_diagnostics_summarize_matches_reference():
    """Chains of unequal length, a NaN, a constant column, an array column
    (skipped) and a single chain."""
    rng = np.random.default_rng(3)
    n = 150
    post = pd.DataFrame({"a": rng.normal(size=n).cumsum(),
                         "b": rng.gamma(2.0, size=n), "c": np.ones(n),
                         "chain#": np.r_[np.zeros(70), np.ones(80)]})
    post.loc[5, "b"] = np.nan
    post["v"] = list(rng.normal(size=(n, 2)))
    for cols in (["a", "b", "c", "v"], ["a"]):
        got, ref = summarize(post, cols), ref_summarize(post, cols)
        assert list(got.index) == list(ref.index)
        assert list(got.columns) == list(ref.columns)
        np.testing.assert_allclose(got.to_numpy(float), ref.to_numpy(float),
                                   rtol=1e-10, atol=1e-12)
    one = post[post["chain#"] == 0]
    np.testing.assert_allclose(summarize(one, ["a"]).to_numpy(float),
                               ref_summarize(one, ["a"]).to_numpy(float),
                               rtol=1e-10)
    ref_fw, fw = both()
    post = frame({"mu": 0.6, "phi": 2.4e-8, "beta": 24.0})
    pd.testing.assert_frame_equal(fw.diagnostics(post),
                                  ref_fw.diagnostics(post), rtol=1e-10)
    with pytest.raises(ValueError, match="chain#"):
        summarize(post.drop(columns="chain#"), ["mu"])


def test_joint_criticism_matches_reference(capsys):
    """The zero_i pair sharing phi and beta: per-experiment results and the
    pooled totals, the reports printed as the reference's."""
    ref_j, got_j = _fits("zero_i-pair")
    post = frame(dict(zip(ref_j.columns, (2.4e-8, 24.0, 0.6, 0.6))),
                 sd=0.03)
    kw = dict(method="rk4", substeps=2)
    ref = ref_j.information_criteria(post, n_draws=40, **kw)
    ref_out = capsys.readouterr().out
    got = got_j.information_criteria(post, n_draws=40, **kw)
    assert capsys.readouterr().out == ref_out
    assert list(got) == list(ref) == ["a", "b", "overall"]
    for nm in ("a", "b"):
        assert_ic_equal(got[nm], ref[nm])
    assert got["overall"]["n_bad_khat"] == ref["overall"]["n_bad_khat"]
    np.testing.assert_allclose(
        [v for k, v in got["overall"].items() if k != "n_bad_khat"],
        [v for k, v in ref["overall"].items() if k != "n_bad_khat"],
        rtol=RTOL)
    ref = ref_j.posterior_predictive(post, n_draws=30, **kw)
    ref_out = capsys.readouterr().out
    got = got_j.posterior_predictive(post, n_draws=30, **kw)
    assert capsys.readouterr().out == ref_out
    for nm in ("a", "b"):
        assert_pp_equal(got[nm], ref[nm])
    assert got["overall"] == ref["overall"]
    pd.testing.assert_frame_equal(got_j.diagnostics(post),
                                  ref_j.diagnostics(post), rtol=1e-10)
