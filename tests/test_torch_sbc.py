"""Simulation-based calibration (odelib_tpu_torch/utils/sbc.py and
``ModelFramework.sbc``) against odelib_tpu's on the CPU (x64): on a small
decay model with priors that keep the synthetic rates below ~60, 8-12
replications of 21-31 iterations give the reference's prior draws (within
1e-14 relative: the priors' ``ppf`` of two libraries), validity flags,
ranks and acceptances bitwise, for lognormal data under rk4 and fixed
Dopri5, Student-t data (``random.t``), Poisson counts (``random.poisson``:
Knuth and the float32 rejection at these rates) and negative-binomial
counts (``random.gamma``); the report prints as the reference's, and
``rank_uniformity_pvalue`` is the reference's."""
import warnings

import numpy as np
import pandas as pd
import pytest
import scipy.stats

import odelib_tpu
import odelib_tpu_torch
from odelib_tpu.utils import sbc as rsbc
from odelib_tpu_torch.utils import sbc as tsbc


def decay(y, t, ps):
    return np.array([-ps[0] * y[0]])


def framework(pkg, obs_model="lognormal", obs_param=None, **kw):
    """N' = -k N from N0, observed at 8 times; priors on k and N0."""
    rng = np.random.default_rng(3)
    ts = np.linspace(0.5, 4.0, 8)
    ab = 50.0 * np.exp(-0.5 * ts)
    ab = rng.poisson(ab).astype(float) + 1.0 if obs_model in (
        "poisson", "negbinom") else ab * np.exp(rng.normal(0, 0.2, 8))
    df = pd.DataFrame({"organism": "N", "time": ts, "abundance": ab,
                       "log_sigma": 0.2})
    return pkg.ModelFramework(
        ODE=decay, parameter_names=["k", "N0"], state_names=["N"],
        dataframe=df, t_steps=29, random_seed=4, obs_model=obs_model,
        obs_param=obs_param,
        k=pkg.parameter(scipy.stats.lognorm, {"s": 0.3, "scale": 0.5}),
        N0=pkg.parameter(scipy.stats.lognorm, {"s": 0.15, "scale": 50.0}),
        **kw)


CASES = {
    "lognormal-rk4": (dict(), dict(method="rk4", substeps=2), 12, 31),
    "lognormal-dopri5": (dict(), dict(substeps=2), 8, 21),
    "student_t": (dict(obs_model="student_t", obs_param=4.0),
                  dict(method="rk4", substeps=2), 10, 21),
    "poisson": (dict(obs_model="poisson"), dict(method="rk4", substeps=2),
                10, 21),
    "negbinom": (dict(obs_model="negbinom", obs_param=5.0),
                 dict(method="rk4", substeps=2), 8, 21),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sbc_ranks_match_reference(case):
    fkw, skw, reps, nits = CASES[case]
    ref_fw = framework(odelib_tpu, **fkw)
    fw = framework(odelib_tpu_torch, device="cpu", **fkw)
    kw = dict(reps=reps, nits=nits, burnin=nits // 2, thin=2, seed=4,
              method="rk4" if skw.get("method") == "rk4" else "fixed_dopri5",
              substeps=skw["substeps"])
    ref = rsbc.sbc_ranks(
        ref_fw._spec, ref_fw._obsdata_fit, ref_fw._times_fit,
        ref_fw.get_inits(), tuple(ref_fw.parameters[p].jdist
                                  for p in ("k", "N0")),
        ref_fw._current_theta(), **kw)
    got = tsbc.sbc_ranks(
        fw._spec, fw._obsdata_fit_host, fw._times_fit, fw.get_inits(),
        tuple(fw.parameters[p].tdist for p in ("k", "N0")),
        fw._current_theta(), device="cpu", **kw)
    np.testing.assert_allclose(got.theta_star, np.asarray(ref.theta_star),
                               rtol=1e-14)
    np.testing.assert_array_equal(got.valid, np.asarray(ref.valid))
    assert got.valid.sum() >= reps // 2
    np.testing.assert_array_equal(got.ranks, np.asarray(ref.ranks))
    np.testing.assert_array_equal(got.acceptance,
                                  np.asarray(ref.acceptance))
    assert got.n_draws == ref.n_draws == (nits - 1 - nits // 2 + 1) // 2
    assert got.ranks.dtype == np.int32


def test_sbc_method_matches_reference(capsys):
    """ModelFramework.sbc with a static parameter: the result dict, and the
    printed report."""
    ref_fw = framework(odelib_tpu)
    fw = framework(odelib_tpu_torch, device="cpu")
    kw = dict(reps=8, iterations_per_chain=21, thin=2, bins=4,
              static_parameters=["N0"], method="rk4", substeps=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = ref_fw.sbc(**kw)
        ref_out = capsys.readouterr().out
        got = fw.sbc(**kw)
    assert capsys.readouterr().out == ref_out
    assert "SBC Report" in ref_out
    assert list(got) == list(ref)
    assert list(got["ranks"].columns) == ["k"]
    np.testing.assert_array_equal(got["ranks"].to_numpy(),
                                  ref["ranks"].to_numpy())
    for k in ("n_draws", "n_valid", "reps", "calibrated",
              "mean_acceptance", "pvalues"):
        assert got[k] == ref[k], k


def test_sbc_refuses_as_reference():
    fw = framework(odelib_tpu_torch, device="cpu")
    with pytest.raises(ValueError, match="at least one parameter"):
        fw.sbc(reps=2, iterations_per_chain=5,
               static_parameters=["k", "N0"])
    with pytest.raises(ValueError, match="leaves no recorded"):
        tsbc.sbc_ranks(fw._spec, fw._obsdata_fit_host, fw._times_fit,
                       fw.get_inits(), (None, None), [0.5, 50.0], nits=5,
                       burnin=4, device="cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_rank_uniformity_pvalue_matches_reference(seed):
    rng = np.random.default_rng(seed)
    ranks = rng.integers(-1, 51, 300)
    for bins in (4, 16, 20, 80):
        assert tsbc.rank_uniformity_pvalue(ranks, 50, bins) == \
            rsbc.rank_uniformity_pvalue(ranks, 50, bins)
    assert np.isnan(tsbc.rank_uniformity_pvalue(np.full(5, -1), 50))
