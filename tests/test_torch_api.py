"""The whole slice: ``ModelFramework(...).MCMC(sampler='mh')`` in the port
against odelib_tpu's fused backend in interpret mode — posterior
DataFrames column by column and the Fitting Report — plus the LHS seeding
path of the port, its survey held against the JAX kernel."""
import re

import numpy as np
import pandas as pd
import pytest
import scipy.stats
import torch

import odelib_tpu
import odelib_tpu_torch
from odelib_tpu.ops.pallas_mh import survey_fused as jax_survey_fused
from odelib_tpu_torch import dispatch as t_dispatch
from odelib_tpu_torch.ops import cuda_mh

from helpers import demo_df, zero_i

_INITS = [dict(mu=0.62, phi=2.3e-8, beta=25.0),
          dict(mu=0.55, phi=2.6e-8, beta=22.0),
          dict(mu=0.7, phi=2.0e-8, beta=30.0),
          dict(mu=0.6, phi=2.4e-8, beta=24.0)]


def _framework(pkg, **kw):
    return pkg.ModelFramework(
        ODE=zero_i, parameter_names=["mu", "phi", "beta"],
        state_names=["S", "V"], dataframe=demo_df(),
        mu=pkg.parameter(scipy.stats.lognorm, {"s": 3, "scale": 1e-8}),
        phi=pkg.parameter(scipy.stats.lognorm, {"s": 3, "scale": 1e-8}),
        beta=pkg.parameter(scipy.stats.lognorm, {"s": 1, "scale": 25}),
        t_steps=288, substeps=1, **kw)


def _report_numbers(text):
    body = text.split("Fitting Report")[1]
    return np.array([float(v) for v in
                     re.findall(r"[-+]?\d\.\d{3}e[-+]\d+", body)])


def test_mcmc_slice_matches_odelib_tpu(capsys):
    ref_fw = _framework(odelib_tpu)
    ref = ref_fw.MCMC(chain_inits=_INITS, iterations_per_chain=24,
                      burnin=12, backend="pallas", pallas_interpret=True,
                      pallas_tile_chains=128, print_report=True)
    ref_report = capsys.readouterr().out
    fw = _framework(odelib_tpu_torch, device="cpu")
    got = fw.MCMC(chain_inits=_INITS, iterations_per_chain=24, burnin=12,
                  print_report=True)
    report = capsys.readouterr().out
    assert list(got.columns) == list(ref.columns) == [
        "mu", "phi", "beta", "chi", "rsquared", "aic", "iteration",
        "acceptance_ratio", "chain#", "all_rejected"]
    assert len(got) == len(ref) == 4 * 11
    pd.testing.assert_index_equal(got.index, ref.index)
    for col in ref.columns:
        assert got[col].dtype == ref[col].dtype, col
    for col in ("iteration", "chain#", "all_rejected", "acceptance_ratio"):
        np.testing.assert_array_equal(got[col].to_numpy(),
                                      ref[col].to_numpy())
    # measured max relative difference 4.7e-6 (rsquared), 3.6e-6 (chi)
    for col in ("mu", "phi", "beta", "chi", "rsquared", "aic"):
        np.testing.assert_allclose(got[col].to_numpy(), ref[col].to_numpy(),
                                   rtol=1e-5, err_msg=col)
    assert "Fitting Report" in report
    a, b = _report_numbers(report), _report_numbers(ref_report)
    assert a.size == b.size == 9      # 3 x (median, std) + chi, R^2, AIC
    # printed at 4 significant digits: agreement to the last digit
    np.testing.assert_allclose(a, b, rtol=1e-3)
    fs, ref_fs = fw.get_fitstats(), ref_fw.get_fitstats()
    for key in ("Chi", "R^2", "AIC"):
        np.testing.assert_allclose(fs[key], ref_fs[key], rtol=1e-5)


def test_lhs_seeding_path(monkeypatch):
    """chain_inits=4 with the LHS prescreen: the port's survey chi equals
    the JAX kernel's on the port's own draws, and every seed passes the
    sd_fitdistance chi cut."""
    fw = _framework(odelib_tpu_torch, device="cpu")
    seen = {}

    def capture(fw_, theta0, cfg):
        seen["theta0"] = np.asarray(theta0)
        return t_dispatch.run_fused_mh(fw_, theta0, cfg)

    monkeypatch.setitem(t_dispatch._ARMS, "cpu:mh", capture)
    post = fw.MCMC(chain_inits=4, iterations_per_chain=10, burnin=4,
                   fitsurvey_samples=64, sd_fitdistance=6.0,
                   print_report=False)
    assert post["chain#"].nunique() == 4 and np.isfinite(post.chi).all()

    draws = fw._lhs_samples(64)
    thetas = fw._theta_from_df(draws).astype(np.float32)
    got = cuda_mh.survey_fused(fw._spec, fw._obsdata_fit_host, fw._times_fit,
                               fw.get_inits(), thetas, substeps=1).numpy()
    ref = np.asarray(jax_survey_fused(
        _framework(odelib_tpu)._spec, fw._obsdata_fit_host, fw._times_fit,
        fw.get_inits(), thetas, substeps=1, tile_chains=128,
        interpret=True))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    ok = np.isfinite(ref)
    # prior draws at substeps=1: the interpret-mode reference's XLA:CPU
    # arithmetic moves chi by up to a few 1e-5 near the fit (the witnesses
    # in tests/test_torch_survey.py trace the gap to it)
    np.testing.assert_allclose(got[ok], ref[ok], rtol=5e-5)

    calc = {s: np.exp(fw._obs_logabundance[s]
                      + 6.0 * fw._obs_logsigma[s])
            for s in fw._obs_logabundance}
    cut = fw.get_chi(calc)
    seeds = seen["theta0"].astype(np.float32)
    seed_chi = cuda_mh.survey_fused(fw._spec, fw._obsdata_fit_host,
                                    fw._times_fit, fw.get_inits(), seeds,
                                    substeps=1).numpy()
    assert (seed_chi < cut).all()
    # the seeds are prescreen draws
    assert all((np.abs(thetas - s).max(axis=1) == 0).any() for s in seeds)


def test_unported_options_raise():
    fw = _framework(odelib_tpu_torch, device="cpu")
    for kw, item in ((dict(sampler="hmc"), "item 16"),
                     (dict(use_priors=True), "item 12"),
                     (dict(checkpoint_every=5), "item 11"),
                     (dict(until_rhat=1.1), "item 11"),
                     (dict(backend="xla"), "item 8"),
                     (dict(method="auto"), "item 8"),
                     (dict(method="kvaerno5"), "item 8"),
                     (dict(method="kvaerno3"), "item 14"),
                     (dict(sampler="pt", temperatures="auto"), "item 15"),
                     (dict(sampler="pt", use_priors=True), "item 12"),
                     (dict(sampler="ensemble", use_priors=True), "item 12"),
                     (dict(sampler="pt", backend="xla"), "item 15"),
                     # fewer walkers than a tile: the reference's XLA
                     # ensemble under backend='auto'
                     (dict(sampler="ensemble"), "item 15"),
                     (dict(sampler="ensemble", pallas_tile_chains=256),
                      "item 15")):
        with pytest.raises(NotImplementedError, match=item):
            fw.MCMC(chain_inits=_INITS, iterations_per_chain=6,
                    print_report=False, **kw)
    with pytest.raises(ValueError, match="ladder tuple"):
        fw.MCMC(chain_inits=_INITS, iterations_per_chain=6, sampler="pt",
                temperatures="hot", print_report=False)


def test_pallas_backend_warns_for_adaptive_method():
    """As in odelib_tpu, backend='pallas' runs the fixed-step kernel for
    an adaptive method and warns that the method is not honoured."""
    fw = _framework(odelib_tpu_torch, device="cpu")
    with pytest.warns(UserWarning, match="not honored"):
        post = fw.MCMC(chain_inits=_INITS[:2], iterations_per_chain=6,
                       burnin=2, backend="pallas", method="kvaerno5",
                       print_report=False)
    assert post["chain#"].nunique() == 2


def test_framework_defaults_and_lhs():
    fw = _framework(odelib_tpu_torch)
    expect = "cuda" if torch.cuda.is_available() else "cpu"
    assert fw.device.type == expect
    a, b = fw._lhs_samples(32), fw._lhs_samples(32)
    pd.testing.assert_frame_equal(a, b)     # seeded from random_seed
    assert list(a.columns) == ["mu", "phi", "beta"] and (a > 0).all().all()


@pytest.mark.parametrize("solver", [{}, {"method": "rk4", "substeps": 2}])
def test_fit_survey_matches_odelib_tpu(solver):
    """fit_survey: the port's LHS draws scored in one batched float64
    solve (adaptive Dopri5 by default, or the configured fixed steps)
    against odelib_tpu's fit_survey on the same draws."""
    fw = _framework(odelib_tpu_torch, device="cpu")
    ref_fw = _framework(odelib_tpu)
    draws = fw._lhs_samples(40)
    ref_fw._lhs_samples = lambda samples: draws
    got, ref = fw.fit_survey(40, **solver), ref_fw.fit_survey(40, **solver)
    assert list(got.columns) == list(ref.columns) == ["mu", "phi", "beta",
                                                      "chi"]
    assert got["chi"].dtype == np.float64
    pd.testing.assert_frame_equal(got.drop(columns="chi"),
                                  ref.drop(columns="chi"))
    assert np.isfinite(ref["chi"]).sum() > 20
    np.testing.assert_allclose(got["chi"], ref["chi"], rtol=1e-9,
                               equal_nan=True)


def test_priors_and_diffusion_options():
    """use_priors=True is ported for sampler='pmmh' only; a model without
    diffusion= cannot run it, nor can a JointFit with such a member."""
    fw = _framework(odelib_tpu_torch, device="cpu")
    with pytest.raises(ValueError, match="diffusion"):
        fw.MCMC(chain_inits=_INITS, iterations_per_chain=6, sampler="pmmh",
                print_report=False)
    for sampler in ("mh", "ensemble", "pt"):
        with pytest.raises(NotImplementedError, match="item 12"):
            fw.MCMC(chain_inits=_INITS, iterations_per_chain=6,
                    sampler=sampler, use_priors=True, backend="pallas",
                    print_report=False)
    sde = _framework(odelib_tpu_torch, device="cpu",
                     diffusion=lambda t, y, ps: [0.1 * y[0], 0.1 * y[1]])
    jf = odelib_tpu_torch.JointFit([sde, fw], shared=["phi"])
    with pytest.raises(NotImplementedError, match="joint PMMH"):
        jf.MCMC(chain_inits=4, iterations_per_chain=6, fitsurvey_samples=8)
