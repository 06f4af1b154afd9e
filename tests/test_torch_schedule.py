"""substeps='auto': the port's schedule calibration (ops/schedule.py)
against odelib_tpu's on the same draws, in float64, and its flow through
ModelFramework.MCMC (the calibrated schedule cached and reused)."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odelib_tpu
import odelib_tpu_torch
from odelib_tpu.ops import schedule as JS
from odelib_tpu_torch.ops import cuda_mh
from odelib_tpu_torch.ops import schedule as S

from test_torch_api import _INITS, _framework


@pytest.fixture(scope="module")
def demo():
    """zero_i on the demo data: both packages' frameworks (the compact fit
    grid, y0) and a seeded cloud of 64 draws around the fit."""
    ref_fw = _framework(odelib_tpu)
    fw = _framework(odelib_tpu_torch, device="cpu")
    rng = np.random.default_rng(0)
    cloud = np.array([0.6, 2.4e-8, 24.0]) * np.exp(rng.normal(0, 0.3,
                                                              (64, 3)))
    return ref_fw, fw, cloud


@pytest.mark.parametrize("quantile,max_draws", [(0.9, 256), (0.5, 40)])
def test_calibrate_substeps_matches_odelib_tpu(demo, quantile, max_draws):
    """The same schedule, entry by entry, as odelib_tpu's calibration on
    the same 64 draws (and on a strided 40 of them): the adaptive solves'
    accepted-step counts are the JAX package's (tests/
    test_torch_integrate.py), and so are the striding, quantile, ceil and
    clip."""
    ref_fw, fw, cloud = demo
    kw = dict(rtol=1e-6, atol=1e-4, quantile=quantile, max_draws=max_draws)
    ref = JS.calibrate_substeps(ref_fw._spec, ref_fw.get_inits(),
                                ref_fw._times_fit, cloud, **kw)
    got = S.calibrate_substeps(fw._spec, fw.get_inits(), fw._times_fit,
                               cloud, **kw)
    assert isinstance(got, tuple) and len(got) == len(fw._times_fit) - 1
    assert got == ref
    assert all(isinstance(v, int) and 1 <= v <= 64 for v in got)


def test_schedule_cost():
    assert S.schedule_cost((3, 4, 1)) == 8
    assert S.schedule_cost(np.array([2] * 17)) == 34 == \
        JS.schedule_cost([2] * 17)


def test_calibrate_substeps_falls_back_when_nothing_integrates(demo):
    """No draw integrates (max_steps far too small): a uniform 4 with the
    reference's warning, clipped to [min_substeps, max_substeps]."""
    _, fw, cloud = demo
    n = len(fw._times_fit) - 1
    with pytest.warns(UserWarning, match="no draw integrated cleanly"):
        got = S.calibrate_substeps(fw._spec, fw.get_inits(), fw._times_fit,
                                   cloud[:4], max_steps=2)
    assert got == (4,) * n
    with pytest.warns(UserWarning, match="uniform schedule of 4"):
        got = S.calibrate_substeps(fw._spec, fw.get_inits(), fw._times_fit,
                                   cloud[:4], max_steps=2, max_substeps=3)
    assert got == (3,) * n


def test_calibrate_substeps_fn_matches_odelib_tpu():
    """The generic-RHS calibration on a logistic family with per-lane
    rates, against the JAX package's vmapped one: with dopri5, and with
    its default method, Kvaerno5 (the forward-mode Jacobian columns of
    the plain RHS)."""
    times = np.linspace(0.0, 6.0, 9)
    rates = np.linspace(0.5, 4.0, 12)

    def jfunc(t, y, k):
        return k * y * (1.0 - y)

    def tfunc(t, y, k):
        return k * y * (1.0 - y)
    kw = dict(rtol=1e-6, atol=1e-9, method="dopri5")
    ref = JS.calibrate_substeps_fn(jfunc, jnp.array([0.01]),
                                   jnp.asarray(times), jnp.asarray(rates),
                                   **kw)
    got = S.calibrate_substeps_fn(tfunc, [0.01], times,
                                  torch.as_tensor(rates), **kw)
    assert got == ref and len(got) == 8 and max(got) > min(got)
    ref = JS.calibrate_substeps_fn(jfunc, jnp.array([0.01]),
                                   jnp.asarray(times), jnp.asarray(rates))
    got = S.calibrate_substeps_fn(tfunc, [0.01], times,
                                  torch.as_tensor(rates))
    assert got == ref and len(got) == 8


def test_mcmc_auto_substeps_calibrates_and_caches(demo, monkeypatch):
    """MCMC(substeps='auto'): the prescreen runs on 4 at the first call,
    the chains on the schedule calibrated from the run's own seeds (equal
    to odelib_tpu's calibration of those seeds), cached as _auto_schedule;
    a second run's prescreen and a fixed-step fit_survey use the cache."""
    ref_fw, _, _ = demo
    fw = _framework(odelib_tpu_torch, device="cpu")
    fw._solver["substeps"] = "auto"
    seen = []
    sv, mh = cuda_mh.survey_fused, cuda_mh.metropolis_hastings_fused

    def survey(*a, **k):
        seen.append(("survey", k["substeps"]))
        return sv(*a, **k)

    def chains(*a, **k):
        seen.append(("chains", k["substeps"], np.asarray(a[4])))
        return mh(*a, **k)
    monkeypatch.setattr(cuda_mh, "survey_fused", survey)
    monkeypatch.setattr(cuda_mh, "metropolis_hastings_fused", chains)
    kw = dict(chain_inits=4, iterations_per_chain=6, burnin=2,
              fitsurvey_samples=32, sd_fitdistance=6.0, print_report=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fw.MCMC(**kw)
    (_, first), (_, sched, theta0) = seen[:2]
    assert first == 4
    n = len(fw._times_fit) - 1
    assert isinstance(sched, tuple) and len(sched) == n
    assert fw._auto_schedule == sched
    assert sched == JS.calibrate_substeps(
        ref_fw._spec, ref_fw.get_inits(), ref_fw._times_fit,
        theta0.astype(np.float64), rtol=1e-6, atol=1e-4, max_steps=4096)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fw.MCMC(**kw)
    assert seen[2] == ("survey", sched)
    # the resolution: the cached schedule where its length fits the grid,
    # else the uniform 4
    assert fw._solver_args({"method": "rk4"}, n)[4] == sched
    assert fw._solver_args({}, n + 1)[4] == 4
    got = fw.fit_survey(16, method="rk4")
    want = fw.fit_survey(16, method="rk4", substeps=sched)
    np.testing.assert_array_equal(got["chi"], want["chi"])
    with pytest.raises(ValueError, match="'auto'"):
        fw.MCMC(substeps="fast", **kw)


def test_calibrated_schedule_keeps_the_adaptive_solves_chi(demo):
    """The JAX package's accuracy gate (tests/test_accuracy_gate.py) on a
    calibrated schedule: chi from the schedule's fixed Dopri5 steps on the
    compact grid against the adaptive solve (rtol 1e-6, atol 1e-2) on the
    full grid, in float64, within 1e-4 where chi < 500. The draws are
    what MCMC calibrates on: the prescreen's best, here the 113 of 256
    under chi 1000 (measured max 2.9e-6 on 50 near-fit draws, 2.4e-6 at
    substeps=4; the schedule takes 20 steps a solve)."""
    from odelib_tpu_torch.data import build_obsdata_host
    from odelib_tpu_torch.model import chi_of_theta
    _, fw, _ = demo
    survey = fw.fit_survey(256)
    cloud = fw._theta_from_df(survey[survey.chi < 1000.0])
    sched = S.calibrate_substeps(fw._spec, fw.get_inits(), fw._times_fit,
                                 cloud)
    assert S.schedule_cost(sched) < 4 * len(sched)
    th = torch.as_tensor(cloud, dtype=torch.float64)
    obs_full, _ = build_obsdata_host(fw.df, fw.times, fw._spec.post_snames)
    oracle = chi_of_theta(fw._spec, obs_full, th, fw.get_inits(), fw.times,
                          method="dopri5", rtol=1e-6, atol=1e-2,
                          max_steps=32768).numpy()
    fixed = chi_of_theta(fw._spec, fw._obsdata_fit_host, th, fw.get_inits(),
                         fw._times_fit, method="fixed_dopri5",
                         substeps=sched).numpy()
    near = np.isfinite(oracle) & np.isfinite(fixed) & (oracle < 500.0)
    assert near.sum() >= 40
    rel = np.abs(fixed - oracle) / np.maximum(np.abs(oracle), 1.0)
    assert rel[near].max() < 1e-4
