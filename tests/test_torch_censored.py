"""Censored observations (detection limits): the port's column parsing,
ObsData threading and R^2 masking against ``odelib_tpu``'s; its Tobit
terms against float64 (and the JAX kernel's approximate log Phi, from
which it deliberately departs); the survey twin on left- and
right-censored data against the XLA survey; the MH twin on censored
Student-t data against the JAX kernel; and the routing of censored counts,
which the reference scores only on its XLA samplers."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.special as sp
import scipy.stats as ss
import torch

import odelib_tpu
import odelib_tpu_torch
from odelib_tpu import data as jdata
from odelib_tpu.ops import pallas_mh as J
from odelib_tpu_torch import data as tdata
from odelib_tpu_torch.joint import JointFit
from odelib_tpu_torch.ops import cuda_mh as T

from test_torch_obs_models import (THIN, assert_same_chains, draws,
                                   fam_case, run_mh, xla_survey)
from scoring_cases import demo_frame


def test_parse_censor_column_matches_odelib_tpu():
    col = [True, False, 1, 2, 0, "left", "right", "none", "", "LOD", None,
           np.nan, "Above", np.int64(2)]
    np.testing.assert_array_equal(tdata.parse_censor_column(col),
                                  jdata.parse_censor_column(col))
    for bad, msg in ((["sideways"], "unknown censoring label"),
                     ([3], "censoring flag")):
        with pytest.raises(ValueError, match=msg):
            tdata.parse_censor_column(bad)


def test_replicate_schema_with_censoring_raises():
    df = pd.DataFrame({"organism": "A", "time": [1.0, 1.0],
                       "abundance": [2.0, 3.0], "replicate": [1, 2],
                       "censored": [True, False]})
    with pytest.raises(ValueError, match="replicate"):
        tdata.format_dataframe(df, ("A",))


@pytest.mark.parametrize("censor", [("left",), ("left", "right"), "none",
                                    "all-exact"])
def test_build_obsdata_threads_censor_and_masks_sstot(censor):
    """The flags in observation order and sstot over the exact points
    only, field for field as odelib_tpu builds them; no column, or one
    that censors nothing, gives censor None."""
    df = demo_frame("lognormal", censor if isinstance(censor, tuple)
                    else ("left",))
    if censor == "none":
        df = df.drop(columns="censored")
    elif censor == "all-exact":
        df["censored"] = False
    times = np.linspace(0, 3.0, 288)
    got, obs_t = tdata.build_obsdata_host(
        tdata.format_dataframe(df, ("S", "V")), times, ("S", "V"))
    ref, obs_j = jdata.build_obsdata_host(
        jdata.format_dataframe(df, ("S", "V")), times, ("S", "V"))
    assert obs_t == obs_j
    for name in ref._fields:
        a, b = getattr(got, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if isinstance(censor, tuple):
        keep = np.asarray(got.censor) == 0
        ab = np.exp(got.log_abundance)
        want = sum(np.sum(keep & (got.state_index == s))
                   * np.var(ab[keep & (got.state_index == s)])
                   for s in (0, 1))
        np.testing.assert_allclose(float(got.sstot), want, rtol=1e-12)


def _frameworks(pkg, obs_model, **kw):
    extra = {} if pkg is odelib_tpu else dict(device="cpu")
    from helpers import zero_i
    return pkg.ModelFramework(
        ODE=zero_i, parameter_names=["mu", "phi", "beta"],
        state_names=["S", "V"],
        dataframe=demo_frame("lognormal", ("left", "right")),
        obs_model=obs_model, t_steps=96, ode_style="jax",
        mu=0.6, phi=2.4e-8, beta=24.0, **extra, **kw)


@pytest.mark.parametrize("obs_model", ["lognormal", "student_t"])
def test_framework_fit_statistics_match_odelib_tpu(obs_model):
    """get_chi (Tobit terms at the limits) and get_Rsqrd (limits left
    out) of the same predictions, as odelib_tpu's ModelFramework gives
    them; the censored flags are those of the compact fit grid."""
    ref = _frameworks(odelib_tpu, obs_model)
    got = _frameworks(odelib_tpu_torch, obs_model)
    np.testing.assert_array_equal(got._obsdata_fit_host.censor,
                                  np.asarray(ref._obsdata_fit_host.censor))
    rng = np.random.default_rng(0)
    mod = {s: np.exp(got._obs_logabundance[s]
                     + rng.normal(0, 0.3, len(got._obs_logabundance[s])))
           for s in ("S", "V")}
    np.testing.assert_allclose(got.get_chi(mod), ref.get_chi(mod),
                               rtol=1e-10)
    np.testing.assert_allclose(got.get_Rsqrd(mod), ref.get_Rsqrd(mod),
                               rtol=1e-12)


def test_log_ndtr_accuracy():
    """log Phi of float32 z against float64 within 2e-6 relative over
    [-37, 8]: its double-precision erfc/erfcx branches; NaN stays NaN,
    +inf gives 0 and -inf gives -inf."""
    z = np.linspace(-37.0, 8.0, 9001).astype(np.float32)
    got = T.log_ndtr(torch.as_tensor(z)).numpy().astype(np.float64)
    want = sp.log_ndtr(z.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)
    edge = T.log_ndtr(torch.tensor([np.nan, np.inf, -np.inf])).numpy()
    assert np.isnan(edge[0]) and edge[1] == 0.0 and edge[2] == -np.inf


@pytest.mark.parametrize("nu", [1.0, 2.0, 4.0, 10.0, 30.0, 100.0])
def test_t_logcdf_accuracy(nu):
    """The t log-CDF (Lentz continued fraction to convergence, the
    symmetry switch) against float64 within 1e-5 relative over
    z in [-50, 50] where the float64 value is a normal float32; below
    that (nu = 100's far upper tail, ~1e-72) within float32's smallest
    normal absolutely. NaN stays NaN."""
    z = np.linspace(-50.0, 50.0, 4001).astype(np.float32)
    got = T.t_logcdf(torch.as_tensor(z), T.t_constants(nu)).numpy()
    want = ss.t.logcdf(z.astype(np.float64), nu)
    normal = np.abs(want) >= np.finfo(np.float32).tiny
    np.testing.assert_allclose(got[normal], want[normal], rtol=1e-5, atol=0)
    assert np.all(np.abs(got[~normal] - want[~normal])
                  < np.finfo(np.float32).tiny)
    assert np.isnan(T.t_logcdf(torch.tensor([np.nan]),
                               T.t_constants(nu)).item())


def test_log_ndtr_departs_from_the_jax_kernel_approximation():
    """The JAX kernel's Mosaic-safe log Phi (A&S 7.1.26 erfc and a
    Mills-ratio tail) is off by 5.8e-4 nats at its z = -4 seam and by 1 %
    relative in the upper tail (z = 8); the port matches XLA's exact
    log_ndtr instead, to float32 rounding."""
    z = np.concatenate([np.linspace(-6.0, -2.0, 801),
                        np.linspace(6.0, 8.0, 201)]).astype(np.float32)
    want = sp.log_ndtr(z.astype(np.float64))
    kernel = np.asarray(J._log_ndtr_kernel(jnp.asarray(z)), np.float64)
    port = T.log_ndtr(torch.as_tensor(z)).numpy().astype(np.float64)
    assert np.max(np.abs(kernel - want)) > 5e-4
    assert np.max(np.abs(kernel - want) / np.abs(want)) > 5e-3
    assert np.max(np.abs(port - want) / np.abs(want)) < 2e-7


@pytest.mark.parametrize("fam", ["lognormal", "student_t"])
def test_survey_twin_on_censored_data_matches_xla_survey(fam):
    """Left- and right-censored points: the float32 twin against the XLA
    survey (exact log_ndtr, betainc) within rtol 1e-5."""
    jspec, tspec, obs, tf, y0, centre = fam_case(fam, ("left", "right"))
    assert set(np.asarray(obs.censor)) == {0, 1, 2}
    th = draws(centre, 16, 0.2)
    ref = xla_survey(jspec, obs, tf, y0, th, 2)
    got = T.survey_fused(tspec, obs, tf, y0, torch.as_tensor(th),
                         substeps=2).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_mh_twin_on_censored_student_t_matches_pallas_interpret():
    """Censored Student-t data: the JAX kernel's t log-CDF (40 Lentz steps
    in float32) and the port's (to convergence, in double) agree closely
    enough that the accept sequences are equal (the thinned demo: two
    host points left-, one virus point right-censored)."""
    jspec, tspec, obs, tf, y0, centre = fam_case(
        "student_t", ("left", "right"), thin=THIN)
    assert set(np.asarray(obs.censor)) == {0, 1, 2}
    got, ref = run_mh(jspec, tspec, obs, tf, y0, draws(centre, 128, 0.03),
                      nits=16, burnin=6, substeps=1)
    assert_same_chains(got, ref)


def test_censored_counts_raise():
    """Censored counts: the kernels raise the JAX kernel's ValueError
    (matching 'lognormal'); MCMC under backend='auto' runs them on the scan
    samplers, as the reference runs them on its XLA samplers; 'pallas'
    gives the kernel's ValueError; JointFit.MCMC runs them on the XLA
    joint sampler, as the reference does."""
    jspec, tspec, obs, tf, y0, centre = fam_case("lognormal", ("left",))
    pspec = dataclasses.replace(tspec, obs_model="poisson")
    with pytest.raises(ValueError, match="lognormal"):
        T._build_plan(pspec, obs, tf, 1)
    df = demo_frame("poisson", ("left",), scale=1e5)

    def fw(model):
        from helpers import zero_i
        return odelib_tpu_torch.ModelFramework(
            ODE=zero_i, parameter_names=["mu", "phi", "beta"],
            state_names=["S", "V"], dataframe=df, obs_model=model,
            t_steps=64, ode_style="jax", mu=0.6, phi=2.4e-3, beta=24.0,
            device="cpu")
    model = fw("poisson")
    for sampler, arm in (("mh", "xla"), ("ensemble", "ensemble"),
                         ("pt", "pt")):
        post = model.MCMC(chain_inits=4, iterations_per_chain=4,
                          sampler=sampler, fitsurvey_samples=32,
                          sd_fitdistance=1e3, print_report=False,
                          profile=True, max_steps=64)
        assert f"chains[{arm}]" in model.last_profile
        assert post["chain#"].nunique() == 4
    with pytest.raises(ValueError, match="lognormal"):
        model.MCMC(chain_inits=4, iterations_per_chain=4,
                   backend="pallas", fitsurvey_samples=8,
                   sd_fitdistance=1e3, print_report=False)
    jf = JointFit({"a": model, "b": fw("lognormal")})
    # these values leave every LHS draw's chi NaN: seed from the current
    # values (the chains stay there, all rejected)
    jf.fit_survey = lambda samples, **kw: jf._df_from_thetas(
        np.tile(jf._current_joint_theta(), (8, 1)), {"chi": np.arange(8.0)})
    with pytest.warns(UserWarning, match="never accepted"):
        post = jf.MCMC(chain_inits=4, iterations_per_chain=4,
                       print_report=False, profile=True)
    assert "chains[xla]" in jf.last_profile and len(post) == 4
