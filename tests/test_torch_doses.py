"""Bolus dose events: each amount joins its state when the solve leaves
the grid point nearest its time, so reported values are pre-dose troughs.
The port's integrators against the closed form and ``odelib_tpu``'s, the
spec's normalisation and the compact grid, and dosed pk_oral through the
survey twin and the MH, ensemble, PT, joint and PMMH twins against the JAX
kernels in interpret mode (the same accept sequences; PMMH on pk_oral with
a diffusion and on the GBM)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odelib_tpu
import odelib_tpu_torch
from odelib_tpu import models as jmodels
from odelib_tpu.data import compact_observation_grid as j_compact
from odelib_tpu.model import dose_matrix as j_dose_matrix
from odelib_tpu.model import integrate_theta as j_integrate
from odelib_tpu.model import make_spec as j_make_spec
from odelib_tpu.ops import pallas_joint as JJ
from odelib_tpu.ops import pallas_mh as J
from odelib_tpu.ops import pallas_pf as JF
from odelib_tpu_torch.data import compact_observation_grid
from odelib_tpu_torch.model import dose_matrix, integrate_theta, make_spec
from odelib_tpu_torch.ops import cuda_joint as TJ
from odelib_tpu_torch.ops import cuda_mh as T
from odelib_tpu_torch.ops import cuda_pf as TF
from odelib_tpu_torch.rhs import adapt_rhs

from test_torch_obs_models import (THIN, assert_same_chains,
                                   assert_same_filters, draws, gbm_case,
                                   jax_twin_spec, run_mh, run_pmmh,
                                   xla_survey)
from test_torch_obs_models_ensemble_pt import run_ensemble, run_pt
from scoring_cases import PK_DOSES, pk_case, pk_frame

K = 0.7
DOSES = ((0.0, "A", 10.0), (2.0, "A", 10.0), (4.0, "A", 10.0))
PK_CENTRE = np.array([1.2, 0.25, 30.0])


def _decay(t, y, ps):
    return jnp.stack([-ps[0] * y[0]])


def _exact_pre_dose(ts, k=K, dose_times=(0.0, 2.0, 4.0), amt=10.0):
    """Superposed decaying boluses; at a dose time the pre-dose value."""
    ts = np.asarray(ts, float)
    out = np.zeros_like(ts)
    for td in dose_times:
        out = out + np.where(ts > td, amt * np.exp(-k * (ts - td)), 0.0)
    return out


@pytest.mark.parametrize("method,kw", [
    ("dopri5", dict(rtol=1e-8, atol=1e-10)),
    ("rk4", dict(substeps=32)),
    ("fixed_dopri5", dict(substeps=8))])
def test_dosed_decay_matches_closed_form(method, kw):
    """Float64 solves of three boluses against the closed form (rtol
    1e-5), the trough at a dose time, and the JAX package's solve of the
    same spec (adaptive: the same steps, so to 1e-12)."""
    spec = make_spec(adapt_rhs(_decay), ("k",), ("A",), dose_events=DOSES)
    ts = np.linspace(0.0, 6.0, 61)
    ys = integrate_theta(spec, torch.tensor([[K]], dtype=torch.float64),
                         torch.zeros((1, 1), dtype=torch.float64), ts,
                         method=method, **kw)[:, 0, 0].numpy()
    np.testing.assert_allclose(ys, _exact_pre_dose(ts), rtol=1e-5,
                               atol=1e-8)
    i2 = np.argmin(np.abs(ts - 2.0))
    assert abs(ys[i2] - 10.0 * np.exp(-2 * K)) < 1e-4
    ref = np.asarray(j_integrate(
        j_make_spec(_decay, ("k",), ("A",), dose_events=DOSES),
        jnp.array([K]), jnp.array([0.0]), jnp.asarray(ts), method=method,
        **kw))[:, 0]
    np.testing.assert_allclose(ys, ref, rtol=1e-12, atol=1e-14)


def test_dosed_kvaerno5_raises():
    """Dosed adaptive Kvaerno5 (it raised until the stiff solvers were
    ported): three boluses against the closed form (rtol 1e-5) and the
    JAX package's solve of the same spec (the same steps, to 1e-10), the
    trough at a dose time."""
    spec = make_spec(adapt_rhs(_decay), ("k",), ("A",), dose_events=DOSES)
    ts = np.linspace(0.0, 6.0, 61)
    kw = dict(method="kvaerno5", rtol=1e-8, atol=1e-10)
    ys = integrate_theta(spec, torch.tensor([[K]], dtype=torch.float64),
                         torch.zeros((1, 1), dtype=torch.float64), ts,
                         **kw)[:, 0, 0].numpy()
    np.testing.assert_allclose(ys, _exact_pre_dose(ts), rtol=1e-5,
                               atol=1e-8)
    i2 = np.argmin(np.abs(ts - 2.0))
    assert abs(ys[i2] - 10.0 * np.exp(-2 * K)) < 1e-4
    ref = np.asarray(j_integrate(
        j_make_spec(_decay, ("k",), ("A",), dose_events=DOSES),
        jnp.array([K]), jnp.array([0.0]), jnp.asarray(ts), **kw))[:, 0]
    np.testing.assert_allclose(ys, ref, rtol=1e-10, atol=1e-14)


def test_dose_snaps_to_nearest_grid_point():
    spec = make_spec(adapt_rhs(_decay), ("k",), ("A",),
                     dose_events=[(1.02, "A", 5.0), (1.0, 0, 1.0)])
    ts = np.linspace(0.0, 2.0, 21)
    D = dose_matrix(spec, ts)
    np.testing.assert_array_equal(D, np.asarray(j_dose_matrix(
        j_make_spec(_decay, ("k",), ("A",), dose_events=spec.dose_events),
        jnp.asarray(ts))))
    assert D.shape == (21, 1) and D[10, 0] == 6.0 and D.sum() == 6.0


def test_make_spec_dose_validation():
    with pytest.raises(ValueError, match="state name"):
        make_spec(adapt_rhs(_decay), ("k",), ("A",),
                  dose_events=[(1.0, "B", 1.0)])
    with pytest.raises(ValueError, match="out of range"):
        make_spec(adapt_rhs(_decay), ("k",), ("A",),
                  dose_events=[(1.0, 3, 1.0)])
    s = make_spec(adapt_rhs(_decay), ("k",), ("A",),
                  dose_events=[(2.0, 0, 1.0), (1.0, "A", 2.0)])
    assert s.dose_events == ((1.0, 0, 2.0), (2.0, 0, 1.0))
    # doses and forcings together (the forcings are validated as the
    # reference validates them, tests/test_torch_forcings.py)
    f = make_spec(adapt_rhs(_decay), ("k",), ("A",),
                  dose_events=[(1.0, "A", 2.0)],
                  forcings={"u": ([0.0, 1.0], [1.0, 2.0])})
    assert f.dose_events == ((1.0, 0, 2.0),)
    assert f.forcings == (("u", (0.0, 1.0), (1.0, 2.0), "linear"),)


def test_compact_grid_keeps_dose_times():
    """pk_oral's grid keeps every dose time, as odelib_tpu's does."""
    spec, obs, tf, _ = pk_case(censored=False)
    times = np.linspace(0, 72.0, 145)
    from odelib_tpu_torch.data import build_obsdata_host, format_dataframe
    host, _ = build_obsdata_host(format_dataframe(pk_frame(False),
                                                  ("A_gut", "C")),
                                 times, spec.post_snames)
    extra = [t for t, _, _ in PK_DOSES]
    ct, o = compact_observation_grid(host, times, extra_times=extra)
    jt, jo = j_compact(host, times, extra_times=extra)
    np.testing.assert_array_equal(ct, jt)
    np.testing.assert_array_equal(o.t_index, jo.t_index)
    np.testing.assert_array_equal(ct, tf)
    assert all(np.min(np.abs(ct - t)) == 0.0 for t in extra)


def pk_twin_case(censored=False):
    tspec, obs, tf, y0 = pk_case(censored)
    return (jax_twin_spec(tspec, jmodels.pk_oral.rhs), tspec, obs, tf, y0,
            PK_CENTRE)


def test_survey_twin_on_dosed_pk_oral():
    """Dosed pk_oral (a fifth of its points left-censored): the float32
    twin against the XLA survey within rtol 1e-5; without censoring also
    against the interpret-mode survey kernel within the survey's 1e-5."""
    for censored in (True, False):
        jspec, tspec, obs, tf, y0, centre = pk_twin_case(censored)
        th = draws(centre, 16, 0.2)
        got = T.survey_fused(tspec, obs, tf, y0, torch.as_tensor(th),
                             substeps=2).numpy()
        np.testing.assert_allclose(
            got, xla_survey(jspec, obs, tf, y0, th, 2), rtol=1e-5)
    ref = np.asarray(J.survey_fused(jspec, obs, tf, y0, th, substeps=2,
                                    tile_chains=128, interpret=True))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


_RUNS = {"mh": (run_mh, 128, dict(nits=16, burnin=6, substeps=1)),
         "ensemble": (run_ensemble, 256, dict(nits=8, burnin=3,
                                              substeps=1)),
         "pt": (run_pt, 128, dict(nits=10, burnin=4, substeps=1,
                                  temperatures=(1.0, 2.0, 4.0)))}


@pytest.mark.parametrize("sampler", sorted(_RUNS))
def test_chain_twins_on_dosed_pk_oral(sampler):
    """MH, ensemble and PT on dosed pk_oral: the JAX kernels' accept
    sequences."""
    jspec, tspec, obs, tf, y0, centre = pk_twin_case()
    run, n, kw = _RUNS[sampler]
    got, ref = run(jspec, tspec, obs, tf, y0, draws(centre, n, 0.03), **kw)
    assert_same_chains(got, ref)


def test_joint_twin_on_dosed_pk_oral():
    """Two dosed pk_oral studies (noise seeds 0 and 1) sharing ka and V,
    each with its own ke: the JAX kernel's accept sequences."""
    jspec, tspec, obs, tf, y0, _ = pk_twin_case()
    from scoring_cases import fit_inputs
    from odelib_tpu_torch.data import format_dataframe
    obs1, tf1 = fit_inputs(tspec, format_dataframe(
        pk_frame(False, seed=1), ("A_gut", "C")), 145)
    th0 = draws([1.2, 0.25, 30.0, 0.25], 128, 0.03)
    kw = dict(nits=12, burnin=4, substeps_list=[1, 1])
    args = ((0, 1, 2), (0, 3, 2)), (obs, obs1), (tf, tf1), (y0, y0)
    ref = JJ.joint_metropolis_hastings_fused(
        (jspec, jspec), *args, th0, seed=4, tile_chains=128,
        interpret=True, **kw)
    got = TJ.joint_metropolis_hastings_fused(
        (tspec, tspec), *args, torch.as_tensor(th0), 4, **kw)
    assert_same_chains(got, ref)


def _pk_noise(t, y, ps):
    return jnp.stack([0.1 * y[0], 0.1 * y[1]])


def test_pmmh_twin_on_dosed_pk_oral():
    """pk_oral as an SDE (10 % multiplicative noise on both states) under
    its six doses: the particles take each dose after their block; the
    JAX kernel's accept sequences (128 chains, 16 particles, 4 Euler
    steps an interval; every 4 h, ``THIN``)."""
    tspec, obs, tf, y0 = pk_case(censored=False, thin=THIN)
    jspec = j_make_spec(jmodels.pk_oral.rhs, tspec.pnames, tspec.snames,
                        dose_events=tspec.dose_events, diffusion=_pk_noise)
    tspec = make_spec(tspec.rhs, tspec.pnames, tspec.snames,
                      dose_events=tspec.dose_events,
                      diffusion=adapt_rhs(_pk_noise))
    th0 = draws(PK_CENTRE, 128, 0.05)
    kw = dict(nits=7, burnin=3, rwalk_std=0.1, n_particles=16, substeps=4)
    ref = JF.pmmh_fused(jspec, obs, tf, y0.astype(np.float32), th0, seed=3,
                        interpret=True, **kw)
    got = TF.pmmh_fused(tspec, obs, tf, y0, torch.as_tensor(th0), 3, **kw)
    assert np.isfinite(got.chi.numpy()).all()
    assert_same_filters(got, ref)


def test_pmmh_twin_with_a_dose():
    """A dose into the GBM SDE's state mid-run (after the block at
    t = 2): the particles take it after resampling; the JAX kernel's
    accept sequences."""
    got, ref = run_pmmh(*gbm_case("student_t", ((2.0, 0, 1.5),)))
    assert_same_filters(got, ref)


def _pk_framework(pkg, **kw):
    return pkg.ModelFramework(
        ODE=jmodels.pk_oral.rhs, parameter_names=["ka", "ke", "V"],
        state_names=["A_gut", "C"], dataframe=pk_frame(False),
        dose_events=list(PK_DOSES), t_steps=145, ode_style="jax",
        ka=1.2, ke=0.25, V=30.0, **kw)


def test_framework_integrate_and_chi_with_doses():
    """ModelFramework.integrate applies the doses on the full grid (the
    adaptive solve stepping to each grid point) as odelib_tpu's does, and
    get_fitstats scores the dosed trajectory alike."""
    ref = _pk_framework(odelib_tpu)
    got = _pk_framework(odelib_tpu_torch, device="cpu")
    a = got.integrate(as_dataframe=False)
    b = np.asarray(ref.integrate(as_dataframe=False))
    np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
    # the gut half an hour after each dose: 100 exp(-0.6) and a remnant
    after = [int(np.argmin(np.abs(got.times - t - 0.5))) for t, _, _ in
             PK_DOSES]
    assert (a[after, 0] > 54.8).all() and a[0, 0] == 0.0
    np.testing.assert_array_equal(got._times_fit, ref._times_fit)
    fs, fr = got.get_fitstats(), ref.get_fitstats()
    for k in ("Chi", "R^2", "AIC"):
        np.testing.assert_allclose(fs[k], fr[k], rtol=1e-8)
