"""Fused survey: the port's ``survey_fused`` (torch twin on the CPU)
against ``odelib_tpu``'s Pallas kernel in interpret mode, and the eager
adaptive ``survey`` against the JAX one. Kernel-versus-twin on the card is
in tests/test_torch_cuda.py and chip_smoke.py's survey phase."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odelib_tpu.data import (build_obsdata_host, compact_observation_grid,
                             format_dataframe, obsdata_to_device)
from odelib_tpu.model import make_spec
from odelib_tpu.ops import pallas_mh as J
from odelib_tpu.samplers import survey as jax_survey
from odelib_tpu_torch.model import make_spec as t_make_spec
from odelib_tpu_torch.ops import cuda_mh as T
from odelib_tpu_torch.rhs import adapt_rhs
from odelib_tpu_torch.samplers import survey as t_survey

from helpers import synthetic_df, zero_i, zero_i_refstyle

_PN, _SN = ("mu", "phi", "beta"), ("S", "V")


@pytest.fixture(scope="module")
def setup():
    """The shapes of tests/test_pallas_mh.py's fixture: halved grid."""
    df = format_dataframe(synthetic_df(), _SN)
    df = df[np.isclose(np.mod(np.round(df["time"] / 0.2), 2), 0)]
    times = np.linspace(0, 3.1, 288)
    spec = make_spec(zero_i, _PN, _SN)
    obs_host, _ = build_obsdata_host(df, times, spec.post_snames)
    times_fit, obs_fit = compact_observation_grid(obs_host, times)
    y0 = np.array([df.loc["S"].iloc[0]["abundance"],
                   df.loc["V"].iloc[0]["abundance"]])
    tspec = t_make_spec(adapt_rhs(zero_i), _PN, _SN)
    return spec, tspec, obs_fit, times_fit, y0


def _draws():
    rng = np.random.default_rng(0)
    return (np.array([0.6, 2.4e-8, 24.0])
            * np.exp(rng.normal(0, 0.2, (16, 3)))).astype(np.float32)


# substeps=2: at substeps=1 the dopri5 stage sums' large coefficients
# amplify both sides' float32 rounding to a 2.5e-4 gap on the stiffest draw
# (test_survey_substeps1_against_witnesses traces it to XLA:CPU's
# arithmetic); at 2 every draw is inside rtol 1e-5 (measured max 8.6e-6 dopri5,
# 1.5e-6 rk4)
@pytest.mark.parametrize("stepper", ["dopri5", "rk4"])
def test_survey_twin_matches_pallas_interpret(setup, stepper):
    spec, tspec, obs_fit, times_fit, y0 = setup
    thetas = _draws()
    ref = np.asarray(J.survey_fused(spec, obs_fit, times_fit, y0, thetas,
                                    substeps=2, stepper=stepper,
                                    tile_chains=128, interpret=True))
    obs_t, th, _, y0_t = T.inputs_from_reference(obs_fit, thetas, 0, y0)
    got = T.survey_fused(tspec, obs_t, times_fit, y0_t, th, substeps=2,
                         stepper=stepper)
    assert got.dtype == torch.float32 and got.shape == (16,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


def _chi_numpy(spec, obs_fit, times_fit, y0, thetas, stepper, dtype):
    """The reference's fixed-step scheme evaluated by numpy in ``dtype``:
    the JAX package's own plan, steppers and lognormal term on numpy
    arrays (numpy neither fuses multiply-adds nor rewrites divisions),
    with the reference-style zero_i RHS."""
    plan = J._build_plan(spec, obs_fit, times_fit, 1)
    step = {"dopri5": J._dopri5_fixed_step, "rk4": J._rk4_fixed_step}[stepper]
    th = thetas.astype(dtype).T
    y = np.stack([np.full(th.shape[1], v, dtype) for v in np.asarray(y0)])
    chi = np.zeros(th.shape[1], dtype)

    def contrib(y, gi, chi):
        for mem, lab, lsig, _, _ in plan.obs_after[gi]:
            pred = sum(y[m] for m in mem) if len(mem) > 1 else y[mem[0]]
            chi = chi + (lab - np.log(pred)) ** 2 / (2.0 * lsig * lsig)
        return chi

    chi = contrib(y, 0, chi)
    for t, h, gi in plan.step_ts:
        y = step(lambda t_, y_, p_: zero_i_refstyle(y_, t_, p_), t, y, h, th)
        if gi >= 0:
            chi = contrib(y, gi, chi)
    assert chi.dtype == dtype
    return chi


# Two witnesses at substeps=1 (max relative gaps, measured on the CPU):
#
#   draws             port-np32   interpret-np32   port-f64 / interpret-f64
#   stiff, dopri5     5.8e-7      2.5e-4           3.6e-4 / 1.1e-4
#   stiff, rk4        1.0e-7      1.1e-6           9.9e-7 / 1.2e-6
#   near fit, dopri5  4.3e-6      4.0e-5           3.1e-5 / 2.1e-5
#
# np32 is the reference's own source evaluated in float32 by numpy: the
# port agrees with it within rtol 1e-5, so the gap to the interpret-mode
# kernel is XLA:CPU's evaluation of that source (it fuses multiply-adds,
# divides by constants as multiplication by a reciprocal and uses its own
# log), not a difference of scheme. f64 is the same scheme in float64: each
# float32 side lies within its rounding band of it. The fused arithmetic is
# nearer on the stiffest draw; both bands are three orders below the
# scheme's own truncation error at substeps=1 (0.3-0.6 of chi).
@pytest.mark.parametrize("stepper,spread,band", [
    ("dopri5", 0.2, 5e-4), ("rk4", 0.2, 2e-6), ("dopri5", 0.05, 5e-5)],
    ids=["dopri5-stiff", "rk4-stiff", "dopri5-near-fit"])
def test_survey_substeps1_against_witnesses(setup, stepper, spread, band):
    spec, tspec, obs_fit, times_fit, y0 = setup
    rng = np.random.default_rng(0 if spread == 0.2 else 3)
    n = 16 if spread == 0.2 else 128
    thetas = (np.array([0.6, 2.4e-8, 24.0])
              * np.exp(rng.normal(0, spread, (n, 3)))).astype(np.float32)
    w32 = _chi_numpy(spec, obs_fit, times_fit, y0, thetas, stepper,
                     np.float32)
    w64 = _chi_numpy(spec, obs_fit, times_fit, y0, thetas, stepper,
                     np.float64)
    assert np.isfinite(w64).all()
    obs_t = T.obsdata_from_arrays(obs_fit)
    # the twin in float64 is the witness's scheme, operation for operation
    twin64 = T.survey_plain(
        tspec, T._build_plan(tspec, obs_t, times_fit, 1), y0,
        torch.as_tensor(thetas.T.astype(np.float64)), stepper)
    np.testing.assert_allclose(twin64.numpy(), w64, rtol=1e-12)
    got = T.survey_fused(tspec, obs_t, times_fit, y0, thetas, substeps=1,
                         stepper=stepper, device="cpu").numpy()
    np.testing.assert_allclose(got, w32, rtol=1e-5)
    ref = np.asarray(J.survey_fused(spec, obs_fit, times_fit, y0, thetas,
                                    substeps=1, stepper=stepper,
                                    tile_chains=128, interpret=True))
    np.testing.assert_allclose(got, w64, rtol=band)
    np.testing.assert_allclose(ref, w64, rtol=band)
    np.testing.assert_allclose(got, ref, rtol=2 * band)


def test_survey_twin_matches_pallas_interpret_with_summation():
    """one_i observed as H = S + I1: the scorer's summed predictions."""
    from helpers import one_i
    pn, sn = ("mu", "phi", "beta", "lam"), ("S", "I1", "V")
    ss = {"H": ["S", "I1"]}
    df = synthetic_df().replace({"S": "H"})
    df = format_dataframe(df, sn)
    times = np.linspace(0, 3.1, 288)
    spec = make_spec(one_i, pn, sn, state_summations=ss)
    obs_host, _ = build_obsdata_host(df, times, spec.post_snames)
    times_fit, obs_fit = compact_observation_grid(obs_host, times)
    y0 = np.array([5.2e6, 0.0, 1.1e7])
    rng = np.random.default_rng(2)
    thetas = (np.array([0.6, 2.4e-8, 20.0, 3.0])
              * np.exp(rng.normal(0, 0.2, (16, 4)))).astype(np.float32)
    ref = np.asarray(J.survey_fused(spec, obs_fit, times_fit, y0, thetas,
                                    substeps=2, tile_chains=128,
                                    interpret=True))
    tspec = t_make_spec(adapt_rhs(one_i), pn, sn, state_summations=ss)
    assert tspec.sum_matrix == spec.sum_matrix
    got = T.survey_fused(tspec, T.obsdata_from_arrays(obs_fit), times_fit,
                         y0, thetas, substeps=2, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_survey_blowup_gives_nonfinite_chi(setup):
    """A blown-up trajectory gives non-finite chi in both packages."""
    spec, tspec, obs_fit, times_fit, y0 = setup
    thetas = np.array([[50.0, 2.4e-8, 24.0],     # e^150 growth: overflows
                       [0.6, 2.4e-8, 24.0]], np.float32)
    ref = np.asarray(J.survey_fused(spec, obs_fit, times_fit, y0, thetas,
                                    substeps=1, tile_chains=128,
                                    interpret=True))
    got = T.survey_fused(tspec, T.obsdata_from_arrays(obs_fit), times_fit,
                         y0, thetas, substeps=1, device="cpu").numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    assert not np.isfinite(got[0]) and np.isfinite(got[1])


def test_plan_tables_layout(setup):
    """The kernel's runtime tables hold the plan: steps, CSR offsets and
    float32 constants rounded on the host."""
    _, tspec, obs_fit, times_fit, y0 = setup
    obs = T.obsdata_from_arrays(obs_fit)
    plan = T._build_plan(tspec, obs, times_fit, 2)
    pi, pf = T.plan_tables(tspec, plan, y0, "dopri5")
    n_steps, n_grid, n_obs = pi[0], pi[1], pi[2]
    assert n_steps == 2 * (len(times_fit) - 1) and n_grid == len(times_fit)
    assert n_obs == len(obs.log_abundance)
    obs_ptr = pi[pi[6]:pi[6] + n_grid + 1]
    assert obs_ptr[0] == 0 and obs_ptr[-1] == n_obs
    assert pf[0] == np.float32(float(obs.sstot))
    np.testing.assert_array_equal(pf[pi[13]:pi[13] + 2], y0.astype(np.float32))
    steps = pf[pi[9]:pi[9] + 8 * n_steps].reshape(n_steps, 8)
    np.testing.assert_array_equal(
        steps[:, 0], np.float32([h for _, h, _ in plan.step_ts]))


def test_eager_survey_matches_jax_survey(setup):
    """``samplers.mh.survey`` (batched adaptive Dopri5, float64) against
    the JAX package's vmapped survey."""
    spec, tspec, obs_fit, times_fit, y0 = setup
    thetas = _draws().astype(np.float64)
    ref = np.asarray(jax_survey(spec, obsdata_to_device(obs_fit, jnp.float64),
                                jnp.asarray(times_fit), jnp.asarray(y0),
                                jnp.asarray(thetas)))
    got = t_survey(tspec, T.obsdata_from_arrays(obs_fit), times_fit, y0,
                   torch.as_tensor(thetas))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)

