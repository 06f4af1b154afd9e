"""Models of more than 32 states: two_i with n latent classes
(``scoring_cases.chain_rhs``; n = 31 and 40 give 33 and 42 states, the
observed host summing n + 1 of them). The port's survey twin against
``odelib_tpu``'s Pallas kernel in interpret mode on the demo data at 42
states, within the survey's 5e-5, and the fixed Kvaerno3 step at S = 33
against the JAX package's plain ``kvaerno3_fixed_step``, within 1e-5 in
float32; the MH twin is in tests/test_torch_states_mh.py (each
interpret-mode kernel compiles for under a minute)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odelib_tpu.data import (build_obsdata_host, compact_observation_grid,
                             format_dataframe)
from odelib_tpu.model import make_spec
from odelib_tpu.ops import pallas_mh as J
from odelib_tpu.ops.runge_kutta import kvaerno3_fixed_step as jax_kv3
from odelib_tpu_torch.ops import cuda_mh as T
from odelib_tpu_torch.ops.runge_kutta import kvaerno3_fixed_step
from odelib_tpu_torch.rhs import jacobian_evaluator, torch_evaluator

from scoring_cases import (CHAIN_PNAMES, chain_case, chain_rhs,
                           chain_snames, chain_summations, chain_theta,
                           demo_frame)


def _jax_case(n, thin=2, first=3):
    """The chain as odelib_tpu builds it from the same frame (the demo's
    sampling times thinned by ``thin``, the first ``first`` of them: 0,
    0.3 and 0.7, two intervals, which keeps the interpret-mode kernels'
    unrolled programs short): (spec, host obs, grid, y0), and the port's spec
    (``chain_case``)."""
    snames = chain_snames(n)
    spec = make_spec(chain_rhs(n, jnp.stack), CHAIN_PNAMES, snames,
                     state_summations=chain_summations(n))
    df = format_dataframe(demo_frame(host="H", thin=thin, first=first),
                          snames)
    times = np.linspace(0, df["time"].max(), 288)
    obs, _ = build_obsdata_host(df, times, spec.post_snames)
    tf, obs = compact_observation_grid(obs, times)
    tspec, _, ttf, y0 = chain_case(n, thin=thin, first=first)
    np.testing.assert_array_equal(tf, ttf)
    return spec, tspec, obs, tf, y0


@pytest.fixture(scope="module")
def chain42():
    return _jax_case(40)


def _draws(n, C, sd, seed=0, tau=15.0):
    """Around chain_theta with tau at ``tau``: the classes' transit tau h
    stays inside Dopri5's stability at the tests' steps (h <= 0.125 on
    the thinned demo grid at substeps 4; chain_theta's tau = 78 needs
    h < 0.04, and at tau 16-17 the steps of 0.126 on a grid thinned by 3
    give NaN in both packages)."""
    rng = np.random.default_rng(seed)
    centre = np.asarray(chain_theta(n))
    centre[4] = tau
    return (centre * np.exp(rng.normal(0, sd, (C, 5)))).astype(np.float32)


def test_chain_spec_has_42_states_and_a_41_member_host(chain42):
    _, tspec, obs, _, _ = chain42
    assert len(tspec.snames) == 42
    plan = T._build_plan(tspec, T.obsdata_from_arrays(obs), chain42[3], 1)
    sizes = {len(o[0]) for g in plan.obs_after for o in g}
    assert sizes == {1, 41}


def test_survey_twin_on_42_states_matches_pallas_interpret(chain42):
    spec, tspec, obs, tf, y0 = chain42
    th = _draws(40, 16, 0.1)
    ref = np.asarray(J.survey_fused(spec, obs, tf, y0, th, substeps=4,
                                    tile_chains=128, interpret=True))
    obs_t, th_t, _, y0_t = T.inputs_from_reference(obs, th, 0, y0)
    got = T.survey_fused(tspec, obs_t, tf, y0_t, th_t, substeps=4)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=5e-5)


def test_kvaerno3_step_at_33_states_matches_odelib_tpu():
    """One fixed Kvaerno3 step of the 33-state chain (Jacobian, the
    elimination of 33 x 33 without pivoting, 4 chord-Newton iterations a
    stage) on 16 lanes around the demo's start: float32 within 1e-5 of
    the JAX package's plain step; both within 1e-3 of float64."""
    n = 31
    S = n + 2
    tspec = chain_case(n, thin=2)[0]
    f = torch_evaluator(tspec.rhs, S, tspec.pshapes)
    jac = jacobian_evaluator(tspec.rhs, S, tspec.pshapes)
    rng = np.random.default_rng(4)
    y = np.abs(np.concatenate([[5.6e6], np.full(n, 1e5), [1.5e7]]))[:, None] \
        * np.exp(rng.normal(0, 0.3, (S, 16)))
    p = np.asarray(chain_theta(n))[:, None] * np.exp(
        rng.normal(0, 0.1, (5, 16)))
    h = 0.05
    got = torch.stack(kvaerno3_fixed_step(
        f, 0.0, list(torch.as_tensor(y, dtype=torch.float32)), h,
        list(torch.as_tensor(p, dtype=torch.float32)), jac)).numpy()
    ref = np.asarray(jax_kv3(chain_rhs(n, jnp.stack), 0.0,
                             jnp.asarray(y, jnp.float32), h,
                             list(jnp.asarray(p, jnp.float32))))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(
        ref).max())
    exact = torch.stack(kvaerno3_fixed_step(
        f, 0.0, list(torch.as_tensor(y)), h, list(torch.as_tensor(p)),
        jac)).numpy()
    np.testing.assert_allclose(got, exact, rtol=1e-3,
                               atol=1e-4 * np.abs(exact).max())
