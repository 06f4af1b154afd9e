"""Forcings (time-varying covariate tables in the RHS's fourth argument):
the port's ``normalize_forcings``/``eval_forcings``/``_pchip_slopes``
against ``odelib_tpu.model``'s in float64, the plans' forcing tables
against the reference's folded values at every stage time, and every
survey twin on a forced model against ``odelib_tpu``'s Pallas kernel in
interpret mode (the chain kernels' twins: tests/test_torch_forcings_chains.py),
on the reference's own setup (tests/test_forcings.py:
``forced_zero_i`` on the synthetic frame, every other sampling time, the
144-point grid). The port folds every node of forcings and constants only
on the host in double, as the JAX kernel's Python floats fold, and reads
the folded values from a table (``rhs.fold_host``). Kernel against twin
on the card is in tests/test_torch_cuda.py and chip_smoke.py's forcing
phases."""
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.stats
import torch

import odelib_tpu
import odelib_tpu.model as JM
import odelib_tpu_torch
import odelib_tpu_torch.model as TM
from odelib_tpu.data import (build_obsdata_host, compact_observation_grid,
                             format_dataframe)
from odelib_tpu.ops import pallas_mh as J
from odelib_tpu_torch.ops import cuda_mh as T
from odelib_tpu_torch.rhs import adapt_rhs, fold_host, trace_rhs

from helpers import synthetic_df, zero_i
from test_forcings import (FT, FV, _cumint_hold, _cumint_linear,
                           forced_zero_i, growth_rhs)

G_TABLE = ((0.0, 1.5, 3.2), (0.8, 1.4, 0.9))
MODES = ("linear", "hold", "cubic")
PN, SN = ("mu", "phi", "beta"), ("S", "V")


def _specs(mode, rhs=forced_zero_i, table=G_TABLE):
    forc = {"g": table + (mode,)}
    jspec = JM.make_spec(rhs, PN, SN, forcings=forc)
    # the reference's normalised tuple, handed over as it is
    return jspec, TM.make_spec(adapt_rhs(rhs, "jax"), PN, SN,
                               forcings=jspec.forcings)


@pytest.fixture(scope="module")
def forced_data():
    """tests/test_forcings.py's forced_setup data: (obs, grid, y0)."""
    df = format_dataframe(synthetic_df(), SN)
    df = df[np.isclose(np.mod(np.round(df["time"] / 0.2), 2), 0)]
    times = np.linspace(0, 3.1, 144)
    obs_host, _ = build_obsdata_host(df, times, SN)
    tf, obs = compact_observation_grid(obs_host, times)
    y0 = np.array([df.loc["S"].iloc[0]["abundance"],
                   df.loc["V"].iloc[0]["abundance"]])
    return obs, tf, y0


def _draws(n, sd, seed=1):
    rng = np.random.default_rng(seed)
    return (np.array([0.6, 2.4e-8, 24.0])
            * np.exp(rng.normal(0, sd, (n, 3)))).astype(np.float32)


# --- the tables ---------------------------------------------------------

_QUERIES = [-0.5, 0.0, 0.3, 1.0, 1.7, 2.0, 3.9, 4.0, 5.5]


@pytest.mark.parametrize("mode", MODES)
def test_eval_forcings_equals_reference(mode):
    """Inside and outside the table: at a concrete time the same float64
    values; at tensor times within 1e-12 of the JAX package's traced
    lookup (float64)."""
    forc = {"a": (FT, FV, mode), "b": (np.array(FT) * 2, FV, mode)}
    ref = JM.normalize_forcings(forc)
    got = TM.normalize_forcings(forc)
    assert got == ref
    assert TM.normalize_forcings(ref) is ref      # passed through
    for t in _QUERIES:
        assert TM.eval_forcings(got, t) == JM.eval_forcings(ref, t)
    tq = torch.tensor(_QUERIES, dtype=torch.float64)
    tv = TM.eval_forcings(got, tq)
    for name in ("a", "b"):
        want = np.array([JM.eval_forcings(ref, jnp.asarray(t))[name]
                         for t in _QUERIES])
        np.testing.assert_allclose(tv[name].numpy(), want, rtol=1e-12,
                                   atol=1e-12)


def test_pchip_slopes_equal_reference():
    rng = np.random.default_rng(3)
    for n in (1, 2, 3, 5, 11):
        ft = tuple(np.cumsum(rng.uniform(0.2, 1.0, n)))
        fv = tuple(rng.normal(0.0, 2.0, n))
        np.testing.assert_array_equal(TM._pchip_slopes(ft, fv),
                                      JM._pchip_slopes(ft, fv))


@pytest.mark.parametrize("bad,match", [
    ({"T": ((0.0, 0.0, 1.0), (1.0, 2.0, 3.0))}, "strictly increasing"),
    ({"T": ((0.0, 1.0), (1.0, 2.0, 3.0))}, "equal-length"),
    ({"T": ((0.0, 1.0), (1.0, 2.0), "quadratic")}, "mode"),
    ({"T": ((0.0, 1.0), (1.0, np.inf))}, "finite"),
])
def test_forcing_validation_errors_as_reference(bad, match):
    with pytest.raises(ValueError, match=match) as ref:
        JM.normalize_forcings(bad)
    with pytest.raises(ValueError, match=match) as got:
        TM.make_spec(adapt_rhs(forced_zero_i, "jax"), PN, SN, forcings=bad)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("stepper", ["dopri5", "rk4", "kvaerno3", "euler"])
def test_plan_forcing_table_is_reference_folded_value(forced_data, stepper):
    """plan_tables' forcing table holds f32(odelib_tpu's eval_forcings) at
    every distinct stage time t + c h of every step (computed in double),
    at the header's offset."""
    obs, tf, y0 = forced_data
    jspec, tspec = _specs("cubic")
    plan = T._build_plan(tspec, TM.obsdata_from_arrays(obs), tf, 3)
    plan_i, plan_f = T.plan_tables(tspec, plan, y0, stepper)
    cs = T.STAGE_C[stepper]
    tab = plan_f[int(plan_i[19]):]
    assert tab.size == len(plan.step_ts) * len(cs)
    want = [np.float32(JM.eval_forcings(jspec.forcings,
                                        t if c == 0.0 else t + c * h)["g"])
            for t, h, _ in plan.step_ts for c in cs]
    np.testing.assert_array_equal(tab, np.asarray(want, np.float32))
    # the unforced plan's tables are the forced one's but for the table
    uspec = TM.make_spec(adapt_rhs(zero_i, "jax"), PN, SN)
    ui, uf = T.plan_tables(uspec, plan, y0, stepper)
    np.testing.assert_array_equal(ui, plan_i)
    np.testing.assert_array_equal(uf, plan_f[:int(plan_i[19])])


def _shifted(t, y, ps, u):
    """Arithmetic on forcings alone before a state meets them: it folds in
    double, as the JAX kernel's Python floats do."""
    mu, phi, beta = ps
    S, V = y
    rate = mu * ((u["g"] - 0.3) * 1.1 + 0.33) * (1.0 / 3.0 + u["g"] * 0.1)
    return jnp.stack([rate * S - phi * S * V,
                      beta * phi * S * V - phi * S * V])


def test_forcing_only_nodes_fold_in_double(forced_data):
    """The traced program reads two columns, each a folded expression of
    g; the plan holds them as f32 of their double values, where float32
    arithmetic on f32(g) would differ."""
    obs, tf, y0 = forced_data
    jspec, tspec = _specs("linear", _shifted)
    prog = trace_rhs(tspec.rhs, 2, tspec.pshapes, tspec.forcings)
    cols = prog.columns
    assert len(cols) == 2 and all(c[0] != "f" for c in cols)
    plan = T._build_plan(tspec, TM.obsdata_from_arrays(obs), tf, 2)
    tab = T.forcing_table(tspec, plan, "dopri5")
    t, h, _ = plan.step_ts[3]
    g = JM.eval_forcings(jspec.forcings, t + 0.3 * h)["g"]
    want = [np.float32((g - 0.3) * 1.1 + 0.33),
            np.float32(1.0 / 3.0 + g * 0.1)]
    np.testing.assert_array_equal(tab[3, 2], want)
    # float32 arithmetic on f32(g) would give other bits at some stages:
    # the choice the table pins down
    gs = np.float32([JM.eval_forcings(jspec.forcings,
                                      T.stage_time(t, h, c))["g"]
                     for t, h, _ in plan.step_ts for c in T.STAGE_C["dopri5"]])
    in_f32 = (gs - np.float32(0.3)) * np.float32(1.1) + np.float32(0.33)
    assert (in_f32 != tab[:, :, 0].ravel()).any()
    th = _draws(8, 0.2)
    ref = np.asarray(J.survey_fused(jspec, obs, tf, y0, th, substeps=2,
                                    tile_chains=128, interpret=True))
    got = T.survey_fused(tspec, TM.obsdata_from_arrays(obs), tf, y0,
                         torch.as_tensor(th), substeps=2).numpy()
    np.testing.assert_allclose(got, ref, rtol=5e-5)
    assert fold_host(("sub", ("f", "g"), ("c", (0.3).hex())),
                     {"g": g}) == g - 0.3


# --- the twins against the JAX kernels ----------------------------------

@pytest.mark.parametrize("stepper", ["dopri5", "rk4", "kvaerno3"])
@pytest.mark.parametrize("mode", MODES)
def test_survey_twin_matches_pallas_interpret(forced_data, mode, stepper):
    """8 draws: chi within 5e-5 relative, the bound the unforced survey is
    held to (tests/test_torch_stiff_kernels.py); one step an interval (the
    interpret-mode kernels' compiles grow with the steps)."""
    obs, tf, y0 = forced_data
    jspec, tspec = _specs(mode)
    th = _draws(8, 0.2)
    ref = np.asarray(J.survey_fused(jspec, obs, tf, y0, th, substeps=1,
                                    stepper=stepper, tile_chains=128,
                                    interpret=True))
    got = T.survey_fused(tspec, TM.obsdata_from_arrays(obs), tf, y0,
                         torch.as_tensor(th), substeps=1,
                         stepper=stepper).numpy()
    # one Kvaerno3 step an interval diverges on the widest draws, in both
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin.sum() >= 6
    np.testing.assert_allclose(got[fin], ref[fin], rtol=5e-5)


# --- g == 1 and the adaptive solver --------------------------------------

def _ref_style(y, t, ps, u):
    mu, phi, beta = ps[0], ps[1], ps[2]
    S, V = y[0], y[1]
    dS = mu * u["g"] * S - phi * S * V
    dV = beta * phi * S * V - phi * S * V
    return np.array([dS, dV])


def test_unit_forcing_equals_unforced_model():
    """tests/test_forcings.py's test_framework_forcings_end_to_end on the
    port: with g = 1 the forced framework's chi equals the unforced one
    within 1e-10, and its MH posterior is bitwise the unforced run's
    (f32(1) x mu is exact)."""
    kw = dict(mu=0.6, phi=2.4e-8, beta=24.0, t_end=3.1, t_steps=144,
              device="cpu")
    forced = odelib_tpu_torch.ModelFramework(
        _ref_style, list(PN), list(SN), dataframe=synthetic_df(),
        forcings={"g": ([0.0, 3.2], [1.0, 1.0])}, **kw)
    plain = odelib_tpu_torch.ModelFramework(
        zero_i, list(PN), list(SN), dataframe=synthetic_df(), **kw)
    np.testing.assert_allclose(forced.get_fitstats()["Chi"],
                               plain.get_fitstats()["Chi"], rtol=1e-10)
    run = dict(chain_inits=[{"mu": 0.6, "phi": 2.4e-8, "beta": 24.0}] * 16,
               iterations_per_chain=12, substeps=1, print_report=False)
    a, b = forced.MCMC(**run), plain.MCMC(**run)
    pd.testing.assert_frame_equal(a, b, check_exact=True)


@pytest.mark.parametrize("mode,cumint", [("linear", _cumint_linear),
                                         ("hold", _cumint_hold)])
def test_forced_growth_matches_closed_form(mode, cumint):
    """tests/test_forcings.py's closed form through the port's adaptive
    Dopri5 (the forcings at tensor times)."""
    spec = TM.make_spec(adapt_rhs(growth_rhs, "jax"), ("r",), ("N",),
                        forcings={"T": (FT, FV, mode)})
    times = np.linspace(0.0, 5.0, 41)
    r = 0.7
    ys = TM.integrate_theta(spec, torch.tensor([[r]], dtype=torch.float64),
                            torch.tensor([[2.0]], dtype=torch.float64),
                            times, method="dopri5", rtol=1e-8, atol=1e-10)
    exact = 2.0 * np.exp([r * cumint(FT, FV, t) for t in times])
    np.testing.assert_allclose(ys[:, 0, 0].numpy(), exact,
                               rtol=1e-6 if mode == "linear" else 1e-3)


def test_forced_framework_mcmc_on_cpu():
    """The forced framework through MCMC (MH, ensemble, PT) on the CPU:
    the reference's posterior columns and finite chi."""
    fw = odelib_tpu_torch.ModelFramework(
        _ref_style, list(PN), list(SN), dataframe=synthetic_df(),
        forcings={"g": ([0.0, 1.5, 3.2], [0.5, 2.0, 0.5])},
        mu=odelib_tpu_torch.parameter(scipy.stats.lognorm,
                                      {"s": 0.5, "scale": 0.6}),
        phi=odelib_tpu_torch.parameter(scipy.stats.lognorm,
                                       {"s": 0.5, "scale": 2.4e-8}),
        beta=odelib_tpu_torch.parameter(scipy.stats.lognorm,
                                        {"s": 0.5, "scale": 24.0}),
        t_end=3.1, t_steps=48, device="cpu")
    for sampler in ("mh", "pt"):
        post = fw.MCMC(chain_inits=4, iterations_per_chain=10,
                       fitsurvey_samples=64, substeps=1, sampler=sampler,
                       print_report=False)
        assert list(post.columns)[:5] == ["mu", "phi", "beta", "chi",
                                          "rsquared"]
        assert np.isfinite(post["chi"]).all()
