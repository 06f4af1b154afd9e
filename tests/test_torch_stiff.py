"""The stiff path on the CPU, each piece held against odelib_tpu on the
same numpy-seeded inputs: the traced RHS's Jacobian against
``jax.jacfwd``, the fixed-step Kvaerno3 twin against the JAX stepper,
``odeint_fixed``/``odeint_grid``/``odeint_grid_batch`` with the implicit
methods, ``calibrate_substeps(method='kvaerno5')`` and
``auto_stiff_grid``; ``MCMC(method='kvaerno3')`` end to end against
odelib_tpu's fused backend, and JointFit's stepper under
``method='kvaerno3'``. The kernels' twins with ``stepper='kvaerno3'`` are
in tests/test_torch_stiff_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odelib_tpu
import odelib_tpu_torch
from odelib_tpu import models as jm
from odelib_tpu.distributions import LogNormal as JLogNormal
from odelib_tpu.model import make_spec as j_make_spec
from odelib_tpu.ops import integrate as JI
from odelib_tpu.ops import pallas_joint as JJ
from odelib_tpu.ops import schedule as JS
from odelib_tpu.ops.runge_kutta import kvaerno3_fixed_step as j_kv3
from odelib_tpu_torch import models as tm
from odelib_tpu_torch.distributions import LogNormal
from odelib_tpu_torch.model import make_spec, state_func, state_jac
from odelib_tpu_torch.ops import cuda_joint as TJ
from odelib_tpu_torch.ops import integrate as TI
from odelib_tpu_torch.ops import schedule as TS
from odelib_tpu_torch.ops.runge_kutta import kvaerno3_fixed_step
from odelib_tpu_torch.rhs import RhsProgram, RhsTraceError, adapt_rhs, \
    trace_rhs

from scoring_cases import ROBERTSON_TIMES, robertson_frame
from test_torch_api import _INITS, _framework
from test_torch_joint import _zero_i_pair
from test_torch_obs_models import draws

ROB = tuple(tm.robertson.default_theta)


def _program(name):
    m = tm.get(name)
    return trace_rhs(adapt_rhs(m.rhs, "jax"), len(m.snames), len(m.pnames))


def _lanes(name, n, seed=0):
    """States and parameters of ``n`` lanes around the model's defaults,
    float64 (states of zero default scaled from the largest)."""
    m = tm.get(name)
    rng = np.random.default_rng(seed)
    y0 = np.abs(np.asarray(m.default_y0, float))
    y0 = np.maximum(y0, 1e-2 * y0.max())
    y = y0[:, None] * np.exp(rng.normal(0, 0.3, (len(y0), n)))
    p = np.asarray(m.default_theta, float)[:, None] * np.exp(
        rng.normal(0, 0.2, (len(m.pnames), n)))
    return y, p


def _jax_jacobian(rhs, y, p):
    """(S, S, N) d f_i / d y_j of the JAX RHS by ``jax.jacfwd``."""
    J = jax.vmap(jax.jacfwd(lambda yy, pp: jnp.stack(list(rhs(0.0, yy, pp)))),
                 in_axes=(1, 1))(jnp.asarray(y), jnp.asarray(p))
    return np.moveaxis(np.asarray(J), 0, -1)


@pytest.mark.parametrize("name", ["zero_i", "one_i", "pk_oral", "robertson",
                                  "vanderpol", "oregonator"])
def test_jacobian_columns_match_jacfwd(name):
    """The traced DAG's forward-mode columns against ``jax.jacfwd`` of the
    JAX package's RHS, float64, 16 lanes: within rtol 1e-12."""
    y, p = _lanes(name, 16)
    S = y.shape[0]
    got = _program(name).jacobian().evaluate(
        0.0, list(torch.as_tensor(y)), list(torch.as_tensor(p)))
    got = torch.stack(got).reshape(S, S, -1).numpy()
    ref = _jax_jacobian(jm.get(name).rhs, y, p)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-300)


def _every_op(t, y, ps):
    """Every operation the tracer admits, on two states."""
    a, b = y[0], y[1]
    k, c = ps
    u = jnp.where(a > b, a * b, a / b) + jnp.abs(a - 2.0 * b)
    v = jnp.sqrt(a) * jnp.exp(-k * b) + jnp.log(b) ** 3 + a ** -2
    w = jnp.minimum(a, c * b) - jnp.maximum(b, c) + a ** 1.5 + c ** b
    return jnp.stack([u + v - w, -(u * w) / (1.0 + v)])


def test_jacobian_rules_of_every_op():
    """Each operation's rule (``where``, comparisons, ``abs``, ``sqrt``,
    ``exp``, ``log``, integer and float powers, ``minimum``/``maximum``,
    division, negation) against ``jax.jacfwd`` of the same function,
    float64; an operation without a rule raises ``RhsTraceError``."""
    rng = np.random.default_rng(4)
    y = rng.uniform(0.5, 3.0, (2, 32))
    p = np.stack([rng.uniform(0.1, 1.0, 32), rng.uniform(0.5, 2.0, 32)])
    prog = trace_rhs(adapt_rhs(_every_op, "jax"), 2, 2)
    got = torch.stack(prog.jacobian().evaluate(
        0.0, list(torch.as_tensor(y)), list(torch.as_tensor(p)))).reshape(
            2, 2, -1).numpy()
    np.testing.assert_allclose(got, _jax_jacobian(_every_op, y, p),
                               rtol=1e-12)
    g = prog._graph
    erf = g.node("erf", (prog.outputs[0],))
    with pytest.raises(RhsTraceError, match="'erf'"):
        RhsProgram(g, [erf, prog.outputs[1]], 2, 2).jacobian()


def _robertson_states():
    """Robertson's states on its config-5 grid from (1, 0, 0), by the
    port's adaptive Kvaerno5 at rtol 1e-10 (float64)."""
    spec = make_spec(adapt_rhs(tm.robertson.rhs, "jax"), tm.robertson.pnames,
                     tm.robertson.snames)
    sol = TI.odeint_grid(state_func(spec), torch.tensor(
        [1.0, 0.0, 0.0], dtype=torch.float64), ROBERTSON_TIMES,
        [torch.tensor(v, dtype=torch.float64) for v in ROB], rtol=1e-10,
        atol=1e-14, method="kvaerno5", jac=state_jac(spec))
    return sol.ys.numpy()


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10),
                                        (np.float32, 1e-5)])
@pytest.mark.parametrize("name", ["robertson", "zero_i"])
def test_kvaerno3_fixed_step_matches_jax(name, dtype, rtol):
    """The twin's step (the traced Jacobian, its elimination order) on 8
    lanes against the jitted JAX ``kvaerno3_fixed_step`` (``jax.jvp``
    columns): float64 within 1e-10, float32 within 1e-5 (the symbolic
    columns and ``jvp`` round differently). Robertson from states on its
    trajectory with that interval's eighth as the step, the rates of the
    lanes jittered by 10 % up to t = 0.1 (later, a step of up to 57 from a
    state off the lanes' own trajectories leaves the four chord-Newton
    iterations unconverged, in both packages); zero_i from states around
    the demo's with h = 0.25."""
    prog = _program(name)
    rng = np.random.default_rng(1)
    if name == "robertson":
        ys = _robertson_states()
        cases = [(ROBERTSON_TIMES[k], ys[k][:, None].repeat(8, 1),
                  (ROBERTSON_TIMES[k + 1] - ROBERTSON_TIMES[k]) / 8,
                  0.1 if k < 20 else 0.0) for k in (1, 5, 12, 24, 30)]
        centre = np.asarray(ROB)
    else:
        cases = [(0.5, np.array([5.2e6, 1.1e7])[:, None] * np.exp(
            rng.normal(0, 0.05, (2, 8))), 0.25, 0.1)]
        centre = np.array([0.6, 2.4e-8, 24.0])
    for t, y, h, sd in cases:
        yl = y.astype(dtype)
        pl = (centre[:, None] * np.exp(rng.normal(0, sd, (3, 8)))
              ).astype(dtype)
        ref = np.asarray(jax.jit(lambda yy, pp: j_kv3(
            lambda tt, z, q: jnp.stack(list(jm.get(name).rhs(tt, z, q))),
            t, yy, h, list(pp)))(jnp.asarray(yl), jnp.asarray(pl)))
        got = torch.stack(kvaerno3_fixed_step(
            prog.evaluate, t, list(torch.as_tensor(yl)), h,
            list(torch.as_tensor(pl)), prog.jacobian().evaluate)).numpy()
        assert got.dtype == dtype and np.isfinite(ref).all()
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)


def _rober_t(t, y, k):
    return torch.stack(list(tm.robertson.rhs(t, y, k)))


def _rober_j(t, y, k):
    return jnp.stack(list(jm.robertson.rhs(t, y, k)))


def _rates(n, seed=2, sd=0.1):
    rng = np.random.default_rng(seed)
    return np.asarray(ROB) * np.exp(rng.normal(0, sd, (n, 3)))


def test_odeint_fixed_kvaerno3_matches_jax():
    """bench/suite.py's config-5 solve: fixed Kvaerno3, 8 substeps on the
    geomspace grid, 4 lanes, float64 (the forward-mode columns of a plain
    torch RHS): within rtol 1e-8 of the JAX package's."""
    ks = _rates(4)
    got = TI.odeint_fixed(_rober_t, torch.tensor([1.0, 0.0, 0.0],
                                                 dtype=torch.float64)
                          [:, None].expand(-1, 4).clone(), ROBERTSON_TIMES,
                          torch.as_tensor(ks).t(), substeps=8,
                          method="kvaerno3")
    ref = jax.vmap(lambda k: JI.odeint_fixed(
        _rober_j, jnp.array([1.0, 0.0, 0.0]), jnp.asarray(ROBERTSON_TIMES),
        k, substeps=8, method="kvaerno3").ys)(jnp.asarray(ks))
    assert bool(got.ok.all())
    np.testing.assert_allclose(got.ys.numpy(),
                               np.moveaxis(np.asarray(ref), 0, -1),
                               rtol=1e-8, atol=1e-20)


def _dose(times):
    D = np.zeros((len(times), 3))
    D[10, 0] = 0.1         # y1 += 0.1 when the solve leaves ts[10]
    return D


@pytest.mark.parametrize("dosed", [False, True], ids=["undosed", "dosed"])
@pytest.mark.parametrize("method", ["kvaerno3", "kvaerno5", "auto"])
def test_odeint_grid_stiff_methods_match_jax(method, dosed):
    """Adaptive Kvaerno3, Kvaerno5 and 'auto' (Dopri5, failing on every
    stiff lane at its 500 steps, then Kvaerno5) on Robertson, 3 lanes
    (the traced Jacobian), float64, with and without a dose: ys within
    rtol 1e-8, ok, step counts and accepted steps per output equal."""
    ks = _rates(3, seed=3)
    times = ROBERTSON_TIMES[::2]
    dose = _dose(times) if dosed else None
    kw = dict(rtol=1e-6, atol=1e-10, max_steps=500, method=method, dose=dose)
    spec = make_spec(adapt_rhs(tm.robertson.rhs, "jax"), tm.robertson.pnames,
                     tm.robertson.snames)
    got = TI.odeint_grid(state_func(spec), torch.tensor(
        [[1.0] * 3, [0.0] * 3, [0.0] * 3], dtype=torch.float64), times,
        list(torch.as_tensor(ks).t()), jac=state_jac(spec), **kw)
    ref = jax.vmap(lambda k: JI.odeint_grid(
        _rober_j, jnp.array([1.0, 0.0, 0.0]), jnp.asarray(times), k,
        **kw))(jnp.asarray(ks))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    assert bool(got.ok.all())
    np.testing.assert_array_equal(got.num_steps.numpy(),
                                  np.asarray(ref.num_steps))
    np.testing.assert_array_equal(got.accepted_at.numpy(),
                                  np.asarray(ref.accepted_at).T)
    np.testing.assert_allclose(got.ys.numpy(),
                               np.moveaxis(np.asarray(ref.ys), 0, -1),
                               rtol=1e-8, atol=1e-20)


def test_odeint_grid_batch_matches_jax():
    """The two-pass partitioned fallback on 6 Robertson lanes, two of them
    with k2 = 3 (not stiff: the Dopri5 probe passes them): ys within rtol
    1e-8, ok and step counts (probe plus stiff pass) equal."""
    ks = _rates(6, seed=5)
    ks[[1, 4], 1] = 3.0
    times = np.linspace(0.0, 40.0, 9)
    kw = dict(rtol=1e-6, atol=1e-10, max_steps=2000, probe_max_steps=300)
    got = TI.odeint_grid_batch(_rober_t, np.array([1.0, 0.0, 0.0]), times,
                               list(torch.as_tensor(ks).t()), **kw)
    ref = JI.odeint_grid_batch(_rober_j, np.array([1.0, 0.0, 0.0]), times,
                               jnp.asarray(ks), **kw)
    ok = np.asarray(ref.ok)
    assert ok.all()
    np.testing.assert_array_equal(got.ok.numpy(), ok)
    np.testing.assert_array_equal(got.num_steps.numpy(),
                                  np.asarray(ref.num_steps))
    assert got.num_steps[1] < 300 < got.num_steps[0]
    np.testing.assert_allclose(got.ys.numpy(),
                               np.moveaxis(np.asarray(ref.ys), 0, -1),
                               rtol=1e-8, atol=1e-20)


def test_calibrate_substeps_kvaerno5_matches_jax():
    """What a kvaerno3 run calibrates with: Kvaerno5 over 24 draws on
    Robertson's config-5 grid, through the ModelSpec (the traced
    Jacobian): the JAX package's schedule."""
    thetas = _rates(24, seed=6, sd=0.2)
    tspec = make_spec(adapt_rhs(tm.robertson.rhs, "jax"),
                      tm.robertson.pnames, tm.robertson.snames)
    jspec = j_make_spec(jm.robertson.rhs, jm.robertson.pnames,
                        jm.robertson.snames)
    kw = dict(rtol=1e-6, atol=1e-10, method="kvaerno5", max_steps=2000)
    got = TS.calibrate_substeps(tspec, [1.0, 0.0, 0.0], ROBERTSON_TIMES,
                                thetas, **kw)
    ref = JS.calibrate_substeps(jspec, np.array([1.0, 0.0, 0.0]),
                                ROBERTSON_TIMES, thetas, **kw)
    assert got == ref and len(got) == 31 and max(got) > min(got)


def test_auto_stiff_grid_matches_jax():
    """bench/suite.py's config-5 call: a naive linspace(0, 1e3, 32), an
    8-lane Kvaerno5 pilot at rtol 1e-5, atol 1e-8: the same schedule and
    output indices as the JAX package's, and its grid to rtol 1e-6 (the
    nodes are the pilot's accepted step ends, and the controller carries
    the last bits of two Jacobians' rounding into its step sizes, ~5e-8
    relative); the requested times are grid nodes."""
    ks = _rates(8)
    times = np.linspace(0.0, 1e3, 32)
    kw = dict(rtol=1e-5, atol=1e-8, max_steps=2000)
    grid, sched, oidx = TS.auto_stiff_grid(
        _rober_t, [1.0, 0.0, 0.0], times, list(torch.as_tensor(ks).t()), **kw)
    rgrid, rsched, roidx = JS.auto_stiff_grid(
        _rober_j, jnp.array([1.0, 0.0, 0.0]), times, jnp.asarray(ks), **kw)
    np.testing.assert_allclose(grid, np.asarray(rgrid), rtol=1e-6, atol=0)
    assert sched == rsched and len(sched) == len(grid) - 1
    np.testing.assert_array_equal(oidx, np.asarray(roidx))
    np.testing.assert_array_equal(grid[oidx], times)
    assert len(grid) > len(times) and grid[1] < 1e-3


def test_robertson_default_grid_diverges_in_both_packages():
    """The Robertson fit on the framework's default grid (1,000 points
    over [0, 1e3], spaced ~1.001): the observations from 1e-5 to 0.5 snap
    to t = 0 and 1, and fixed Kvaerno3 on the schedule Kvaerno5
    calibrates on the compact grid (the JAX package's; the port's equals
    it, ``test_calibrate_substeps_kvaerno5_matches_jax``) from y2 = 0 is
    not finite in either package at the default rates, float64 (the
    step's one Jacobian at y2 = 0 holds none of the stiffness over
    [0, 1]): a matched quirk.
    chip_smoke.py's fit takes a grid spaced 1e-3 (``ROBERTSON_T_STEPS``);
    tools/robertson_default_grid.py runs both packages' MCMC on this grid."""
    df = robertson_frame()
    tfw = tm.get("robertson").framework(df, device="cpu")
    jfw = jm.get("robertson").framework(df)
    tf = np.asarray(tfw._times_fit)
    np.testing.assert_array_equal(tf, np.asarray(jfw._times_fit))
    assert len(tf) == 13 and tf[1] == pytest.approx(1.001, rel=1e-3)
    y0 = np.asarray(tfw.get_inits(), float)
    thetas = _rates(16, seed=7)
    kw = dict(rtol=1e-6, atol=1e-4, method="kvaerno5", max_steps=4096)
    sched = JS.calibrate_substeps(jfw._spec, y0, tf, thetas, **kw)
    assert len(sched) == 12 and sched[0] > 1
    got = TI.odeint_fixed(_rober_t, torch.as_tensor(y0)[:, None], tf,
                          [torch.tensor([k], dtype=torch.float64)
                           for k in ROB], substeps=list(sched),
                          method="kvaerno3")
    ref = JI.odeint_fixed(_rober_j, jnp.asarray(y0), jnp.asarray(tf),
                          jnp.asarray(ROB), substeps=tuple(sched),
                          method="kvaerno3")
    assert not bool(got.ok.all()) and not np.isfinite(got.ys[-1].numpy()).all()
    assert not np.isfinite(np.asarray(ref.ys)[-1]).all()


def test_output_index_raises_where_jax_asserts():
    """The snap of requested times to grid nodes: the port raises
    ``ValueError`` where the JAX package's bare ``assert`` guards it (a
    requested time more than 1e-4 relative from every node)."""
    grid = np.array([0.0, 1.0, 2.0, 4.0])
    np.testing.assert_array_equal(
        TS.output_index(grid, np.array([0.0, 2.0, 4.0])), [0, 2, 3])
    with pytest.raises(ValueError, match="rtol 1e-4"):
        TS.output_index(grid, np.array([0.0, 3.0, 4.0]))


def test_mcmc_kvaerno3_matches_odelib_tpu():
    """``MCMC(method='kvaerno3')`` with injected chain_inits, as
    tests/test_torch_api.py runs dopri5: the posterior's accept sequences
    exactly, values within the MH parity tolerances."""
    kw = dict(chain_inits=_INITS, iterations_per_chain=12, burnin=4,
              method="kvaerno3", print_report=False)
    ref = _framework(odelib_tpu).MCMC(backend="pallas", pallas_interpret=True,
                                      pallas_tile_chains=128, **kw)
    got = _framework(odelib_tpu_torch, device="cpu").MCMC(**kw)
    assert list(got.columns) == list(ref.columns)
    for col in ("iteration", "chain#", "all_rejected", "acceptance_ratio"):
        np.testing.assert_array_equal(got[col].to_numpy(),
                                      ref[col].to_numpy())
    assert 0 < got["acceptance_ratio"].iloc[-1] < 1
    for col, rtol in (("mu", 1e-5), ("phi", 1e-5), ("beta", 1e-5),
                      ("chi", 5e-5), ("aic", 5e-5)):
        np.testing.assert_allclose(got[col].to_numpy(), ref[col].to_numpy(),
                                   rtol=rtol, err_msg=col)


class _Stop(Exception):
    pass


def test_jointfit_kvaerno3_runs_dopri5_in_both_packages(monkeypatch):
    """``JointFit.MCMC(method='kvaerno3')``: both packages hand the joint
    kernel the dopri5 stepper (odelib_tpu/joint.py maps every method but
    rk4 to it); the port's joint kernel holds dopri5 and rk4 and refuses
    kvaerno3."""
    seen = {}

    def stub(pkg):
        def joint(*args, stepper, **kw):
            seen[pkg] = stepper
            raise _Stop
        return joint
    monkeypatch.setattr(JJ, "joint_metropolis_hastings_fused",
                        stub("odelib_tpu"))
    monkeypatch.setattr(TJ, "joint_metropolis_hastings_fused",
                        stub("odelib_tpu_torch"))
    kw = dict(chain_inits=4, iterations_per_chain=6, fitsurvey_samples=32,
              print_report=False, method="kvaerno3")
    for pkg, dist, extra in ((odelib_tpu, JLogNormal,
                              dict(backend="pallas", pallas_interpret=True)),
                             (odelib_tpu_torch, LogNormal, {})):
        fws = _zero_i_pair(pkg, dist, **({} if pkg is odelib_tpu
                                         else dict(device="cpu")))
        with pytest.raises(_Stop):
            pkg.JointFit(fws, shared=["phi", "beta"],
                         random_seed=3).MCMC(**kw, **extra)
    assert seen == {"odelib_tpu": "dopri5", "odelib_tpu_torch": "dopri5"}
    monkeypatch.undo()
    with pytest.raises(ValueError, match="dopri5, rk4"):
        TJ.joint_metropolis_hastings_fused(
            [fws["a"]._spec], [(0, 1, 2)], [fws["a"]._obsdata_fit_host],
            [fws["a"]._times_fit], [fws["a"].get_inits()],
            torch.as_tensor(draws([0.6, 2.4e-8, 24.0], 4, 0.03)), 0,
            nits=4, burnin=1, stepper="kvaerno3")
