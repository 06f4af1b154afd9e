"""Adaptive Dopri5 ``odeint_grid`` of the port against odelib_tpu's and
scipy's LSODA, in float64, on the infection models."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import odeint as lsoda

from odelib_tpu.ops.integrate import odeint_grid as jax_odeint_grid
from odelib_tpu_torch.model import make_spec
from odelib_tpu_torch.models import one_i as t_one_i
from odelib_tpu_torch.models import zero_i as t_zero_i
from odelib_tpu_torch.ops.integrate import odeint_grid
from odelib_tpu_torch.rhs import adapt_rhs
from odelib_tpu_torch.samplers.mh import state_func

from helpers import one_i, zero_i

_CASES = {
    "zero_i": (zero_i, t_zero_i, [0.6, 2.4e-8, 24.0], [5.2e6, 1.1e7]),
    "one_i": (one_i, t_one_i, [0.6, 2.4e-8, 20.0, 3.0], [5.2e6, 0.0, 1.1e7]),
}
_TOL = dict(rtol=1e-6, atol=1e-4)


def _port_func(name):
    _, tmodel, _, _ = _CASES[name]
    spec = make_spec(adapt_rhs(tmodel.rhs, "jax"), tmodel.pnames,
                     tmodel.snames)
    return state_func(spec)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_odeint_grid_matches_jax_and_lsoda(name):
    jfn, _, theta, y0 = _CASES[name]
    ts = np.linspace(0.0, 3.0, 40)
    got = odeint_grid(_port_func(name), torch.tensor(y0, dtype=torch.float64),
                      ts, list(torch.tensor(theta, dtype=torch.float64)),
                      **_TOL)
    assert got.ok and got.ys.shape == (40, len(y0))
    ref = jax_odeint_grid(lambda t, y, th: jfn(t, y, th), jnp.asarray(y0),
                          jnp.asarray(ts), jnp.asarray(theta), **_TOL)
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(ref.ys), rtol=1e-6)
    np.testing.assert_array_equal(got.accepted_at.numpy(),
                                  np.asarray(ref.accepted_at))
    # against LSODA both solve tightly, so the comparison sees the solver,
    # not the tolerance setting's global error
    tight = odeint_grid(_port_func(name),
                        torch.tensor(y0, dtype=torch.float64), ts,
                        list(torch.tensor(theta, dtype=torch.float64)),
                        rtol=1e-10, atol=1e-6)
    ls = lsoda(lambda y, t: np.asarray(jfn(t, y, theta)), y0, ts,
               rtol=1e-10, atol=1e-6)
    np.testing.assert_allclose(tight.ys.numpy(), ls, rtol=1e-6, atol=1e-3)


def test_batched_lanes_equal_single_solves():
    """Per-lane done masks: each lane of a batched solve is bitwise the
    lone solve of that lane, including a lane that fails."""
    f = _port_func("zero_i")
    ts = np.linspace(0.0, 3.0, 25)
    th = torch.tensor([[0.6, 2.4e-8, 24.0], [1.2, 1e-8, 40.0],
                       [60.0, 2.4e-8, 24.0]], dtype=torch.float64)
    y0 = torch.tensor([5.2e6, 1.1e7], dtype=torch.float64)
    kw = dict(rtol=1e-6, atol=1e-4, max_steps=300)
    batch = odeint_grid(f, y0[:, None].expand(2, 3), ts, list(th.t()), **kw)
    for n in range(3):
        one = odeint_grid(f, y0, ts, list(th[n]), **kw)
        np.testing.assert_array_equal(batch.ys[:, :, n].numpy(),
                                      one.ys.numpy())
        assert bool(batch.ok[n]) == one.ok
    assert not bool(batch.ok[2])
    assert torch.isnan(batch.ys[-1, :, 2]).all()


@pytest.mark.parametrize("method,substeps", [("rk4", 3), ("dopri5", 2),
                                             ("rk4", (1, 2, 3, 1, 2, 3, 1, 2,
                                                      3))])
def test_odeint_fixed_matches_jax(method, substeps):
    """Fixed steps, uniform or a per-interval schedule, float64."""
    from odelib_tpu.ops.integrate import odeint_fixed as jax_odeint_fixed
    from odelib_tpu_torch.ops.integrate import odeint_fixed
    jfn, _, theta, y0 = _CASES["zero_i"]
    ts = np.linspace(0.0, 3.0, 10)
    got = odeint_fixed(_port_func("zero_i"),
                       torch.tensor(y0, dtype=torch.float64), ts,
                       list(torch.tensor(theta, dtype=torch.float64)),
                       substeps=substeps, method=method)
    ref = jax_odeint_fixed(lambda t, y, th: jfn(t, y, th), jnp.asarray(y0),
                           jnp.asarray(ts), jnp.asarray(theta),
                           substeps=substeps if isinstance(substeps, int)
                           else list(substeps), method=method)
    assert got.ok and got.ys.dtype == torch.float64
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(ref.ys),
                               rtol=1e-12)


@pytest.mark.parametrize("method", ["dopri5", "rk4", "fixed_dopri5"])
def test_chi_of_theta_matches_jax(method):
    """A batch of thetas scored by the port's chi_of_theta against the JAX
    package's, vmapped, in float64 (one_i: summed observable H = S + I1
    and an adaptive failure-free grid)."""
    import jax
    from helpers import demo_df
    from odelib_tpu.data import (build_obsdata_host,
                                 compact_observation_grid, format_dataframe)
    from odelib_tpu.model import chi_of_theta as jax_chi_of_theta
    from odelib_tpu.model import make_spec as jax_make_spec
    from odelib_tpu_torch.model import chi_of_theta
    jfn, tmodel, theta, _ = _CASES["one_i"]
    df = format_dataframe(demo_df().replace({"S": "H"}), ("S", "I1", "V"))
    times = np.linspace(0, df["time"].max(), 64)
    jspec = jax_make_spec(jfn, tmodel.pnames, tmodel.snames,
                          {"H": ["S", "I1"]})
    obs, _ = build_obsdata_host(df, times, jspec.post_snames)
    tf, obs = compact_observation_grid(obs, times)
    y0 = np.array([df.loc["H"].iloc[0]["abundance"], 0.0,
                   df.loc["V"].iloc[0]["abundance"]])
    thetas = np.asarray(theta) * np.exp(np.random.default_rng(0).normal(
        0, 0.2, (12, 4)))
    ref = np.asarray(jax.vmap(lambda th: jax_chi_of_theta(
        jspec, obs, th, jnp.asarray(y0), jnp.asarray(tf), method=method,
        substeps=2))(jnp.asarray(thetas)))
    tspec = make_spec(adapt_rhs(tmodel.rhs, "jax"), tmodel.pnames,
                      tmodel.snames, {"H": ["S", "I1"]})
    got = chi_of_theta(tspec, obs, torch.as_tensor(thetas), y0, tf,
                       method=method, substeps=2)
    assert got.dtype == torch.float64 and np.isfinite(ref).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9)
