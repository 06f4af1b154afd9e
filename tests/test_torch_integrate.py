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
