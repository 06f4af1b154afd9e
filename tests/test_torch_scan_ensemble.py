"""The scan ensemble (odelib_tpu_torch/samplers/ensemble.py) against
odelib_tpu's XLA ensemble_mh (one ensemble, no mesh) on the CPU in float64
from the same walkers and key: 8 walkers x 20 iterations, all walked and
with a pinned slot; accept sequences exact, theta and chi within 1e-8
relative (measured ~1e-14: the stretch move's multiply-adds are fused as
XLA:CPU fuses them). The reference's checks (walker counts, stretch
scale, the mixing warning) and the one-ensemble rule (a mesh raises)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from odelib_tpu.data import obsdata_to_device
from odelib_tpu.samplers import ensemble_mh as jax_ensemble
from odelib_tpu_torch import random as R
from odelib_tpu_torch.model import obsdata_from_arrays
from odelib_tpu_torch.samplers.ensemble import ensemble_mh

from test_torch_scan_mh import assert_same, chains
from test_torch_survey import setup  # noqa: F401  (module fixture)


@pytest.mark.parametrize("walk_mask", [None, [1.0, 0.0, 1.0]],
                         ids=["all-walked", "pinned-phi"])
def test_scan_ensemble_matches_reference(setup, walk_mask):  # noqa: F811
    spec, tspec, obs, tf, y0 = setup
    th0 = chains(8, seed=11)
    kw = dict(nits=20, burnin=6)
    ref = jax_ensemble(spec, obsdata_to_device(obs), jnp.asarray(tf),
                       jnp.asarray(y0), jnp.asarray(th0),
                       jax.random.fold_in(jax.random.PRNGKey(0), 0xE75),
                       walk_mask=None if walk_mask is None
                       else jnp.asarray(walk_mask), **kw)
    got = ensemble_mh(tspec, obsdata_from_arrays(obs), tf, y0, th0,
                      R.fold_in(R.PRNGKey(0), 0xE75), walk_mask=walk_mask,
                      device="cpu", **kw)
    assert got.theta.shape == (8, 13, 3)
    assert_same(got, ref)
    assert 0 < float(got.acceptance_ratio[:, -1].mean()) < 1
    if walk_mask is not None:     # the pinned slot keeps its jittered start
        fixed = got.theta[:, :, 1].numpy()
        assert (fixed == fixed[:, :1]).all()


def test_scan_ensemble_checks(setup):  # noqa: F811
    spec, tspec, obs, tf, y0 = setup
    args = (tspec, obsdata_from_arrays(obs), tf, y0)
    key = R.PRNGKey(0)
    for n, a, msg in ((3, 2.0, "even number of walkers"),
                      (6, 1.0, "stretch scale")):
        with pytest.raises(ValueError, match=msg):
            ensemble_mh(*args, chains(n), key, nits=4, a=a, device="cpu")
    with pytest.raises(NotImplementedError, match="one ensemble"):
        ensemble_mh(*args, chains(4), key, nits=4, mesh=object(),
                    device="cpu")
    with pytest.warns(UserWarning, match="at least 6"):
        out = ensemble_mh(*args, chains(4), key, nits=4, device="cpu")
    assert out.theta.shape == (4, 1, 3)
