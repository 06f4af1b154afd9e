"""The scan parallel tempering (odelib_tpu_torch/samplers/pt.py) against
odelib_tpu's XLA sampler on the CPU in float64 from the same starts and
keys: 8 chains x 4 rungs x 20 iterations (swaps every round, and every
other with a pinned slot); accept sequences and swap counts exact, theta
and chi within 1e-8 relative. Checkpointed in chunks and killed and
resumed, bitwise the whole run (port only); ``tune_ladder`` over 2 rounds
of 20 pilot iterations returns the reference's ladder within 1e-12 and the
same pilot acceptance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from odelib_tpu.data import obsdata_to_device
from odelib_tpu.samplers import parallel_tempering as jax_pt
from odelib_tpu.samplers import tune_ladder as jax_tune
from odelib_tpu_torch import random as R
from odelib_tpu_torch.model import obsdata_from_arrays
from odelib_tpu_torch.samplers import pt as T

from test_torch_scan_mh import assert_same, chains, keys
from test_torch_survey import setup  # noqa: F401  (module fixture)


@pytest.mark.parametrize("swap_every,walk_mask", [(1, None),
                                                   (2, [1.0, 0.0, 1.0])],
                         ids=["swap-1", "swap-2-pinned"])
def test_scan_pt_matches_reference(setup, swap_every, walk_mask):  # noqa
    spec, tspec, obs, tf, y0 = setup
    th0 = chains(8, seed=21)
    jk, tk = keys(8, seed=4)
    kw = dict(nits=20, burnin=6, swap_every=swap_every)
    ref, ref_rate = jax_pt(spec, obsdata_to_device(obs), jnp.asarray(tf),
                           jnp.asarray(y0), jnp.asarray(th0), jk,
                           walk_mask=None if walk_mask is None
                           else jnp.asarray(walk_mask), **kw)
    got, rate = T.parallel_tempering(tspec, obsdata_from_arrays(obs), tf,
                                     y0, th0, tk, walk_mask=walk_mask,
                                     device="cpu", **kw)
    assert rate.shape == (8, 3)
    np.testing.assert_array_equal(rate.numpy(), np.asarray(ref_rate))
    assert_same(got, ref)
    assert 0 < float(rate.mean()) <= 1


def test_scan_pt_checkpointed_bitwise(setup, tmp_path):  # noqa: F811
    spec, tspec, obs, tf, y0 = setup
    obs = obsdata_from_arrays(obs)
    _, tk = keys(5, seed=8)
    th0 = chains(5, seed=13)
    kw = dict(nits=17, burnin=5, temperatures=(1.0, 1.7, 3.0),
              device="cpu")
    whole = T.parallel_tempering(tspec, obs, tf, y0, th0, tk, **kw)
    path = str(tmp_path / "pt.progress")
    ck = dict(checkpoint_every=6, checkpoint_path=path, **kw)
    chunked = T.parallel_tempering_checkpointed(tspec, obs, tf, y0, th0, tk,
                                                **ck)
    assert T.parallel_tempering_checkpointed(
        tspec, obs, tf, y0, th0, tk, _stop_after_chunks=1, **ck) is None
    resumed = T.parallel_tempering_checkpointed(
        tspec, obs, tf, y0, th0, tk, resume_from=path, **ck)
    for out, rate in (chunked, resumed):
        np.testing.assert_array_equal(rate.numpy(), whole[1].numpy())
        for a, b in zip(out, whole[0]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="different PT configuration"):
        T.parallel_tempering_checkpointed(
            tspec, obs, tf, y0, th0, tk, resume_from=path,
            **dict(ck, temperatures=(1.0, 2.0, 3.0)))


def test_tune_ladder_matches_reference(setup):  # noqa: F811
    spec, tspec, obs, tf, y0 = setup
    th0 = chains(6, seed=31)
    kw = dict(n_temps=4, pilot_iters=20, max_rounds=2)
    ref = jax_tune(spec, obsdata_to_device(obs), jnp.asarray(tf),
                   jnp.asarray(y0), jnp.asarray(th0),
                   jax.random.split(jax.random.PRNGKey(5 ^ 0x7A5), 6), **kw)
    got = T.tune_ladder(tspec, obsdata_from_arrays(obs), tf, y0, th0,
                        R.split(R.PRNGKey(5 ^ 0x7A5), 6), device="cpu", **kw)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-12)
    assert got[1] == ref[1]
    assert got[0][0] == 1.0 and all(np.diff(got[0]) > 0)
    with pytest.raises(ValueError, match="n_temps"):
        T.tune_ladder(tspec, obsdata_from_arrays(obs), tf, y0, th0,
                      R.split(R.PRNGKey(0), 6), n_temps=1, device="cpu")
