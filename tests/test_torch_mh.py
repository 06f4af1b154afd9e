"""Fused MH: the port's ``metropolis_hastings_fused`` (torch twin on the
CPU) against ``odelib_tpu``'s Pallas kernel in interpret mode, record by
record: same theta0 and seed, nits=24, burnin=12, with and without a walk
mask. Kernel-versus-twin on the card is in tests/test_torch_cuda.py and
chip_smoke.py's MH phase."""
import numpy as np
import pytest
import torch

from odelib_tpu.ops import pallas_mh as J
from odelib_tpu_torch.ops import cuda_mh as T

from test_torch_survey import setup  # noqa: F401  (module fixture)


def _theta0(C=128, seed=3):
    rng = np.random.default_rng(seed)
    return (np.array([0.6, 2.4e-8, 24.0])
            * np.exp(rng.normal(0, 0.05, (C, 3)))).astype(np.float32)


@pytest.mark.parametrize("walk_mask", [None, [1, 0, 1]],
                         ids=["all-walked", "walk-101"])
def test_mh_twin_matches_pallas_interpret(setup, walk_mask):  # noqa: F811
    spec, tspec, obs_fit, times_fit, y0 = setup
    th0 = _theta0()
    kw = dict(nits=24, burnin=12, substeps=1, walk_mask=walk_mask)
    ref = J.metropolis_hastings_fused(spec, obs_fit, times_fit, y0, th0,
                                      seed=7, tile_chains=128,
                                      interpret=True, **kw)
    obs_t, th_t, seed, y0_t = T.inputs_from_reference(obs_fit, th0, 7, y0)
    got = T.metropolis_hastings_fused(tspec, obs_t, times_fit, y0_t, th_t,
                                      seed, **kw)
    assert got.theta.shape == (128, 11, 3) and got.chi.shape == (128, 11)
    np.testing.assert_array_equal(got.iteration.numpy(),
                                  np.asarray(ref.iteration))
    # the accept sequence: the running acceptance ratio is an exact
    # function of it, and it is equal for every chain and record
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    assert 0 < float(got.acceptance_ratio[:, -1].mean()) < 1
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               rtol=1e-5)
    np.testing.assert_allclose(got.rsquared.numpy(),
                               np.asarray(ref.rsquared), rtol=1e-5)
    # chi near the optimum is a sum of squared small log residuals, so a
    # one-ulp difference in a log prediction is ~1e-5 of chi. At substeps=1
    # the interpret-mode reference's XLA:CPU arithmetic (fused multiply-
    # adds) moves it by that much: the reference's source in numpy float32
    # agrees with the port to 4.3e-6 on such draws, with the interpret
    # kernel to 4.0e-5 (tests/test_torch_survey.py witnesses); measured max
    # gap here 3.8e-5 (chi) and 2.8e-5 (aic)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(ref.chi),
                               rtol=5e-5)
    np.testing.assert_allclose(got.aic.numpy(), np.asarray(ref.aic),
                               rtol=5e-5)
    if walk_mask is not None:   # the static slot never moves
        fixed = got.theta[:, :, 1].numpy()
        assert (fixed == fixed[:, :1]).all()
        np.testing.assert_allclose(fixed[:, 0], th0[:, 1], rtol=1e-6)
    # aic = 2 chi + 2k with k counted on the first chain's theta0
    np.testing.assert_array_equal(
        got.aic.numpy(), np.float32(2.0) * got.chi.numpy() + np.float32(6.0))


def test_mh_twin_rejects_unported_options(setup):  # noqa: F811
    _, tspec, obs_fit, times_fit, y0 = setup
    obs = T.obsdata_from_arrays(obs_fit)
    th0 = torch.as_tensor(_theta0(4))
    for kw, item in ((dict(priors=[object()] * 3), "item 12"),
                     (dict(checkpoint_every=4), "item 11"),
                     (dict(stepper="kvaerno3"), "item 14")):
        with pytest.raises(NotImplementedError, match=item):
            T.metropolis_hastings_fused(tspec, obs, times_fit, y0, th0, 0,
                                        nits=8, burnin=2, **kw)
    with pytest.raises(ValueError, match="no recorded iterations"):
        T.metropolis_hastings_fused(tspec, obs, times_fit, y0, th0, 0,
                                    nits=8, burnin=7)


def test_mh_chain_streams_independent_of_batch(setup):  # noqa: F811
    """Chain c keys its RNG on its global index: a prefix of the batch
    runs exactly as it does inside the larger batch."""
    _, tspec, obs_fit, times_fit, y0 = setup
    obs = T.obsdata_from_arrays(obs_fit)
    th0 = torch.as_tensor(_theta0(40))
    kw = dict(nits=10, burnin=3, substeps=1)
    a = T.metropolis_hastings_fused(tspec, obs, times_fit, y0, th0, 5, **kw)
    b = T.metropolis_hastings_fused(tspec, obs, times_fit, y0, th0[:16], 5,
                                    **kw)
    np.testing.assert_array_equal(a.theta[:16].numpy(), b.theta.numpy())
    np.testing.assert_array_equal(a.chi[:16].numpy(), b.chi.numpy())

