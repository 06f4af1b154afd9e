"""Fused MH: the port's ``metropolis_hastings_fused`` (torch twin on the
CPU) against ``odelib_tpu``'s Pallas kernel in interpret mode, record by
record: same theta0 and seed, nits=24, burnin=12, with and without a walk
mask. Kernel-versus-twin on the card is in tests/test_torch_cuda.py and
chip_smoke.py's MH phase."""
import numpy as np
import pytest
import torch

from odelib_tpu.ops import pallas_mh as J
from odelib_tpu_torch.distributions import DiscreteNormal
from odelib_tpu_torch.ops import cuda_mh as T

from test_torch_mh_prefetch import PRIOR_SETS
from test_torch_priors import jax_priors
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


# the shape of schedule substeps='auto' gives: 3 steps in the first
# interval, 1 in most, 2 in the last two
_AUTO_LIKE = "auto-like"


@pytest.mark.parametrize("prior_set,substeps", [
    pytest.param("gamma-truncnorm-exponential", 1,
                 id="gamma-truncnorm-exponential"),
    pytest.param("cauchy-halfnormal-weibull", 1,
                 id="cauchy-halfnormal-weibull"),
    pytest.param("lognormal-normal-uniform", _AUTO_LIKE,
                 id="lognormal-normal-uniform-schedule")])
def test_mh_twin_with_priors_matches_pallas_interpret(setup,  # noqa: F811
                                                      prior_set, substeps):
    """In-kernel priors of the new families, on 1 substep or a non-uniform
    schedule: the same accept sequences as the JAX kernel with the same
    priors and schedule, theta within the no-prior test's rtol 1e-5 and
    chi within its 5e-5."""
    spec, tspec, obs_fit, times_fit, y0 = setup
    th0 = _theta0()
    priors = PRIOR_SETS[prior_set]
    if substeps == _AUTO_LIKE:
        substeps = (3,) + (1,) * (len(times_fit) - 4) + (2, 2)
    kw = dict(nits=24, burnin=12, substeps=substeps, rwalk_std=0.1)
    ref = J.metropolis_hastings_fused(spec, obs_fit, times_fit, y0, th0,
                                      seed=7, tile_chains=128,
                                      interpret=True,
                                      priors=jax_priors(priors), **kw)
    obs_t, th_t, seed, y0_t = T.inputs_from_reference(obs_fit, th0, 7, y0)
    got = T.metropolis_hastings_fused(tspec, obs_t, times_fit, y0_t, th_t,
                                      seed, priors=priors, **kw)
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    plain = T.metropolis_hastings_fused(tspec, obs_t, times_fit, y0_t, th_t,
                                        seed, **kw)
    # the priors change the chains
    assert (plain.acceptance_ratio != got.acceptance_ratio).any()
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               rtol=1e-5)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(ref.chi),
                               rtol=5e-5)


def test_mh_twin_rejects_unported_options(setup):  # noqa: F811
    _, tspec, obs_fit, times_fit, y0 = setup
    obs = T.obsdata_from_arrays(obs_fit)
    th0 = torch.as_tensor(_theta0(4))
    for kw, err, msg in ((dict(checkpoint_every=0), ValueError, ">= 1"),
                         (dict(stepper="kvaerno5"), ValueError,
                          "the kernels run dopri5, rk4, kvaerno3")):
        with pytest.raises(err, match=msg):
            T.metropolis_hastings_fused(tspec, obs, times_fit, y0, th0, 0,
                                        nits=8, burnin=2, **kw)
    # a prior without an in-kernel form: the reference's ValueError
    with pytest.raises(ValueError, match="unsupported prior family"):
        T.metropolis_hastings_fused(
            tspec, obs, times_fit, y0, th0, 0, nits=8, burnin=2,
            priors=[None, DiscreteNormal(0.0, 1.0), None])
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



def test_plain_launchers_swap_in_the_twins(setup):  # noqa: F811
    """ops.plain_launchers: inside the block a chain launcher returns its
    twin's run on the launcher's arguments; after it the kernels'
    launchers are back."""
    from odelib_tpu_torch.ops import cuda_joint as TJ
    from odelib_tpu_torch.ops import cuda_pt as TP
    from odelib_tpu_torch.ops import plain_launchers
    _, tspec, obs_fit, times_fit, y0 = setup
    th0 = torch.as_tensor(_theta0(8)).t().contiguous()
    plan = T._build_plan(tspec, T.obsdata_from_arrays(obs_fit), times_fit,
                         (3,) + (1,) * (len(times_fit) - 4) + (2, 2))
    kw = dict(nits=6, burnin=0, walk=(0.05,) * 3, walked=(True,) * 3,
              num=3)
    real = (T.mh_launcher, T.ensemble_launcher, TP.pt_launcher,
            TJ.joint_launcher)
    with plain_launchers():
        got = T.mh_launcher(tspec, plan, y0, "rk4", th0, 7, **kw)()
    assert (T.mh_launcher, T.ensemble_launcher, TP.pt_launcher,
            TJ.joint_launcher) == real
    want = T.mh_plain(tspec, plan, y0, th0, 7, stepper="rk4", **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
