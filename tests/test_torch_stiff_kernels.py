"""The kernels' twins with ``stepper='kvaerno3'`` against the JAX kernels
in interpret mode. The cases are tests/test_torch_obs_models.py's
lognormal demo, thinned to every other sampling time at substeps 1 (the
interpret-mode kernels' compiles grow steeply with the grid). Kernel
against twin on the card is in tests/test_torch_cuda.py and
chip_smoke.py's stiff phase."""
import numpy as np
import pytest
import torch

from odelib_tpu.ops import pallas_mh as J
from odelib_tpu.ops import pallas_pt as JP
from odelib_tpu_torch.ops import cuda_mh as T
from odelib_tpu_torch.ops import cuda_pt as TP

from test_torch_obs_models import THIN, assert_same_chains, draws, fam_case

KV3 = dict(substeps=1, stepper="kvaerno3")


@pytest.fixture(scope="module")
def demo():
    return fam_case("lognormal", thin=THIN)


def test_survey_twin_matches_pallas_interpret(demo):
    """16 prior-scale draws: the same finite set, chi within 5e-5 (the
    port's symbolic Jacobian columns against ``jax.jvp``'s, and XLA:CPU's
    fused multiply-adds)."""
    jspec, tspec, obs, tf, y0, centre = demo
    th = draws(centre, 16, 0.2)
    ref = np.asarray(J.survey_fused(jspec, obs, tf, y0, th, tile_chains=128,
                                    interpret=True, **KV3))
    got = T.survey_fused(tspec, obs, tf, y0, torch.as_tensor(th),
                         **KV3).numpy()
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin.sum() >= 8
    np.testing.assert_allclose(got[fin], ref[fin], rtol=5e-5)


def test_mh_twin_matches_pallas_interpret(demo):
    jspec, tspec, obs, tf, y0, centre = demo
    th0 = draws(centre, 128, 0.03)
    kw = dict(nits=16, burnin=6, **KV3)
    ref = J.metropolis_hastings_fused(jspec, obs, tf, y0, th0, seed=7,
                                      tile_chains=128, interpret=True, **kw)
    got = T.metropolis_hastings_fused(tspec, obs, tf, y0,
                                      torch.as_tensor(th0), 7, **kw)
    assert_same_chains(got, ref)


def test_ensemble_twin_matches_pallas_interpret(demo):
    jspec, tspec, obs, tf, y0, centre = demo
    th0 = draws(centre, 256, 0.03)
    kw = dict(nits=6, burnin=2, tile_chains=256, **KV3)
    ref = J.ensemble_fused(jspec, obs, tf, y0, th0, seed=5, interpret=True,
                           **kw)
    got = T.ensemble_fused(tspec, obs, tf, y0, torch.as_tensor(th0), 5, **kw)
    assert_same_chains(got, ref)


def test_pt_twin_matches_pallas_interpret(demo):
    """Three rungs: the accept sequences and swap counts."""
    jspec, tspec, obs, tf, y0, centre = demo
    th0 = draws(centre, 128, 0.03)
    kw = dict(nits=8, burnin=3, temperatures=(1.0, 2.0, 4.0), **KV3)
    ref, ref_rate = JP.parallel_tempering_fused(
        jspec, obs, tf, y0, th0, seed=7, tile_chains=128, interpret=True,
        **kw)
    got, rate = TP.parallel_tempering_fused(tspec, obs, tf, y0,
                                            torch.as_tensor(th0), 7, **kw)
    np.testing.assert_array_equal(rate.numpy(), np.asarray(ref_rate))
    assert_same_chains(got, ref)
