"""The ensemble and parallel-tempering twins against the JAX kernels in
interpret mode on Student-t, Poisson and negative-binomial data: the same
accept sequences (and, for PT, swap counts) over short runs. The cases
are tests/test_torch_obs_models.py's; PT's on its thinned demo."""
import numpy as np
import pytest
import torch

from odelib_tpu.ops import pallas_mh as J
from odelib_tpu.ops import pallas_pt as JP
from odelib_tpu_torch.ops import cuda_mh as T
from odelib_tpu_torch.ops import cuda_pt as TP

from test_torch_obs_models import THIN, assert_same_chains, draws, fam_case


def run_ensemble(jspec, tspec, obs, tf, y0, th0, **kw):
    ref = J.ensemble_fused(jspec, obs, tf, y0, th0, seed=5, tile_chains=256,
                           interpret=True, **kw)
    got = T.ensemble_fused(tspec, obs, tf, y0, torch.as_tensor(th0), 5,
                           tile_chains=256, **kw)
    return got, ref


def run_pt(jspec, tspec, obs, tf, y0, th0, **kw):
    ref, ref_rate = JP.parallel_tempering_fused(
        jspec, obs, tf, y0, th0, seed=7, tile_chains=128, interpret=True,
        **kw)
    got, rate = TP.parallel_tempering_fused(tspec, obs, tf, y0,
                                            torch.as_tensor(th0), 7, **kw)
    np.testing.assert_array_equal(rate.numpy(), np.asarray(ref_rate))
    return got, ref


@pytest.mark.parametrize("fam", ["student_t", "poisson", "negbinom"])
def test_ensemble_twin_matches_pallas_interpret(fam):
    jspec, tspec, obs, tf, y0, centre = fam_case(fam)
    got, ref = run_ensemble(jspec, tspec, obs, tf, y0,
                            draws(centre, 256, 0.03), nits=8, burnin=3,
                            substeps=1)
    assert_same_chains(got, ref)


@pytest.mark.parametrize("fam", ["student_t", "poisson", "negbinom"])
def test_pt_twin_matches_pallas_interpret(fam):
    jspec, tspec, obs, tf, y0, centre = fam_case(fam, thin=THIN)
    got, ref = run_pt(jspec, tspec, obs, tf, y0, draws(centre, 128, 0.03),
                      nits=10, burnin=4, substeps=1,
                      temperatures=(1.0, 2.0, 4.0))
    assert_same_chains(got, ref)
