"""Fused parallel tempering: the port's ``parallel_tempering_fused`` (torch
twin on the CPU) against ``odelib_tpu``'s Pallas kernel in interpret mode,
and the whole ``MCMC(sampler='pt')`` slice against odelib_tpu's.
Kernel-versus-twin on the card is in tests/test_torch_cuda.py and
chip_smoke.py.

Tolerances are those of the MH kernel (tests/test_torch_mh.py): accept
sequences and cold swap counts equal, theta and R^2 rtol 1e-5, chi and AIC
5e-5 (the interpret-mode reference's XLA:CPU arithmetic; the witnesses in
tests/test_torch_survey.py). Each rung is an MH chain, so its ulps do not
grow as the ensemble's do. The static-mask case runs at substeps=2: at
substeps=1 chain 66 meets an ulp tie at iteration 8 (|log_ratio - log u|
= 4.7e-5 at chi 4.9, inside that step size's chi gap).
"""
import logging

import numpy as np
import pandas as pd
import pytest
import torch

import odelib_tpu
import odelib_tpu_torch
from odelib_tpu.ops import pallas_pt as JP
from odelib_tpu.samplers.pt import swap_attempts as jax_swap_attempts
from odelib_tpu_torch.ops import cuda_mh as T
from odelib_tpu_torch.ops import cuda_pt as TP
from odelib_tpu_torch.samplers.pt import swap_attempts

from test_torch_api import _framework, _report_numbers
from test_torch_ensemble import _inits, _theta0
from test_torch_survey import setup  # noqa: F401  (module fixture)

_NITS, _BURNIN, _TEMPS = 24, 12, (1.0, 2.0, 4.0)
# (swap_every, walk_mask, substeps)
_CASES = {"swap-every-1": (1, None, 1),
          "swap-every-2-static": (2, [1, 0, 1], 2)}


@pytest.fixture(scope="module")
def refs(setup):  # noqa: F811
    """The JAX kernel's T=1 records and swap rates, computed once."""
    spec, _, obs_fit, times_fit, y0 = setup
    return {name: JP.parallel_tempering_fused(
        spec, obs_fit, times_fit, y0, _theta0(128), seed=7,
        temperatures=_TEMPS, swap_every=every, nits=_NITS, burnin=_BURNIN,
        walk_mask=mask, substeps=substeps, tile_chains=128, interpret=True)
        for name, (every, mask, substeps) in _CASES.items()}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_pt_twin_matches_pallas_interpret(setup, refs, case):  # noqa: F811
    _, tspec, obs_fit, times_fit, y0 = setup
    every, mask, substeps = _CASES[case]
    ref, ref_rate = refs[case]
    th0 = _theta0(128)
    obs_t, th_t, seed, y0_t = T.inputs_from_reference(obs_fit, th0, 7, y0)
    got, rate = TP.parallel_tempering_fused(
        tspec, obs_t, times_fit, y0_t, th_t, seed, temperatures=_TEMPS,
        swap_every=every, nits=_NITS, burnin=_BURNIN, walk_mask=mask,
        substeps=substeps)
    R = _NITS - 1 - _BURNIN
    assert got.theta.shape == (128, R, 3) and rate.shape == (128,)
    np.testing.assert_array_equal(got.iteration.numpy(),
                                  np.asarray(ref.iteration))
    # the T=1 accept sequence and the cold pair's swap count are equal
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    np.testing.assert_array_equal(rate.numpy(), np.asarray(ref_rate))
    assert 0 < float(rate.mean()) <= 1
    assert 0 < float(got.acceptance_ratio[:, -1].mean()) < 1
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               rtol=1e-5)
    np.testing.assert_allclose(got.rsquared.numpy(),
                               np.asarray(ref.rsquared), rtol=1e-5)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(ref.chi),
                               rtol=5e-5)
    np.testing.assert_allclose(got.aic.numpy(), np.asarray(ref.aic),
                               rtol=5e-5)
    if mask is not None:        # the static slot never moves
        fixed = got.theta[:, :, 1].numpy()
        assert (fixed == fixed[:, :1]).all()
        np.testing.assert_allclose(fixed[:, 0], th0[:, 1], rtol=1e-6)


@pytest.mark.parametrize("nits,every", [(24, 1), (24, 2), (25, 3), (2, 5)])
def test_swap_attempts_match_odelib_tpu(nits, every):
    np.testing.assert_array_equal(swap_attempts(nits, every, 3),
                                  jax_swap_attempts(nits, every, 3))


def test_ladder_constants_rounded_on_host():
    scales, betas, dbetas = TP.ladder_constants((1.0, 2.0, 3.0), 0.05,
                                                [1.0, 0.0, 1.0])
    assert scales.dtype == betas.dtype == dbetas.dtype == np.float32
    np.testing.assert_array_equal(
        scales[2], np.float32([0.05 * 3.0 ** 0.5, 0.0, 0.05 * 3.0 ** 0.5]))
    np.testing.assert_array_equal(betas, np.float32([1.0, 0.5, 1 / 3]))
    # the pair factor is the double difference, rounded once
    assert dbetas[1] == np.float32(0.5 - 1 / 3)


def test_pt_rejects_bad_arguments(setup):  # noqa: F811
    _, tspec, obs_fit, times_fit, y0 = setup
    obs = T.obsdata_from_arrays(obs_fit)
    th0 = torch.as_tensor(_theta0(4))
    for kw, err, msg in (
            (dict(temperatures=(1.0,)), ValueError, ">= 2"),
            (dict(temperatures=(2.0, 4.0)), ValueError, "must be 1.0"),
            (dict(temperatures=(1.0, 3.0, 2.0)), ValueError, "increasing"),
            (dict(temperatures=tuple(range(1, 10))), ValueError, "at most"),
            (dict(swap_every=0), ValueError, "swap_every"),
            (dict(burnin=7), ValueError, "no recorded"),
            (dict(priors=[object()] * 3), NotImplementedError, "item 12"),
            (dict(resume_from="x"), NotImplementedError, "item 11")):
        with pytest.raises(err, match=msg):
            TP.parallel_tempering_fused(tspec, obs, times_fit, y0, th0, 0,
                                        nits=8, **{"burnin": 2, **kw})


def test_mcmc_pt_slice_matches_odelib_tpu(capsys, caplog):
    inits = _inits(16)
    kw = dict(chain_inits=inits, iterations_per_chain=_NITS, burnin=_BURNIN,
              sampler="pt", temperatures=_TEMPS, swap_every=1,
              backend="pallas", pallas_tile_chains=128, print_report=True)
    ref_fw = _framework(odelib_tpu)
    ref = ref_fw.MCMC(pallas_interpret=True, **kw)
    ref_report = capsys.readouterr().out
    fw = _framework(odelib_tpu_torch, device="cpu")
    with caplog.at_level(logging.INFO, logger="odelib_tpu_torch"):
        got = fw.MCMC(**kw)
    report = capsys.readouterr().out
    assert "cold-pair swap acceptance" in caplog.text
    assert list(got.columns) == list(ref.columns)
    assert len(got) == len(ref) == 16 * (_NITS - 1 - _BURNIN)
    pd.testing.assert_index_equal(got.index, ref.index)
    for col in ref.columns:
        assert got[col].dtype == ref[col].dtype, col
    for col in ("iteration", "chain#", "all_rejected", "acceptance_ratio"):
        np.testing.assert_array_equal(got[col].to_numpy(),
                                      ref[col].to_numpy())
    for col, tol in (("mu", 1e-5), ("phi", 1e-5), ("beta", 1e-5),
                     ("rsquared", 1e-5), ("chi", 5e-5), ("aic", 5e-5)):
        np.testing.assert_allclose(got[col].to_numpy(), ref[col].to_numpy(),
                                   rtol=tol, err_msg=col)
    a, b = _report_numbers(report), _report_numbers(ref_report)
    assert a.size == b.size == 9
    np.testing.assert_allclose(a, b, rtol=1e-3)
