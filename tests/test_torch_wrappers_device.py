"""The six public kernel wrappers run on the card by default: numpy input
goes to ``device`` ('cuda' unless asked), so without CUDA they raise as
``ModelFramework`` does; ``device='cpu'`` (or a CPU tensor, which keeps its
device) runs the kernel's torch twin, with records equal to the CPU
tensor's. ``torch.cuda.is_available`` is patched False, so the raise is
checked on a machine with a card too."""
import numpy as np
import pytest
import torch

import odelib_tpu_torch
from odelib_tpu_torch.ops import cuda_joint, cuda_mh, cuda_pf, cuda_pt

from test_torch_scan_routing import _framework

NO_CARD = "CUDA device by default"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _inputs(fw, C=6, seed=0):
    rng = np.random.default_rng(seed)
    th = (np.array([0.6, 2.4e-8, 24.0]) * np.exp(
        rng.normal(0, 0.05, (C, 3)))).astype(np.float32)
    return (fw._spec, fw._obsdata_fit_host, fw._times_fit,
            fw.get_inits()), th


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _check(call, th):
    """``call(theta0, **kw)``: numpy raises without a card, device='cpu'
    and a CPU tensor give equal records."""
    with pytest.raises(RuntimeError, match=NO_CARD):
        call(th)
    got = call(th, device="cpu")
    _same(got, call(torch.as_tensor(th)))
    return got


def test_survey_fused_device(no_card):
    head, th = _inputs(_framework(odelib_tpu_torch, device="cpu"))
    out = _check(lambda t, **k: (cuda_mh.survey_fused(*head, t, substeps=1,
                                                      **k),), th)
    assert out[0].device.type == "cpu" and out[0].shape == (6,)


def test_mh_and_ensemble_fused_device(no_card):
    head, th = _inputs(_framework(odelib_tpu_torch, device="cpu"))
    kw = dict(nits=6, burnin=2, substeps=1)
    _check(lambda t, **k: cuda_mh.metropolis_hastings_fused(
        *head, t, 3, **kw, **k), th)
    _check(lambda t, **k: cuda_mh.ensemble_fused(
        *head, t, 3, tile_chains=256, **kw, **k), th)


def test_pt_fused_device(no_card):
    head, th = _inputs(_framework(odelib_tpu_torch, device="cpu"))
    out = _check(lambda t, **k: cuda_pt.parallel_tempering_fused(
        *head, t, 3, nits=6, burnin=2, substeps=1, **k)[0], th)
    assert out.theta.device.type == "cpu"


def test_pmmh_fused_device(no_card):
    fw = _framework(odelib_tpu_torch, device="cpu",
                    diffusion=lambda t, y, ps: [0.1 * y[0], 0.1 * y[1]])
    head, th = _inputs(fw)
    _check(lambda t, **k: cuda_pf.pmmh_fused(
        *head, t, 3, nits=5, burnin=2, n_particles=8, substeps=1, **k), th)


def test_joint_fused_device(no_card):
    fws = [_framework(odelib_tpu_torch, device="cpu") for _ in range(2)]
    jf = odelib_tpu_torch.JointFit(fws, shared=["phi", "beta"])
    names = list(jf.frameworks)
    args = ([f._spec for f in fws], [jf._idx_maps[n] for n in names],
            [f._obsdata_fit_host for f in fws],
            [np.asarray(f._times_fit) for f in fws],
            [np.asarray(f.get_inits()) for f in fws])
    rng = np.random.default_rng(1)
    th = (np.array([0.6, 0.6, 2.4e-8, 24.0])[:jf.dim]
          * np.exp(rng.normal(0, 0.05, (6, jf.dim)))).astype(np.float32)
    _check(lambda t, **k: cuda_joint.joint_metropolis_hastings_fused(
        *args, t, 3, nits=5, burnin=2, substeps_list=[1, 1], **k), th)
