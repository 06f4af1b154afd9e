"""odelib_tpu_torch's CUDA kernels against their torch twins on the card.

Every test here needs a CUDA device and skips without one. This file
imports neither jax nor the JAX package, so it runs on a GPU machine
without them:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from odelib_tpu_torch.data import (build_obsdata_host,
                                   compact_observation_grid,
                                   format_dataframe, load_demo_dataframe)
from odelib_tpu_torch.model import make_spec
from odelib_tpu_torch.models import zero_i
from odelib_tpu_torch.ops import cuda_mh as T
from odelib_tpu_torch.rhs import RhsTraceError, adapt_rhs

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    df = format_dataframe(load_demo_dataframe(host="S", virus="V"), ("S", "V"))
    times = np.linspace(0, df["time"].max(), 288)
    spec = zero_i.spec()
    obs, _ = build_obsdata_host(df, times, spec.post_snames)
    tf, obs = compact_observation_grid(obs, times)
    y0 = np.array([df.loc["S"].iloc[0]["abundance"],
                   df.loc["V"].iloc[0]["abundance"]])
    return spec, obs, tf, y0


def _draws(n, sd=0.2, seed=0):
    rng = np.random.default_rng(seed)
    return (np.array([0.6, 2.4e-8, 24.0])
            * np.exp(rng.normal(0, sd, (n, 3)))).astype(np.float32)


@pytest.mark.parametrize("stepper", ["dopri5", "rk4"])
def test_survey_kernel_matches_twin(card, stepper):
    spec, obs, tf, y0 = card
    th = torch.as_tensor(_draws(1000), device="cuda")
    before = T.LAUNCHES["survey_fused"]
    k = T.survey_fused(spec, obs, tf, y0, th, substeps=4, stepper=stepper)
    assert T.LAUNCHES["survey_fused"] == before + 1
    plan = T._build_plan(spec, obs, tf, 4)
    tw = T.survey_plain(spec, plan, y0, th.t().contiguous(), stepper)
    torch.cuda.synchronize()
    k, tw = k.cpu().numpy(), tw.cpu().numpy()
    np.testing.assert_array_equal(np.isfinite(k), np.isfinite(tw))
    np.testing.assert_allclose(k, tw, rtol=1e-5)


def test_mh_kernel_matches_twin(card):
    spec, obs, tf, y0 = card
    th0 = torch.as_tensor(_draws(512, sd=0.05), device="cuda")
    before = T.LAUNCHES["metropolis_hastings_fused"]
    k = T.metropolis_hastings_fused(spec, obs, tf, y0, th0, 11, nits=60,
                                    burnin=20, substeps=4,
                                    walk_mask=[1, 1, 0])
    assert T.LAUNCHES["metropolis_hastings_fused"] == before + 1
    plan = T._build_plan(spec, obs, tf, 4)
    tw = T.mh_plain(spec, plan, y0, th0.t().contiguous(), 11, nits=60,
                    burnin=20, walk=(0.05, 0.05, 0.0),
                    walked=(True, True, False), num=3)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(k.acceptance_ratio.cpu().numpy(),
                                  tw[4].t().cpu().numpy())
    np.testing.assert_allclose(k.theta.cpu().numpy(),
                               tw[0].permute(2, 0, 1).cpu().numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(k.chi.cpu().numpy(), tw[1].t().cpu().numpy(),
                               rtol=1e-5)


def test_summed_observable_kernel_matches_twin():
    """one_i on the demo data (host observed as H = S + I1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from odelib_tpu_torch.models import one_i
    df = format_dataframe(load_demo_dataframe(host="H", virus="V"),
                          one_i.snames)
    times = np.linspace(0, df["time"].max(), 288)
    spec = one_i.spec()
    obs, _ = build_obsdata_host(df, times, spec.post_snames)
    tf, obs = compact_observation_grid(obs, times)
    y0 = np.array([df.loc["H"].iloc[0]["abundance"], 0.0,
                   df.loc["V"].iloc[0]["abundance"]])
    rng = np.random.default_rng(5)
    th = torch.as_tensor((np.array([0.6, 2.4e-8, 20.0, 1.2])
                          * np.exp(rng.normal(0, 0.2, (700, 4))))
                         .astype(np.float32), device="cuda")
    k = T.survey_fused(spec, obs, tf, y0, th, substeps=4)
    plan = T._build_plan(spec, obs, tf, 4)
    tw = T.survey_plain(spec, plan, y0, th.t().contiguous())
    torch.cuda.synchronize()
    np.testing.assert_allclose(k.cpu().numpy(), tw.cpu().numpy(), rtol=1e-5)


def test_untraceable_rhs_raises_on_card(card):
    _, obs, tf, y0 = card

    def branchy(t, y, ps):
        mu, phi, beta = ps
        S, V = y
        if t < 10.0:
            mu = mu * 1.0
        return [mu * S - phi * S * V, beta * phi * S * V - phi * S * V]

    spec = make_spec(adapt_rhs(branchy), zero_i.pnames, zero_i.snames)
    with pytest.raises(RhsTraceError, match="control flow"):
        T.survey_fused(spec, obs, tf, y0,
                       torch.as_tensor(_draws(4), device="cuda"))
