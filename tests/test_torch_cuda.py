"""odelib_tpu_torch's CUDA kernels against their torch twins on the card.

Every test here needs a CUDA device and skips without one. This file
imports neither jax nor the JAX package, so it runs on a GPU machine
without them:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from odelib_tpu_torch.data import (build_obsdata_host,
                                   compact_observation_grid,
                                   format_dataframe, load_demo_dataframe)
from odelib_tpu_torch.model import make_spec
from odelib_tpu_torch.models import zero_i
from odelib_tpu_torch.ops import cuda_mh as T
from odelib_tpu_torch.ops import cuda_pt as TP
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


def _equal_runs(k_recs, t_recs):
    """Kernel and twin records (chain-minor) agree: the accept sequences
    (running acceptance ratios) exactly, the rest to rtol 1e-5."""
    k_recs = [r.cpu().numpy() for r in k_recs]
    t_recs = [r.cpu().numpy() for r in t_recs]
    np.testing.assert_array_equal(k_recs[4], t_recs[4])
    for a, b in zip(k_recs, t_recs):
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        np.testing.assert_allclose(a, b, rtol=1e-5)


def test_ensemble_kernel_matches_twin(card):
    """700 walkers padded to three ensembles of 256, a static slot."""
    spec, obs, tf, y0 = card
    draws = _draws(700, sd=0.05)
    walk = (1.0, 1.0, 0.0)
    before = T.LAUNCHES["ensemble_fused"]
    k = T.ensemble_fused(spec, obs, tf, y0, torch.as_tensor(draws,
                                                            device="cuda"),
                         11, nits=40, burnin=10, substeps=4, walk_mask=walk,
                         tile_chains=256)
    assert T.LAUNCHES["ensemble_fused"] == before + 1
    th0 = torch.as_tensor(T.ensemble_init(draws, 11, 256, walk, 0.01).T
                          .copy(), device="cuda")
    tw = T.ensemble_plain(spec, T._build_plan(spec, obs, tf, 4), y0, th0, 11,
                          tile=256, nits=40, burnin=10, a=2.0, walk=walk,
                          walked=(True, True, False), num=3, W0=700)
    torch.cuda.synchronize()
    _equal_runs([k.theta.permute(1, 2, 0), k.chi.t(), k.rsquared.t(),
                 k.aic.t(), k.acceptance_ratio.t()], tw)
    assert 0 < float(k.acceptance_ratio[:, -1].mean()) < 1


# K = 3 leaves a lane of each 4-lane chain group idle; K = 8 fills a group.
# 500 chains leave the last 128-thread block part empty for every K.
@pytest.mark.parametrize("every,K", [(1, 4), (3, 4), (1, 3), (2, 8)])
def test_pt_kernel_matches_twin(card, every, K):
    spec, obs, tf, y0 = card
    temps = tuple(2.0 ** (k / 2) for k in range(K))
    th0 = torch.as_tensor(_draws(500, sd=0.05), device="cuda")
    before = T.LAUNCHES["parallel_tempering_fused"]
    k, rate = TP.parallel_tempering_fused(
        spec, obs, tf, y0, th0, 11, temperatures=temps, swap_every=every,
        nits=40, burnin=10, substeps=4, walk_mask=[1, 0, 1])
    assert T.LAUNCHES["parallel_tempering_fused"] == before + 1
    scales, betas, dbetas = TP.ladder_constants(temps, 0.05, [1, 0, 1])
    tw = TP.pt_plain(spec, T._build_plan(spec, obs, tf, 4), y0,
                     th0.t().contiguous(), 11, nits=40, burnin=10,
                     scales=scales, walked=(True, False, True), betas=betas,
                     dbetas=dbetas, swap_every=every, num=3)
    torch.cuda.synchronize()
    _equal_runs([k.theta.permute(1, 2, 0), k.chi.t(), k.rsquared.t(),
                 k.aic.t(), k.acceptance_ratio.t()], tw[:5])
    att = TP.swap_attempts(40, every, 1)[0]
    np.testing.assert_array_equal(rate.cpu().numpy(),
                                  (tw[5][-1] / torch.tensor(
                                      att, dtype=torch.float32,
                                      device="cuda")).cpu().numpy())
    assert 0 < float(rate.mean()) <= 1


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


def _joint_inputs(card, others=()):
    """zero_i on the demo data (a) and, unless ``others`` replaces it, the
    same model on perturbed data with initial abundances x 1.13 (b),
    sharing phi and beta: D = 4, two idx maps that differ."""
    spec, obs, tf, y0 = card
    rng = np.random.default_rng(7)
    obs_b = obs._replace(log_abundance=obs.log_abundance
                         + rng.normal(0, 0.1, len(obs.log_abundance)))
    exps = [(spec, obs, tf, y0, (2, 0, 1))]
    exps += list(others) or [(spec, obs_b, tf, 1.13 * y0, (3, 0, 1))]
    return [list(x) for x in zip(*exps)]


def _check_joint(specs, obs, tfs, y0s, idxs, th0, seed, nits, burnin,
                 mask):
    from odelib_tpu_torch.ops import cuda_joint as TJ
    before = T.LAUNCHES["joint_metropolis_hastings_fused"]
    k = TJ.joint_metropolis_hastings_fused(specs, idxs, obs, tfs, y0s, th0,
                                           seed, nits=nits, burnin=burnin,
                                           walk_mask=mask,
                                           substeps_list=[4] * len(specs))
    assert T.LAUNCHES["joint_metropolis_hastings_fused"] == before + 1
    plans = [T._build_plan(sp, ob, tf, 4) for sp, ob, tf in
             zip(specs, obs, tfs)]
    tw = TJ.joint_plain(specs, plans, y0s, idxs, th0.t().contiguous(), seed,
                        nits=nits, burnin=burnin,
                        walk=tuple(0.05 * w for w in mask),
                        walked=tuple(w != 0 for w in mask))
    torch.cuda.synchronize()
    got = [k.theta.permute(1, 2, 0), k.chi.t(), k.chi_parts.permute(1, 2, 0),
           k.acceptance_ratio.t()]
    for a, b in zip(got, tw):        # bitwise: the same float32 operations
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    assert 0 < float(k.acceptance_ratio[:, -1].mean()) < 1


def test_joint_kernel_matches_twin(card):
    specs, obs, tfs, y0s, idxs = _joint_inputs(card)
    rng = np.random.default_rng(2)
    th0 = (np.array([2.4e-8, 24.0, 0.6, 0.6])
           * np.exp(rng.normal(0, 0.05, (256, 4)))).astype(np.float32)
    _check_joint(specs, obs, tfs, y0s, idxs,
                 torch.as_tensor(th0, device="cuda"), 11, 20, 5,
                 (1.0, 1.0, 1.0, 0.0))


def test_joint_kernel_heterogeneous_models(card):
    """zero_i and one_i in one fit: two models compiled into one library,
    selected per experiment, sharing phi and beta."""
    from odelib_tpu_torch.models import one_i
    df = format_dataframe(load_demo_dataframe(host="H", virus="V"),
                          one_i.snames)
    times = np.linspace(0, df["time"].max(), 288)
    spec1 = one_i.spec()
    obs1, _ = build_obsdata_host(df, times, spec1.post_snames)
    tf1, obs1 = compact_observation_grid(obs1, times)
    y01 = np.array([df.loc["H"].iloc[0]["abundance"], 0.0,
                    df.loc["V"].iloc[0]["abundance"]])
    specs, obs, tfs, y0s, idxs = _joint_inputs(
        card, [(spec1, obs1, tf1, y01, (3, 0, 1, 4))])
    rng = np.random.default_rng(3)
    th0 = (np.array([2.4e-8, 22.0, 0.6, 0.6, 1.2])
           * np.exp(rng.normal(0, 0.05, (256, 5)))).astype(np.float32)
    _check_joint(specs, obs, tfs, y0s, idxs,
                 torch.as_tensor(th0, device="cuda"), 5, 20, 5,
                 (1.0,) * 5)


def _gbm_inputs():
    """The GBM state-space model on its compact grid (8 observations at
    t = 0.5, ..., 4.0)."""
    from odelib_tpu_torch.model import ObsData

    def gbm(t, y, ps):
        return [ps[0] * y[0]]

    def noise(t, y, ps):
        return [0.3 * y[0]]
    spec = make_spec(adapt_rhs(gbm), ("mu",), ("N",),
                     diffusion=adapt_rhs(noise))
    log_o = np.log(2.0) + 0.33 * np.arange(1, 9) * 0.5 \
        + 0.2 * np.random.default_rng(42).normal(size=8)
    obs = ObsData(log_abundance=log_o, log_sigma=np.full(8, 0.15),
                  abundance=np.exp(log_o), t_index=np.arange(1, 9),
                  state_index=np.zeros(8, np.int32),
                  sstot=np.asarray(np.var(np.exp(log_o)) * 8))
    return spec, obs, np.arange(9) * 0.5, np.array([2.0])


# one particle a lane on 8 of 32 lanes; K = 40 (2 a lane, 20 lanes, a last
# group of 8); the main path's 128 (4 a lane); 200 (8 a lane, 25 lanes, a
# last group of 8); 512 (16 a lane)
@pytest.mark.parametrize("K,prior", [(8, True), (40, False), (128, False),
                                     (200, True), (512, True)])
def test_pf_kernel_matches_twin(K, prior):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from odelib_tpu_torch import distributions as D
    from odelib_tpu_torch.ops import cuda_pf as TF
    from odelib_tpu_torch.ops.priors import prior_table
    spec, obs, tf, y0 = _gbm_inputs()
    # 202 chains: the last block of four warps holds two
    th0 = torch.as_tensor(np.exp(np.random.default_rng(1).normal(
        np.log(0.4), 0.3, (202, 1))).astype(np.float32), device="cuda")
    pri = (D.LogNormal(s=0.5, scale=0.4),) if prior else None
    kw = dict(nits=6, burnin=2, rwalk_std=0.3, n_particles=K, substeps=5,
              adapt_proposal=prior, adapt_rate=0.15)
    before = T.LAUNCHES["pmmh_fused"]
    k = TF.pmmh_fused(spec, obs, tf, y0, th0, 3, priors=pri, **kw)
    assert T.LAUNCHES["pmmh_fused"] == before + 1
    plan = T._build_plan(spec, obs, tf, 5)
    tw = TF.pmmh_plain(spec, plan, y0, th0.t().contiguous(), 3, K=K, nits=6,
                       burnin=2, walk=(1.0,), walked=(True,), rwalk_std=0.3,
                       prior=None if pri is None else prior_table(pri),
                       adapt=prior, target=0.3, adapt_rate=0.15)
    torch.cuda.synchronize()
    got = [k.theta.permute(1, 2, 0), k.chi.t(), k.acceptance_ratio.t()]
    for a, b in zip(got, tw):        # bitwise: the same float32 operations
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    assert np.isfinite(k.chi.cpu().numpy()).all()


def test_mh_kernel_fits_an_sde_drift():
    """MCMC(sampler='mh') on a model with diffusion= warns and fits the
    drift through the survey and MH kernels of the drift's own library (the
    ODE model's, without the particle filter): the same posterior, bitwise,
    as the model built without diffusion=."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import pandas as pd
    import scipy.stats

    from odelib_tpu_torch import ModelFramework, parameter
    from odelib_tpu_torch.ops import build
    _, obs, tf, _ = _gbm_inputs()
    df = pd.DataFrame({"organism": "N", "time": tf[1:],
                       "abundance": obs.abundance, "log_sigma": 0.15})

    def framework(noise):
        return ModelFramework(
            ODE=lambda y, t, ps: np.array([ps[0] * y[0]]),
            diffusion=(lambda y, t, ps: np.array([0.3 * y[0]])) if noise
            else None, parameter_names=["mu"], state_names=["N"],
            dataframe=df, t_steps=41, N=2.0, device="cuda",
            mu=parameter(scipy.stats.lognorm, {"s": 0.5, "scale": 0.4},
                         random_seed=1))
    kw = dict(chain_inits=256, iterations_per_chain=40,
              fitsurvey_samples=256, sampler="mh", print_report=False)
    sde, ode = framework(True), framework(False)
    lib = build.load_kernels(sde._spec)
    assert lib._name == build.load_kernels(ode._spec)._name
    assert "ODE_HAS_DIFFUSION" not in open(os.path.join(os.path.dirname(
        lib._name), "odelib_gen.cuh")).read()
    assert build.load_kernels(sde._spec, diffusion=True)._name != lib._name
    T.reset_launch_counts()
    with pytest.warns(UserWarning, match="DRIFT ONLY"):
        got = sde.MCMC(**kw)
    assert T.LAUNCHES["survey_fused"] == 1
    assert T.LAUNCHES["metropolis_hastings_fused"] == 1
    want = ode.MCMC(**kw)
    pd.testing.assert_frame_equal(got, want)
    assert np.isfinite(got["chi"]).all()
