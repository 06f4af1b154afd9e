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
from odelib_tpu_torch.ops.priors import prior_table
from odelib_tpu_torch.rhs import RhsTraceError, adapt_rhs

from scoring_cases import SCORING, scoring_id
from test_torch_mh_prefetch import CASES as MH_CASES
from test_torch_mh_prefetch import PRIOR_SETS, assert_bitwise, run_case

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
    # bitwise: the same float32 operations (-fmad=false, no fast math)
    np.testing.assert_array_equal(k.cpu().numpy(), tw.cpu().numpy())


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
    assert_bitwise((k.theta.permute(1, 2, 0), k.chi.t(), k.rsquared.t(),
                    k.aic.t(), k.acceptance_ratio.t()), tw)


@pytest.mark.parametrize("case", sorted(MH_CASES))
def test_mh_prefetch_cases_match_twin(card, case):
    """The prefetching kernel (a group of four lanes a chain, rounds of 1
    to 4 iterations down the tree the chain's acceptance picks) against
    mh_plain on every case of the CPU emulation
    (tests/test_torch_mh_prefetch.py), at the main path's substeps and on
    1,003 chains, so the last warp is part empty: bitwise."""
    got, want, _, _ = run_case(card, case, device="cuda", substeps=4,
                               chains=1003)
    torch.cuda.synchronize()
    assert_bitwise(got, want)


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


@pytest.mark.parametrize("blocks", [1, 3])
def test_ensemble_column_loop_matches_twin(card, blocks):
    """A grid of fewer threads than the 384 columns of three ensembles of
    256 (32 threads: 12 columns each; 96: 4 each): bitwise the twin's."""
    spec, obs, tf, y0 = card
    walk = (1.0, 0.0, 1.0)
    th0 = torch.as_tensor(T.ensemble_init(_draws(700, sd=0.05), 11, 256,
                                          walk, 0.01).T.copy(), device="cuda")
    kw = dict(tile=256, nits=30, burnin=10, a=2.0, walk=walk,
              walked=(True, False, True), num=3, W0=700)
    plan = T._build_plan(spec, obs, tf, 4)
    k = T.ensemble_launcher(spec, plan, y0, "dopri5", th0, 11, blocks=blocks,
                            **kw)()
    tw = T.ensemble_plain(spec, plan, y0, th0, 11, **kw)
    torch.cuda.synchronize()
    for a, b in zip(k, tw):          # bitwise: the same float32 operations
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


def test_ensemble_kernel_unstaged_plan_matches_twin(card):
    """substeps=100 (1,700 steps a solve): the plan outgrows the 48 KB
    staged in shared memory, so the kernel reads it from global memory."""
    spec, obs, tf, y0 = card
    walk = (1.0, 1.0, 0.0)
    plan = T._build_plan(spec, obs, tf, 100)
    assert sum(a.nbytes for a in T.plan_tables(spec, plan, y0,
                                               "dopri5")) > 48 * 1024
    th0 = torch.as_tensor(T.ensemble_init(_draws(300, sd=0.05), 11, 256,
                                          walk, 0.01).T.copy(), device="cuda")
    kw = dict(tile=256, nits=4, burnin=1, a=2.0, walk=walk,
              walked=(True, True, False), num=3, W0=300)
    k = T.ensemble_launcher(spec, plan, y0, "dopri5", th0, 11, **kw)()
    tw = T.ensemble_plain(spec, plan, y0, th0, 11, **kw)
    torch.cuda.synchronize()
    for a, b in zip(k, tw):          # bitwise: the same float32 operations
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


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
    np.testing.assert_array_equal(k.cpu().numpy(), tw.cpu().numpy())


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
                 mask, substeps=4):
    from odelib_tpu_torch.ops import cuda_joint as TJ
    before = T.LAUNCHES["joint_metropolis_hastings_fused"]
    k = TJ.joint_metropolis_hastings_fused(
        specs, idxs, obs, tfs, y0s, th0, seed, nits=nits, burnin=burnin,
        walk_mask=mask, substeps_list=[substeps] * len(specs))
    assert T.LAUNCHES["joint_metropolis_hastings_fused"] == before + 1
    plans = [T._build_plan(sp, ob, tf, substeps) for sp, ob, tf in
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


def test_joint_kernel_unstaged_plans_match_twin(card):
    """substeps=50 (850 steps a solve): the two plans outgrow the 48 KB
    staged in shared memory, so the kernel reads them from global
    memory."""
    from odelib_tpu_torch.ops import cuda_joint as TJ
    specs, obs, tfs, y0s, idxs = _joint_inputs(card)
    plans = [T._build_plan(sp, ob, tf, 50) for sp, ob, tf in
             zip(specs, obs, tfs)]
    assert sum(a.nbytes for a in TJ.joint_tables(
        specs, plans, y0s, idxs, "dopri5")[:2]) > 48 * 1024
    rng = np.random.default_rng(2)
    th0 = (np.array([2.4e-8, 24.0, 0.6, 0.6])
           * np.exp(rng.normal(0, 0.05, (256, 4)))).astype(np.float32)
    _check_joint(specs, obs, tfs, y0s, idxs,
                 torch.as_tensor(th0, device="cuda"), 11, 4, 1,
                 (1.0, 1.0, 1.0, 0.0), substeps=50)


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


def test_joint_kernel_three_experiments(card):
    """K = 3 (zero_i on the demo and on perturbed data, one_i on the demo;
    blocks of three warps) on 1,000 chains: the last block's 24 dead lanes
    meet every barrier and store nothing."""
    from odelib_tpu_torch.models import one_i
    df = format_dataframe(load_demo_dataframe(host="H", virus="V"),
                          one_i.snames)
    times = np.linspace(0, df["time"].max(), 288)
    spec1 = one_i.spec()
    obs1, _ = build_obsdata_host(df, times, spec1.post_snames)
    tf1, obs1 = compact_observation_grid(obs1, times)
    y01 = np.array([df.loc["H"].iloc[0]["abundance"], 0.0,
                    df.loc["V"].iloc[0]["abundance"]])
    specs, obs, tfs, y0s, idxs = _joint_inputs(card)
    for x, extra in zip((specs, obs, tfs, y0s, idxs),
                        (spec1, obs1, tf1, y01, (4, 0, 1, 5))):
        x.append(extra)
    rng = np.random.default_rng(4)
    th0 = (np.array([2.4e-8, 22.0, 0.6, 0.6, 0.6, 1.2])
           * np.exp(rng.normal(0, 0.05, (1000, 6)))).astype(np.float32)
    _check_joint(specs, obs, tfs, y0s, idxs,
                 torch.as_tensor(th0, device="cuda"), 6, 20, 5,
                 (1.0, 1.0, 1.0, 1.0, 0.0, 1.0))


@pytest.mark.parametrize("prior_set", sorted(PRIOR_SETS))
def test_kernels_with_priors_match_twins(card, prior_set):
    """Each prior assignment (together the ten in-kernel families over
    zero_i's slots) through the ensemble, PT and joint kernels, bitwise
    against their twins with the same table (the MH kernel's prior cases
    are among the prefetch cases above)."""
    from odelib_tpu_torch.ops import cuda_joint as TJ
    spec, obs, tf, y0 = card
    priors = PRIOR_SETS[prior_set]
    table = prior_table(priors)
    plan = T._build_plan(spec, obs, tf, 4)
    draws = _draws(500, sd=0.05)
    dev = "cuda"
    # the ensemble: 500 walkers padded to two ensembles of 256
    walk = (1.0, 1.0, 1.0)
    k = T.ensemble_fused(spec, obs, tf, y0, torch.as_tensor(draws, device=dev),
                         11, nits=30, burnin=10, substeps=4, tile_chains=256,
                         priors=priors)
    th0 = torch.as_tensor(T.ensemble_init(draws, 11, 256, walk, 0.01).T
                          .copy(), device=dev)
    tw = T.ensemble_plain(spec, plan, y0, th0, 11, tile=256, nits=30,
                          burnin=10, a=2.0, walk=walk, walked=(True,) * 3,
                          num=3, W0=500, prior=table)
    torch.cuda.synchronize()
    assert_bitwise((k.theta.permute(1, 2, 0), k.chi.t(), k.rsquared.t(),
                    k.aic.t(), k.acceptance_ratio.t()), tw)
    # PT: 4 rungs on 500 chains
    temps = (1.0, 2.0, 4.0, 8.0)
    th = torch.as_tensor(draws, device=dev)
    k, rate = TP.parallel_tempering_fused(
        spec, obs, tf, y0, th, 11, temperatures=temps, nits=30, burnin=10,
        substeps=4, rwalk_std=0.1, priors=priors)
    scales, betas, dbetas = TP.ladder_constants(temps, 0.1, walk)
    tw = TP.pt_plain(spec, plan, y0, th.t().contiguous(), 11, nits=30,
                     burnin=10, scales=scales, walked=(True,) * 3,
                     betas=betas, dbetas=dbetas, swap_every=1, num=3,
                     prior=table)
    torch.cuda.synchronize()
    assert_bitwise((k.theta.permute(1, 2, 0), k.chi.t(), k.rsquared.t(),
                    k.aic.t(), k.acceptance_ratio.t()), tw[:5])
    np.testing.assert_array_equal(
        rate.cpu().numpy(), (tw[5][-1] / torch.tensor(
            float(TP.swap_attempts(30, 1, 1)[0]), device=dev)).cpu().numpy())
    # joint: the zero_i pair, one prior per joint slot (phi, beta, a:mu,
    # b:mu)
    specs, obs2, tfs, y0s, idxs = _joint_inputs(card)
    jpri = (priors[1], priors[2], priors[0], priors[0])
    jth0 = torch.as_tensor((np.array([2.4e-8, 24.0, 0.6, 0.6]) * np.exp(
        np.random.default_rng(2).normal(0, 0.05, (256, 4)))).astype(
            np.float32), device=dev)
    k = TJ.joint_metropolis_hastings_fused(
        specs, idxs, obs2, tfs, y0s, jth0, 11, nits=30, burnin=10,
        rwalk_std=0.1, priors=jpri)
    plans = [T._build_plan(sp, ob, tm, 4) for sp, ob, tm in
             zip(specs, obs2, tfs)]
    tw = TJ.joint_plain(specs, plans, y0s, idxs, jth0.t().contiguous(), 11,
                        nits=30, burnin=10, walk=(0.1,) * 4,
                        walked=(True,) * 4, prior=prior_table(jpri))
    torch.cuda.synchronize()
    assert_bitwise((k.theta.permute(1, 2, 0), k.chi.t(),
                    k.chi_parts.permute(1, 2, 0), k.acceptance_ratio.t()),
                   tw)


# the schedule substeps='auto' calibrates from the MH main path's seeds on
# the demo data: 21 steps a solve where substeps=4 takes 68
CALIBRATED = (3,) + (1,) * 14 + (2, 2)


@pytest.mark.parametrize("prior_set", sorted(PRIOR_SETS))
def test_kernels_on_a_calibrated_schedule_with_priors(card, prior_set):
    """The MH, ensemble, PT and joint kernels on a non-uniform schedule with
    each prior assignment: each wrapper's kernel (one launch) against the
    same call through its twin, bitwise."""
    from odelib_tpu_torch.ops import cuda_joint as TJ
    from odelib_tpu_torch.ops import plain_launchers
    spec, obs, tf, y0 = card
    assert len(CALIBRATED) == len(tf) - 1
    priors = PRIOR_SETS[prior_set]
    draws = torch.as_tensor(_draws(500, sd=0.05), device="cuda")
    jpri = (priors[1], priors[2], priors[0], priors[0])
    jth0 = torch.as_tensor((np.array([2.4e-8, 24.0, 0.6, 0.6]) * np.exp(
        np.random.default_rng(2).normal(0, 0.05, (256, 4)))).astype(
            np.float32), device="cuda")
    specs, obs2, tfs, y0s, idxs = _joint_inputs(card)
    runs = (
        (T.metropolis_hastings_fused, (spec, obs, tf, y0, draws, 11),
         dict(substeps=CALIBRATED, rwalk_std=0.1, priors=priors)),
        (T.ensemble_fused, (spec, obs, tf, y0, draws, 11),
         dict(substeps=CALIBRATED, tile_chains=256, priors=priors)),
        (TP.parallel_tempering_fused, (spec, obs, tf, y0, draws, 11),
         dict(substeps=CALIBRATED, rwalk_std=0.1, priors=priors)),
        (TJ.joint_metropolis_hastings_fused,
         (specs, idxs, obs2, tfs, y0s, jth0, 11),
         dict(substeps_list=[CALIBRATED] * 2, rwalk_std=0.1, priors=jpri)))
    for wrapper, args, kw in runs:
        before = sum(T.LAUNCHES.values())
        k = wrapper(*args, nits=30, burnin=10, **kw)
        assert sum(T.LAUNCHES.values()) == before + 1
        with plain_launchers():
            tw = wrapper(*args, nits=30, burnin=10, **kw)
        torch.cuda.synchronize()
        assert sum(T.LAUNCHES.values()) == before + 1
        (k, rate_k), (tw, rate_t) = ((r, None) if hasattr(r, "_fields")
                                     else r for r in (k, tw))
        assert_bitwise(k, tw)
        if rate_k is not None:
            assert_bitwise((rate_k,), (rate_t,))
        assert float(k.acceptance_ratio[:, -1].mean()) > 0


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
    sc = [T.scoring(T._build_plan(sde._spec, sde._obsdata_fit_host,
                                  sde._times_fit, 1))]
    lib = build.load_kernels(sde._spec, scoring=sc)
    assert lib._name == build.load_kernels(ode._spec, scoring=sc)._name
    assert "ODE_HAS_DIFFUSION" not in open(os.path.join(os.path.dirname(
        lib._name), "odelib_gen.cuh")).read()
    assert build.load_kernels(sde._spec, diffusion=True,
                              scoring=sc)._name != lib._name
    T.reset_launch_counts()
    with pytest.warns(UserWarning, match="DRIFT ONLY"):
        got = sde.MCMC(**kw)
    assert T.LAUNCHES["survey_fused"] == 1
    assert T.LAUNCHES["metropolis_hastings_fused"] == 1
    want = ode.MCMC(**kw)
    pd.testing.assert_frame_equal(got, want)
    assert np.isfinite(got["chi"]).all()


def _chunk_case(card, sampler):
    """(wrapper, args, kw) of a small run of each chunk-mode kernel on the
    card: MH and PT on 203 chains, the ensemble on 300 walkers padded to
    two ensembles of 256, PMMH (Euler and Milstein) on 202 chains x 40
    particles adapting for its 9 burn-in proposals, the joint pair on 203
    chains (a last block of 11 live lanes) with priors on its four
    dimensions."""
    from odelib_tpu_torch import distributions as D
    from odelib_tpu_torch.ops import cuda_joint as TJ
    from odelib_tpu_torch.ops import cuda_pf as TF
    if sampler in ("pmmh", "pmmh milstein"):
        spec, obs, tf, y0 = _gbm_inputs()
        th0 = torch.as_tensor(np.exp(np.random.default_rng(1).normal(
            np.log(0.4), 0.3, (202, 1))).astype(np.float32), device="cuda")
        return TF.pmmh_fused, (spec, obs, tf, y0, th0, 3), dict(
            nits=20, burnin=9, rwalk_std=0.3, n_particles=40, substeps=5,
            adapt_proposal=True, adapt_rate=0.15,
            sde_method="milstein" if sampler.endswith("milstein")
            else "euler")
    if sampler == "joint":
        specs, obs, tfs, y0s, idxs = _joint_inputs(card)
        rng = np.random.default_rng(2)
        th0 = (np.array([2.4e-8, 24.0, 0.6, 0.6])
               * np.exp(rng.normal(0, 0.05, (203, 4)))).astype(np.float32)
        pri = (D.LogNormal(s=0.2, scale=2.4e-8), D.Normal(loc=24.0, scale=2.0),
               None, D.Gamma(a=100.0, scale=0.006))
        return TJ.joint_metropolis_hastings_fused, (
            specs, idxs, obs, tfs, y0s, torch.as_tensor(th0, device="cuda"),
            11), dict(nits=40, burnin=10, substeps_list=[4, 4],
                      rwalk_std=0.05, priors=pri)
    spec, obs, tf, y0 = card
    n = 300 if sampler == "ensemble" else 203
    th0 = torch.as_tensor(_draws(n, sd=0.05), device="cuda")
    fn, extra = {"mh": (T.metropolis_hastings_fused, {}),
                 "ensemble": (T.ensemble_fused, dict(tile_chains=256)),
                 "pt": (TP.parallel_tempering_fused,
                        dict(temperatures=(1.0, 2.0, 4.0), swap_every=2))
                 }[sampler]
    return fn, (spec, obs, tf, y0, th0, 11), dict(nits=40, burnin=10,
                                                 substeps=4, **extra)


def _outputs(res):
    """Every array of a wrapper's result (PT: the records, the swap rate)."""
    parts = (res,) if hasattr(res, "_fields") else res
    return [v.cpu().numpy() for p in parts
            for v in (p if hasattr(p, "_fields") else (p,))]


@pytest.mark.parametrize("sampler", ["mh", "ensemble", "pt", "pmmh",
                                     "pmmh milstein", "joint"])
def test_chunked_kernel_equals_whole(card, sampler, tmp_path):
    """Chunk mode on the card: the proposals in chunks of 7 (a short last
    chunk; MH rounds cut mid-tree; PMMH's burn-in crosses a boundary; the
    joint kernel's state carries its parts and log prior), one launch
    each, and a run killed after two chunks and resumed from its file:
    every output bitwise that of one launch."""
    fn, args, kw = _chunk_case(card, sampler)
    whole = _outputs(fn(*args, **kw))
    before = T.LAUNCHES[fn.__name__]
    got = _outputs(fn(*args, checkpoint_every=7, **kw))
    assert T.LAUNCHES[fn.__name__] == before + -(-(kw["nits"] - 1) // 7)
    path = str(tmp_path / "run.progress")
    assert fn(*args, checkpoint_every=7, checkpoint_path=path,
              _stop_after_chunks=2, **kw) is None
    res = _outputs(fn(*args, checkpoint_every=7, checkpoint_path=path,
                      resume_from=path, **kw))
    for a, b, c in zip(whole, got, res):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_joint_chunk_kernel_matches_chunked_twin(card):
    """The joint kernel's CHUNK instantiation against the twin's chunk
    mode, launcher by launcher: three chunks (7, 7 and 5 proposals) from
    the first chunk's scoring of theta0, each chunk's records and its
    state (D log-thetas, chi, K parts, accept count, log prior) bitwise,
    with priors and without."""
    from odelib_tpu_torch.ops import cuda_joint as TJ
    fn, args, kw = _chunk_case(card, "joint")
    specs, idxs, obs, tfs, y0s, th0, seed = args
    plans = [T._build_plan(sp, ob, tf, 4) for sp, ob, tf in
             zip(specs, obs, tfs)]
    th = th0.t().contiguous()
    for pri in (prior_table(kw["priors"]), None):
        run = dict(nits=20, burnin=4, walk=(0.05,) * 4,
                   walked=(True,) * 4, prior=pri)
        state_k = state_t = None
        for it_base, R in ((0, 7), (7, 7), (14, 5)):
            rec_k, state_k = TJ.joint_launcher(
                specs, plans, y0s, idxs, "dopri5", th, seed, R_chunk=R,
                **run)(it_base=it_base, state=state_k)
            rec_t, state_t = TJ.joint_plain(
                specs, plans, y0s, idxs, th, seed, R_chunk=R,
                it_base=it_base, state=state_t, **run)
            torch.cuda.synchronize()
            for a, b in zip(rec_k + (state_k,), rec_t + (state_t,)):
                np.testing.assert_array_equal(a.cpu().numpy(),
                                              b.cpu().numpy())
        assert 0 < float(rec_k[3][-1].mean()) < 1


@pytest.mark.parametrize("K,two_state", [(128, False), (40, True)])
def test_pf_kernel_milstein_matches_twin(K, two_state):
    """The Milstein pf_kernel (a library built with ODE_MILSTEIN) against
    pmmh_plain(milstein=True) at 256 chains: the main path's GBM with 128
    particles, and a two-state SDE whose diffusion couples the states
    with 40 (2 a lane): every record bitwise; Euler's run on the same
    chains differs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from odelib_tpu_torch.model import ObsData
    from odelib_tpu_torch.ops import cuda_pf as TF
    spec, obs, tf, y0 = _gbm_inputs()
    P = 1
    if two_state:
        def drift(t, y, ps):
            return [ps[0] * y[0], (ps[0] - 0.2) * y[1]]

        def noise(t, y, ps):
            return [0.3 * y[0] * np.sqrt(y[1]),
                    0.2 * y[1] + 0.05 * y[0] * y[1] / (1.0 + y[0])]
        spec = make_spec(adapt_rhs(drift), ("mu", "B0"), ("A", "B"),
                         diffusion=adapt_rhs(noise))
        obs = ObsData(
            log_abundance=np.r_[obs.log_abundance, obs.log_abundance[:4]
                                - 0.5],
            log_sigma=np.full(12, 0.15), abundance=np.r_[
                obs.abundance, np.exp(obs.log_abundance[:4] - 0.5)],
            t_index=np.r_[obs.t_index, np.arange(1, 5)],
            state_index=np.r_[np.zeros(8), np.ones(4)].astype(np.int32),
            sstot=obs.sstot)
        y0, P = np.array([2.0, 1.0]), 2
    rng = np.random.default_rng(1)
    th = np.exp(rng.normal(np.log(0.4), 0.3, (256, 1)))
    if two_state:
        th = np.c_[th, np.exp(rng.normal(0.0, 0.1, (256, 1)))]
    th0 = torch.as_tensor(th.astype(np.float32), device="cuda")
    kw = dict(nits=6, burnin=2, rwalk_std=0.3, n_particles=K, substeps=5,
              adapt_proposal=True, adapt_rate=0.15)
    before = T.LAUNCHES["pmmh_fused"]
    k = TF.pmmh_fused(spec, obs, tf, y0, th0, 3, sde_method="milstein",
                      **kw)
    assert T.LAUNCHES["pmmh_fused"] == before + 1
    plan = T._build_plan(spec, obs, tf, 5)
    tw = TF.pmmh_plain(spec, plan, y0, th0.t().contiguous(), 3, K=K,
                       nits=6, burnin=2, walk=(1.0,) * P,
                       walked=(True,) * P, rwalk_std=0.3, adapt=True,
                       target=0.3, adapt_rate=0.15, milstein=True)
    torch.cuda.synchronize()
    got = [k.theta.permute(1, 2, 0), k.chi.t(), k.acceptance_ratio.t()]
    for a, b in zip(got, tw):        # bitwise: the same float32 operations
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    assert np.isfinite(k.chi.cpu().numpy()).all()
    euler = TF.pmmh_fused(spec, obs, tf, y0, th0, 3, **kw)
    assert (euler.chi != k.chi).any()


# -- every observation model, censoring and doses ---------------------------

def _scoring_inputs(case):
    from scoring_cases import COUNT_SCALE, zero_i_case
    fam, censor, dosed = case
    scale = COUNT_SCALE.get(fam, 1.0)
    spec, obs, tf, y0 = zero_i_case(fam, censor, dosed, scale=scale)
    return spec, obs, tf, y0, np.array([0.6, 2.4e-8 * scale, 24.0])


def _held(case, got, want):
    """Kernel against twin: bitwise, but for the Tobit terms (double
    erfc/erfcx/log1p of two libraries, rounded to float32 once) within
    1e-6 relative, with the same accept sequences."""
    for a, b in zip(got, want):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        if case[1]:
            np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
            np.testing.assert_allclose(a, b, rtol=1e-6)
        else:
            np.testing.assert_array_equal(a, b)


_SCORING_KERNELS = ("survey", "mh", "ensemble", "pt", "joint")


@pytest.mark.parametrize("kernel", _SCORING_KERNELS)
@pytest.mark.parametrize("case", SCORING, ids=[scoring_id(c)
                                              for c in SCORING])
def test_scoring_branch_kernel_matches_twin(case, kernel):
    """Each kernel, through its wrapper, on each compiled scoring branch
    (zero_i on the demo data: the family, left- and right-censored points,
    a virus dose at t = 1) against its twin on the same tensors (the twin
    by ``plain_launchers``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from odelib_tpu_torch.ops import cuda_joint as TJ
    from odelib_tpu_torch.ops import plain_launchers
    spec, obs, tf, y0, centre = _scoring_inputs(case)
    rng = np.random.default_rng(0)

    def draws(n, sd):
        return torch.as_tensor((centre * np.exp(rng.normal(0, sd, (n, 3))))
                               .astype(np.float32), device="cuda")
    if kernel == "survey":
        th = draws(1000, 0.2)
        k = T.survey_fused(spec, obs, tf, y0, th, substeps=2)
        plan = T._build_plan(spec, obs, tf, 2)
        _held(case, [k], [T.survey_plain(spec, plan, y0, th.t().contiguous())])
        return
    kw = dict(nits=24, burnin=4, substeps=2)
    if kernel == "mh":
        th0 = draws(256, 0.03)

        def run():
            return T.metropolis_hastings_fused(spec, obs, tf, y0, th0, 11,
                                               **kw)
    elif kernel == "ensemble":
        th0 = draws(512, 0.03)

        def run():
            return T.ensemble_fused(spec, obs, tf, y0, th0, 11,
                                    tile_chains=256, **kw)
    elif kernel == "pt":
        th0 = draws(256, 0.03)

        def run():
            return TP.parallel_tempering_fused(
                spec, obs, tf, y0, th0, 11, temperatures=(1.0, 2.0, 4.0),
                **kw)[0]
    else:
        th0 = draws(128, 0.03)
        lspec, lobs, ltf, ly0, _ = _scoring_inputs(("lognormal", (), False))
        if case[0] == "poisson":          # the same (scaled) data, exact
            lobs, ltf, ly0 = obs._replace(censor=None), tf, y0

        def run():
            return TJ.joint_metropolis_hastings_fused(
                (spec, lspec), ((0, 1, 2), (0, 1, 2)), (obs, lobs),
                (tf, ltf), (y0, ly0), th0, 11, nits=24, burnin=4,
                substeps_list=[2, 2])
    n0 = sum(T.LAUNCHES.values())
    k = run()
    assert sum(T.LAUNCHES.values()) == n0 + 1
    with plain_launchers():
        t = run()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(k.acceptance_ratio.cpu().numpy(),
                                  t.acceptance_ratio.cpu().numpy())
    _held(case, [k.theta, k.chi], [t.theta, t.chi])
    assert np.isfinite(k.chi.cpu().numpy()).all()
    assert 0 < float(k.acceptance_ratio[:, -1].mean()) < 1


@pytest.mark.parametrize("case", [("student_t", ("left",), True),
                                  ("poisson", (), False),
                                  ("negbinom", (), True)],
                         ids=["student_t-censored-dosed", "poisson",
                              "negbinom-dosed"])
def test_pf_kernel_scoring_branches_match_twin(case):
    """The particle filter on the GBM with the family's terms through
    ``contrib``, a left-censored point and a dose after the block at
    t = 2 (the particles take it after resampling)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses
    from odelib_tpu_torch.ops import cuda_pf as TF
    fam, censor, dosed = case
    spec, obs, tf, y0 = _gbm_inputs()
    if fam != "student_t":       # counts: 50 N from N0 = 100
        ab = np.round(50.0 * obs.abundance)
        obs = obs._replace(log_abundance=np.log(ab), abundance=ab)
        y0 = 50.0 * y0
    if censor:
        obs = obs._replace(censor=np.array([0, 0, 1, 0, 0, 0, 1, 0],
                                           np.int32))
    spec = dataclasses.replace(
        spec, obs_model=fam, obs_param={"student_t": 4.0, "poisson": 0.0,
                                        "negbinom": 10.0}[fam],
        dose_events=((2.0, 0, 1.5 if fam == "student_t" else 75.0),)
        if dosed else None)
    th0 = torch.as_tensor(np.exp(np.random.default_rng(1).normal(
        np.log(0.4), 0.3, (202, 1))).astype(np.float32), device="cuda")
    k = TF.pmmh_fused(spec, obs, tf, y0, th0, 3, nits=6, burnin=2,
                      rwalk_std=0.3, n_particles=128, substeps=5)
    plan = T._build_plan(spec, obs, tf, 5)
    tw = TF.pmmh_plain(spec, plan, y0, th0.t().contiguous(), 3, K=128,
                       nits=6, burnin=2, walk=(1.0,), walked=(True,),
                       rwalk_std=0.3)
    torch.cuda.synchronize()
    _held(case, [k.theta.permute(1, 2, 0), k.chi.t(),
                 k.acceptance_ratio.t()], tw)
    assert np.isfinite(k.chi.cpu().numpy()).all()


def test_tobit_device_functions_against_float64(card):
    """log Phi within 2e-6 relative of float64 over z in [-37, 8]; the
    t log-CDF within 1e-5 for nu in {1, 2, 4, 10, 30, 100}, z in
    [-50, 50], where the float64 value is a normal float32 (the probe
    kernel odelib_tobit)."""
    import scipy.special as sp
    import scipy.stats as ss
    from odelib_tpu_torch.ops import build
    lib = build.load_kernels(card[0], scoring=[T.scoring(T._build_plan(
        *card[:3], 1))])

    def probe(z, which, tc=None):
        zt = torch.as_tensor(z, device="cuda")
        out = torch.empty_like(zt)
        tc = tc or T.t_constants(1.0)
        build.check(lib, lib.odelib_tobit(
            zt.data_ptr(), zt.numel(), which, tc["nu"], tc["a"],
            tc["thresh"], tc["ka"], tc["kb"], out.data_ptr(),
            build.stream(zt.device)), "tobit")
        return out.cpu().numpy().astype(np.float64)
    z = np.linspace(-37.0, 8.0, 20001).astype(np.float32)
    np.testing.assert_allclose(probe(z, 0), sp.log_ndtr(z.astype(float)),
                               rtol=2e-6, atol=0)
    z = np.linspace(-50.0, 50.0, 20001).astype(np.float32)
    for nu in (1.0, 2.0, 4.0, 10.0, 30.0, 100.0):
        want = ss.t.logcdf(z.astype(float), nu)
        got = probe(z, 1, T.t_constants(nu))
        normal = np.abs(want) >= np.finfo(np.float32).tiny
        np.testing.assert_allclose(got[normal], want[normal], rtol=1e-5)


# -- the stiff path: the kernels' kvaerno3 instantiations -------------------

def _stiff_inputs(card, model):
    """(spec, host obs, grid, y0, draws) of zero_i on the demo (S = 2) or
    of the Robertson fit on its config-5 data (S = 3, ``scoring_cases``):
    draws around the fit."""
    if model == "zero_i":
        return (*card, _draws(1000, sd=0.05))
    from odelib_tpu_torch.models import robertson
    from scoring_cases import ROBERTSON_T_STEPS, robertson_frame
    fw = robertson.framework(robertson_frame(), t_steps=ROBERTSON_T_STEPS,
                             device="cpu")
    rng = np.random.default_rng(3)
    draws = (np.array(robertson.default_theta)
             * np.exp(rng.normal(0, 0.05, (1000, 3)))).astype(np.float32)
    return (fw._spec, fw._obsdata_fit_host, fw._times_fit, fw.get_inits(),
            draws)


@pytest.mark.parametrize("model", ["zero_i", "robertson"])
def test_kvaerno3_kernels_match_twins(card, model):
    """The survey, MH, ensemble and PT kernels with stepper='kvaerno3' (a
    library built with ODE_KVAERNO3) against their twins, whose steps are
    kvaerno3_fixed_step with the traced Jacobian, bitwise, each launched
    once; and MH in chunks of 7 bitwise its whole run."""
    spec, obs, tf, y0, draws = _stiff_inputs(card, model)
    plan = T._build_plan(spec, obs, tf, 4)
    th = torch.as_tensor(draws, device="cuda")
    kw = dict(substeps=4, stepper="kvaerno3")
    T.reset_launch_counts()
    chi = T.survey_fused(spec, obs, tf, y0, th, **kw)
    chi_t = T.survey_plain(spec, plan, y0, th.t().contiguous(), "kvaerno3")
    torch.cuda.synchronize()
    assert np.isfinite(chi.cpu().numpy()).all()
    np.testing.assert_array_equal(chi.cpu().numpy(), chi_t.cpu().numpy())
    th0 = th[:256]
    mh = T.metropolis_hastings_fused(spec, obs, tf, y0, th0, 11, nits=30,
                                     burnin=5, **kw)
    tw = T.mh_plain(spec, plan, y0, th0.t().contiguous(), 11, nits=30,
                    burnin=5, walk=(0.05,) * 3, walked=(True,) * 3, num=3,
                    stepper="kvaerno3")
    torch.cuda.synchronize()
    assert_bitwise((mh.theta.permute(1, 2, 0), mh.chi.t(), mh.rsquared.t(),
                    mh.aic.t(), mh.acceptance_ratio.t()), tw)
    chunked = T.metropolis_hastings_fused(spec, obs, tf, y0, th0, 11,
                                          nits=30, burnin=5,
                                          checkpoint_every=7, **kw)
    assert_bitwise([v.permute(1, 2, 0) if v.ndim == 3 else v.t()
                    for v in (chunked.theta, chunked.chi, chunked.rsquared,
                              chunked.aic, chunked.acceptance_ratio)],
                   [v.permute(1, 2, 0) if v.ndim == 3 else v.t()
                    for v in (mh.theta, mh.chi, mh.rsquared, mh.aic,
                              mh.acceptance_ratio)])
    ens = T.ensemble_fused(spec, obs, tf, y0, th[:512], 11, nits=10,
                           burnin=2, tile_chains=256, **kw)
    start = torch.as_tensor(T.ensemble_init(draws[:512], 11, 256,
                                            (1.0,) * 3, 0.01).T.copy(),
                            device="cuda")
    tw = T.ensemble_plain(spec, plan, y0, start, 11, tile=256, nits=10,
                          burnin=2, a=2.0, walk=(1.0,) * 3,
                          walked=(True,) * 3, num=3, W0=512,
                          stepper="kvaerno3")
    torch.cuda.synchronize()
    assert_bitwise((ens.theta.permute(1, 2, 0), ens.chi.t(),
                    ens.rsquared.t(), ens.aic.t(),
                    ens.acceptance_ratio.t()), tw)
    temps = (1.0, 2.0, 4.0, 8.0)
    pt, rate = TP.parallel_tempering_fused(spec, obs, tf, y0, th0, 11,
                                           temperatures=temps, nits=10,
                                           burnin=2, **kw)
    scales, betas, dbetas = TP.ladder_constants(temps, 0.05, [1, 1, 1])
    tw = TP.pt_plain(spec, plan, y0, th0.t().contiguous(), 11, nits=10,
                     burnin=2, scales=scales, walked=(True,) * 3,
                     betas=betas, dbetas=dbetas, swap_every=1, num=3,
                     stepper="kvaerno3")
    torch.cuda.synchronize()
    assert_bitwise((pt.theta.permute(1, 2, 0), pt.chi.t(), pt.rsquared.t(),
                    pt.aic.t(), pt.acceptance_ratio.t()), tw[:5])
    assert {k: v for k, v in T.LAUNCHES.items() if v} == {
        "survey_fused": 1, "metropolis_hastings_fused": 1 + -(-29 // 7),
        "ensemble_fused": 1, "parallel_tempering_fused": 1}


# --- forcings and array parameters ---------------------------------------

def _forced_zero_i(t, y, ps, u):
    mu, phi, beta = ps
    S, V = y
    return [mu * u["g"] * S - phi * S * V, beta * phi * S * V - phi * S * V]


def _vec_zero_i(t, y, ps):
    mu, phi, beta = ps
    S, V = y
    return [mu[0] * S - phi * S * V,
            beta * phi * S * V - phi * S * V - mu[1] * V]


# each mode of the forcing g = ((0, 1.5, 3.2), (0.8, 1.4, 0.9)); zero_i
# with mu a 2-vector, its second entry walked or pinned at 0
_FA_CASES = ("linear", "hold", "cubic", "array", "array-pinned")


def _fa_case(card, case):
    """(spec, draws (N, P) float32, walk mask) of a forced or an
    array-parameter zero_i on the demo data."""
    _, obs, tf, y0 = card
    base = _draws(1000, sd=0.05)
    if case.startswith("array"):
        spec = make_spec(adapt_rhs(_vec_zero_i), zero_i.pnames,
                         zero_i.snames, pshapes=((2,), (), ()))
        pinned = case.endswith("pinned")
        mu1 = np.zeros(len(base)) if pinned else 0.05 * base[:, 0]
        draws = np.c_[base[:, :1], mu1, base[:, 1:]].astype(np.float32)
        return spec, draws, (1.0, 0.0 if pinned else 1.0, 1.0, 1.0)
    spec = make_spec(adapt_rhs(_forced_zero_i), zero_i.pnames, zero_i.snames,
                     forcings={"g": ((0.0, 1.5, 3.2), (0.8, 1.4, 0.9), case)})
    return spec, base, (1.0, 1.0, 1.0)


@pytest.mark.parametrize("stepper", ["dopri5", "rk4", "kvaerno3"])
@pytest.mark.parametrize("case", _FA_CASES)
def test_survey_kernel_forced_and_array_matches_twin(card, case, stepper):
    """The survey kernel reads the plan's forcing table (a row per
    distinct stage time) or an array parameter's slots: bitwise the
    twin's."""
    _, obs, tf, y0 = card
    spec, draws, _ = _fa_case(card, case)
    th = torch.as_tensor(draws, device="cuda")
    k = T.survey_fused(spec, obs, tf, y0, th, substeps=4, stepper=stepper)
    plan = T._build_plan(spec, obs, tf, 4)
    tw = T.survey_plain(spec, plan, y0, th.t().contiguous(), stepper)
    torch.cuda.synchronize()
    assert np.isfinite(k.cpu().numpy()).mean() > 0.9
    np.testing.assert_array_equal(k.cpu().numpy(), tw.cpu().numpy())


@pytest.mark.parametrize("sampler", ["mh", "ensemble", "pt"])
@pytest.mark.parametrize("case", _FA_CASES)
def test_chain_kernels_forced_and_array_match_twins(card, case, sampler):
    """MH, ensemble and PT through their wrappers, kernel (one launch)
    against twin (plain_launchers) on the card: every record bitwise; a
    pinned entry stays 0."""
    from odelib_tpu_torch.ops import plain_launchers
    _, obs, tf, y0 = card
    spec, draws, mask = _fa_case(card, case)
    th0 = torch.as_tensor(draws[:512], device="cuda")
    kw = dict(nits=24, burnin=4, substeps=4, walk_mask=mask)
    if sampler == "mh":
        def run():
            return T.metropolis_hastings_fused(spec, obs, tf, y0, th0, 11,
                                               **kw)
    elif sampler == "ensemble":
        def run():
            return T.ensemble_fused(spec, obs, tf, y0, th0, 11,
                                    tile_chains=256, **kw)
    else:
        def run():
            return TP.parallel_tempering_fused(
                spec, obs, tf, y0, th0, 11, temperatures=(1.0, 2.0, 4.0),
                **kw)[0]
    n0 = sum(T.LAUNCHES.values())
    k = run()
    torch.cuda.synchronize()
    assert sum(T.LAUNCHES.values()) == n0 + 1
    with plain_launchers():
        t = run()
    torch.cuda.synchronize()
    assert_bitwise([k.theta, k.chi, k.rsquared, k.aic, k.acceptance_ratio],
                   [t.theta, t.chi, t.rsquared, t.aic, t.acceptance_ratio])
    if case == "array-pinned":
        assert (k.theta[:, :, 1] == 0.0).all()


def test_joint_kernel_forced_and_array_matches_twin(card):
    """A joint fit of zero_i, forced zero_i (hold) and the array model
    (three ModelN types, each reading its experiment's plan and forcing
    table), sharing phi and beta: bitwise the twin's."""
    spec, obs, tf, y0 = card
    f_spec, _, _ = _fa_case(card, "hold")
    a_spec, _, _ = _fa_case(card, "array")
    rng = np.random.default_rng(7)
    obs_b = obs._replace(log_abundance=obs.log_abundance
                         + rng.normal(0, 0.1, len(obs.log_abundance)))
    specs = [spec, f_spec, a_spec]
    idxs = [(2, 0, 1), (3, 0, 1), (4, 5, 0, 1)]
    th0 = (np.array([2.4e-8, 24.0, 0.6, 0.6, 0.6, 0.03])
           * np.exp(rng.normal(0, 0.05, (256, 6)))).astype(np.float32)
    _check_joint(specs, [obs, obs_b, obs], [tf] * 3, [y0, 1.13 * y0, y0],
                 idxs, torch.as_tensor(th0, device="cuda"), 11, 20, 5,
                 (1.0,) * 6)


@pytest.mark.parametrize("method", ["euler", "milstein"])
def test_pf_kernel_forced_matches_twin(method):
    """PMMH on the GBM with its drift scaled by a linear forcing: the Euler
    row of the forcing table at each step's start reaches the drift, the
    diffusion and the Milstein term. Bitwise the twin's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from odelib_tpu_torch.ops import cuda_pf as TF
    base, obs, tf, y0 = _gbm_inputs()

    def gbm(t, y, ps, u):
        return [ps[0] * u["a"] * y[0]]

    def noise(t, y, ps, u):
        return [(0.2 + 0.1 * u["a"]) * y[0]]
    spec = make_spec(adapt_rhs(gbm), ("mu",), ("N",),
                     diffusion=adapt_rhs(noise),
                     forcings={"a": ((0.0, 2.0, 4.0), (1.2, 0.6, 1.0))})
    th0 = torch.as_tensor(np.exp(np.random.default_rng(1).normal(
        np.log(0.4), 0.3, (202, 1))).astype(np.float32), device="cuda")
    k = TF.pmmh_fused(spec, obs, tf, y0, th0, 3, nits=6, burnin=2,
                      rwalk_std=0.3, n_particles=128, substeps=5,
                      sde_method=method)
    plan = T._build_plan(spec, obs, tf, 5)
    tw = TF.pmmh_plain(spec, plan, y0, th0.t().contiguous(), 3, K=128,
                       nits=6, burnin=2, walk=(1.0,), walked=(True,),
                       rwalk_std=0.3, milstein=method == "milstein")
    torch.cuda.synchronize()
    assert_bitwise([k.theta.permute(1, 2, 0), k.chi.t(),
                    k.acceptance_ratio.t()], tw)
    assert np.isfinite(k.chi.cpu().numpy()).all()


# --- ladders of any length, fits of any size, models of any size ---------

# (swap_every, K, priors, walk mask): one warp's group of 16 and of 32
# lanes, then the WIDE instantiations (a library built with ODE_WIDE): a
# chain over two warps (33: a group of 64 with 31 idle lanes; 40 with
# priors), over four warps, a block of 128 threads holding one chain (100),
# over eight (256 rungs, one parameter walked: the most its RNG slots
# allow), and a chain of 512 lanes under the 512-thread launch bound (300
# rungs, nothing walked)
_WALK = [1, 0, 1]
_LADDERS = [(1, 16, False, _WALK), (2, 32, False, _WALK),
            (1, 33, False, _WALK), (1, 40, True, _WALK),
            (3, 100, False, _WALK), (1, 256, False, [0, 0, 1]),
            (2, 300, False, [0, 0, 0])]


@pytest.mark.parametrize("every,K,prior,mask", _LADDERS)
def test_pt_kernel_long_ladders_match_twin(card, every, K, prior, mask):
    from odelib_tpu_torch import distributions as D
    spec, obs, tf, y0 = card
    temps = tuple(float(t) for t in np.geomspace(1.0, 1000.0, K))
    th0 = torch.as_tensor(_draws(203, sd=0.05), device="cuda")
    pri = (D.LogNormal(s=0.5, scale=0.6), None,
           D.Normal(loc=24.0, scale=3.0)) if prior else None
    before = T.LAUNCHES["parallel_tempering_fused"]
    k, rate = TP.parallel_tempering_fused(
        spec, obs, tf, y0, th0, 11, temperatures=temps, swap_every=every,
        nits=16, burnin=4, substeps=4, walk_mask=mask, priors=pri)
    assert T.LAUNCHES["parallel_tempering_fused"] == before + 1
    scales, betas, dbetas = TP.ladder_constants(temps, 0.05, mask)
    tw = TP.pt_plain(spec, T._build_plan(spec, obs, tf, 4), y0,
                     th0.t().contiguous(), 11, nits=16, burnin=4,
                     scales=scales, walked=tuple(m != 0 for m in mask),
                     betas=betas,
                     dbetas=dbetas, swap_every=every, num=3,
                     prior=None if pri is None else prior_table(pri))
    torch.cuda.synchronize()
    _equal_runs([k.theta.permute(1, 2, 0), k.chi.t(), k.rsquared.t(),
                 k.aic.t(), k.acceptance_ratio.t()], tw[:5])
    att = TP.swap_attempts(16, every, 1)[0]
    np.testing.assert_array_equal(rate.cpu().numpy(),
                                  (tw[5][-1] / torch.tensor(
                                      att, dtype=torch.float32,
                                      device="cuda")).cpu().numpy())


def _wide_joint_inputs(card, K, shared):
    """K zero_i experiments on the demo data perturbed per experiment
    (numpy seed 7 + k), initial abundances x (1 + k / 100); ``shared``
    names the tied slots (of mu, phi, beta), each experiment's others its
    own. Returns specs, obs, grids, y0s, idx maps and the joint centre."""
    spec, obs, tf, y0 = card
    names = ("mu", "phi", "beta")
    centre = [(0.6, 2.4e-8, 24.0)[names.index(p)] for p in shared]
    exps = []
    for k in range(K):
        rng = np.random.default_rng(7 + k)
        ob = obs if k == 0 else obs._replace(
            log_abundance=obs.log_abundance
            + rng.normal(0, 0.1, len(obs.log_abundance)))
        idx = []
        for i, p in enumerate(names):
            if p in shared:
                idx.append(shared.index(p))
            else:
                idx.append(len(centre))
                centre.append((0.6, 2.4e-8, 24.0)[i])
        exps.append((spec, ob, tf, (1 + k / 100) * y0, tuple(idx)))
    return [list(x) for x in zip(*exps)] + [np.asarray(centre)]


# (K, shared, chains, smem_cap): nine experiments on eight warps (warp 0
# scores two); 33 experiments, D = 67, with the planes forced into device
# memory; 56, D = 168, the planes above 48 KB of shared memory (opted in)
_WIDE_JOINT = [(9, ("phi", "beta"), 203, 0), (33, ("mu",), 100, 4096),
               (56, (), 64, 0)]


@pytest.mark.parametrize("K,shared,C,cap", _WIDE_JOINT)
def test_joint_wide_kernel_matches_twin(card, K, shared, C, cap):
    from odelib_tpu_torch.ops import cuda_joint as TJ
    specs, obs, tfs, y0s, idxs, centre = _wide_joint_inputs(card, K, shared)
    D = len(centre)
    rng = np.random.default_rng(K)
    th0 = torch.as_tensor((centre * np.exp(rng.normal(0, 0.05, (C, D))))
                          .astype(np.float32).T.copy(), device="cuda")
    plans = [T._build_plan(sp, ob, tf, 2) for sp, ob, tf in
             zip(specs, obs, tfs)]
    run = dict(nits=8, burnin=2, walk=(0.02,) * D, walked=(True,) * D)
    T.reset_launch_counts()
    rec_k = TJ.joint_launcher(specs, plans, y0s, idxs, "dopri5", th0, 5,
                              smem_cap=cap, **run)()
    assert T.LAUNCHES["joint_metropolis_hastings_fused"] == 1
    rec_t = TJ.joint_plain(specs, plans, y0s, idxs, th0, 5, **run)
    torch.cuda.synchronize()
    for a, b in zip(rec_k, rec_t):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    assert 0 < float(rec_k[3][-1].mean()) < 1


def test_joint_wide_chunk_kernel_equals_whole(card):
    """The WIDE joint kernel's chunk mode with priors: 9 experiments in chunks
    of 3 proposals, bitwise one launch."""
    from odelib_tpu_torch import distributions as D
    from odelib_tpu_torch.ops import cuda_joint as TJ
    specs, obs, tfs, y0s, idxs, centre = _wide_joint_inputs(
        card, 9, ("phi", "beta"))
    rng = np.random.default_rng(1)
    th0 = torch.as_tensor((centre * np.exp(rng.normal(
        0, 0.05, (100, len(centre))))).astype(np.float32), device="cuda")
    pri = [D.LogNormal(s=0.2, scale=2.4e-8), D.Normal(loc=24.0, scale=2.0)] \
        + [D.Gamma(a=100.0, scale=0.006)] * 9
    kw = dict(nits=12, burnin=3, substeps_list=[2] * 9, rwalk_std=0.05,
              priors=pri)
    fn = TJ.joint_metropolis_hastings_fused
    whole = _outputs(fn(specs, idxs, obs, tfs, y0s, th0, 3, **kw))
    got = _outputs(fn(specs, idxs, obs, tfs, y0s, th0, 3,
                      checkpoint_every=3, **kw))
    for a, b in zip(whole, got):
        np.testing.assert_array_equal(a, b)


def _chain_inputs(n, sub=4):
    """two_i with n latent classes on the demo (``scoring_cases``), draws
    around its fit with tau 15 (Dopri5-stable at the grid's steps)."""
    from scoring_cases import chain_case, chain_theta
    spec, obs, tf, y0 = chain_case(n)
    centre = np.asarray(chain_theta(n))
    centre[4] = 15.0
    rng = np.random.default_rng(n)
    draws = (centre * np.exp(rng.normal(0, 0.05, (200, 5)))).astype(
        np.float32)
    return spec, obs, tf, y0, draws, T._build_plan(spec, obs, tf, sub)


@pytest.mark.parametrize("n", [31, 40])
def test_chain_model_kernels_match_twins(n):
    """33 and 42 states (member masks of two words): the survey, MH,
    ensemble, PT and joint (the chain on the demo twice, sharing mu, phi
    and beta) kernels against their twins, bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from odelib_tpu_torch.ops import cuda_joint as TJ
    spec, obs, tf, y0, draws, plan = _chain_inputs(n)
    th = torch.as_tensor(draws, device="cuda")
    chi = T.survey_fused(spec, obs, tf, y0, th, substeps=4)
    chi_t = T.survey_plain(spec, plan, y0, th.t().contiguous())
    torch.cuda.synchronize()
    assert np.isfinite(chi.cpu().numpy()).all()
    np.testing.assert_array_equal(chi.cpu().numpy(), chi_t.cpu().numpy())
    th0 = th[:40]
    mh = T.metropolis_hastings_fused(spec, obs, tf, y0, th0, 11, nits=6,
                                     burnin=1, substeps=4, rwalk_std=0.02)
    tw = T.mh_plain(spec, plan, y0, th0.t().contiguous(), 11, nits=6,
                    burnin=1, walk=(0.02,) * 5, walked=(True,) * 5, num=5)
    torch.cuda.synchronize()
    assert_bitwise((mh.theta.permute(1, 2, 0), mh.chi.t(), mh.rsquared.t(),
                    mh.aic.t(), mh.acceptance_ratio.t()), tw)
    ens = T.ensemble_fused(spec, obs, tf, y0, th[:200], 11, nits=4,
                           burnin=1, tile_chains=256, substeps=4)
    start = torch.as_tensor(T.ensemble_init(draws[:200], 11, 256,
                                            (1.0,) * 5, 0.01).T.copy(),
                            device="cuda")
    tw = T.ensemble_plain(spec, plan, y0, start, 11, tile=256, nits=4,
                          burnin=1, a=2.0, walk=(1.0,) * 5,
                          walked=(True,) * 5, num=5, W0=200)
    torch.cuda.synchronize()
    assert_bitwise((ens.theta.permute(1, 2, 0), ens.chi.t(),
                    ens.rsquared.t(), ens.aic.t(),
                    ens.acceptance_ratio.t()), tw)
    temps = (1.0, 2.0, 4.0)
    pt, _ = TP.parallel_tempering_fused(spec, obs, tf, y0, th0, 11,
                                        temperatures=temps, nits=4,
                                        burnin=1, substeps=4,
                                        rwalk_std=0.02)
    scales, betas, dbetas = TP.ladder_constants(temps, 0.02, [1] * 5)
    tw = TP.pt_plain(spec, plan, y0, th0.t().contiguous(), 11, nits=4,
                     burnin=1, scales=scales, walked=(True,) * 5,
                     betas=betas, dbetas=dbetas, swap_every=1, num=5)
    torch.cuda.synchronize()
    assert_bitwise((pt.theta.permute(1, 2, 0), pt.chi.t(), pt.rsquared.t(),
                    pt.aic.t(), pt.acceptance_ratio.t()), tw[:5])
    run = dict(nits=4, burnin=1, walk=(0.02,) * 7, walked=(True,) * 7)
    jth = torch.cat([th0[:, :3], th0[:, 3:], th0[:, 3:]], 1).t().contiguous()
    idxs = [(0, 1, 2, 3, 4), (0, 1, 2, 5, 6)]
    rec_k = TJ.joint_launcher([spec] * 2, [plan] * 2, [y0] * 2, idxs,
                              "dopri5", jth, 5, **run)()
    rec_t = TJ.joint_plain([spec] * 2, [plan] * 2, [y0] * 2, idxs, jth, 5,
                           **run)
    torch.cuda.synchronize()
    for a, b in zip(rec_k, rec_t):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


def test_chain_model_wide_pt_matches_twin():
    """A 40-rung ladder (the WIDE PT kernel, a chain over two warps) at 42
    states, 24 chains x 6 iterations, bitwise its twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec, obs, tf, y0, draws, plan = _chain_inputs(40)
    th0 = torch.as_tensor(draws[:24], device="cuda")
    temps = tuple(float(t) for t in np.geomspace(1.0, 1000.0, 40))
    before = T.LAUNCHES["parallel_tempering_fused"]
    pt, rate = TP.parallel_tempering_fused(spec, obs, tf, y0, th0, 11,
                                           temperatures=temps, nits=6,
                                           burnin=1, substeps=4,
                                           rwalk_std=0.02)
    assert T.LAUNCHES["parallel_tempering_fused"] == before + 1
    scales, betas, dbetas = TP.ladder_constants(temps, 0.02, [1] * 5)
    tw = TP.pt_plain(spec, plan, y0, th0.t().contiguous(), 11, nits=6,
                     burnin=1, scales=scales, walked=(True,) * 5,
                     betas=betas, dbetas=dbetas, swap_every=1, num=5)
    torch.cuda.synchronize()
    assert_bitwise((pt.theta.permute(1, 2, 0), pt.chi.t(), pt.rsquared.t(),
                    pt.aic.t(), pt.acceptance_ratio.t()), tw[:5])
    np.testing.assert_array_equal(
        rate.cpu().numpy(), (tw[5][-1] / torch.tensor(
            TP.swap_attempts(6, 1, 1)[0], dtype=torch.float32,
            device="cuda")).cpu().numpy())


def test_chain_model_kvaerno3_matches_twin():
    """33 states through kvaerno3 (step_kvaerno3's unrolled elimination
    and solves): the survey and MH kernels against their twins, bitwise,
    at substeps 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec, obs, tf, y0, draws, plan = _chain_inputs(31, sub=1)
    th = torch.as_tensor(draws[:16], device="cuda")
    kw = dict(substeps=1, stepper="kvaerno3")
    chi = T.survey_fused(spec, obs, tf, y0, th, **kw)
    chi_t = T.survey_plain(spec, plan, y0, th.t().contiguous(), "kvaerno3")
    torch.cuda.synchronize()
    assert np.isfinite(chi.cpu().numpy()).any()
    np.testing.assert_array_equal(chi.cpu().numpy(), chi_t.cpu().numpy())
    mh = T.metropolis_hastings_fused(spec, obs, tf, y0, th[:8], 11, nits=3,
                                     burnin=0, rwalk_std=0.02, **kw)
    tw = T.mh_plain(spec, plan, y0, th[:8].t().contiguous(), 11, nits=3,
                    burnin=0, walk=(0.02,) * 5, walked=(True,) * 5, num=5,
                    stepper="kvaerno3")
    torch.cuda.synchronize()
    assert_bitwise((mh.theta.permute(1, 2, 0), mh.chi.t(), mh.rsquared.t(),
                    mh.aic.t(), mh.acceptance_ratio.t()), tw)


def test_chain_model_pf_kernel_matches_twin():
    """PMMH at 33 states: the chain with a diffusion on its virus (the
    scorer's two-word masks in pf_kernel), 64 chains x 32 particles x 3
    proposals, bitwise its twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from odelib_tpu_torch.ops import cuda_pf as TF
    from scoring_cases import chain_sde_spec
    spec0, obs, tf, y0, draws, _ = _chain_inputs(31, sub=2)
    spec = chain_sde_spec(31)
    plan = T._build_plan(spec, obs, tf, 2)
    th0 = torch.as_tensor(draws[:64], device="cuda")
    k = TF.pmmh_fused(spec, obs, tf, y0, th0, 3, nits=3, burnin=1,
                      rwalk_std=0.02, n_particles=32, substeps=2,
                      adapt_proposal=False)
    tw = TF.pmmh_plain(spec, plan, y0, th0.t().contiguous(), 3, K=32,
                       nits=3, burnin=1, walk=(1.0,) * 5,
                       walked=(True,) * 5, rwalk_std=0.02, prior=None,
                       adapt=False, target=0.3, adapt_rate=0.15)
    torch.cuda.synchronize()
    got = [k.theta.permute(1, 2, 0), k.chi.t(), k.acceptance_ratio.t()]
    for a, b in zip(got, tw):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
