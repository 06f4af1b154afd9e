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
from odelib_tpu.data import (build_obsdata_host, compact_observation_grid,
                             format_dataframe)
from odelib_tpu.model import make_spec
from odelib_tpu.ops import pallas_pt as JP
from odelib_tpu.samplers.pt import swap_attempts as jax_swap_attempts
from odelib_tpu_torch.distributions import DiscreteNormal
from odelib_tpu_torch.model import make_spec as t_make_spec
from odelib_tpu_torch.ops import cuda_mh as T
from odelib_tpu_torch.ops import cuda_pf as TF
from odelib_tpu_torch.ops import cuda_pt as TP
from odelib_tpu_torch.ops.priors import logprior_plain, prior_table
from odelib_tpu_torch.rhs import adapt_rhs
from odelib_tpu_torch.samplers.pt import swap_attempts

from helpers import synthetic_df, zero_i
from test_torch_api import _framework, _report_numbers
from test_torch_ensemble import _inits, _theta0
from test_torch_mh_prefetch import PRIOR_SETS
from test_torch_priors import jax_priors
from test_torch_survey import _PN, _SN, setup  # noqa: F401

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


# the ladders above the old 8-rung limit, geometric from 1 to 1,000: 9
# (one rung past it) and 33 (a chain over two warps on the card; the
# interpret-mode reference unrolls every rung's solve, and at 33 rungs
# compiles for minutes even on two steps, so it runs in the full suite)
_LONG = {9: 24, 33: 12}


@pytest.fixture(scope="module")
def short_setup():
    """The survey fixture's data and grid up to t = 0.8: two grid steps."""
    df = format_dataframe(synthetic_df(), _SN)
    df = df[np.isclose(np.mod(np.round(df["time"] / 0.2), 2), 0)]
    df = df[df["time"] <= 0.8]
    times = np.linspace(0, 3.1, 288)
    times = times[times <= 0.8]
    spec = make_spec(zero_i, _PN, _SN)
    obs_host, _ = build_obsdata_host(df, times, spec.post_snames)
    times_fit, obs_fit = compact_observation_grid(obs_host, times)
    y0 = np.array([df.loc["S"].iloc[0]["abundance"],
                   df.loc["V"].iloc[0]["abundance"]])
    return (spec, t_make_spec(adapt_rhs(zero_i), _PN, _SN), obs_fit,
            times_fit, y0)


@pytest.mark.parametrize("K", [9, pytest.param(33, marks=pytest.mark.slow)])
def test_pt_long_ladders_match_pallas_interpret(short_setup, K):
    """The T=1 accept sequence and the cold pair's swap counts equal the
    JAX kernel's on ladders of 9 and 33 rungs (32 chains, the data up to
    t = 0.8); theta within 1e-5, chi within 5e-5."""
    spec, tspec, obs_fit, times_fit, y0 = short_setup
    assert len(times_fit) == 3
    temps = tuple(float(t) for t in np.geomspace(1.0, 1000.0, K))
    nits = _LONG[K]
    kw = dict(temperatures=temps, swap_every=1, nits=nits,
              burnin=nits // 2, substeps=1, rwalk_std=0.1)
    th0 = _theta0(32)
    ref, ref_rate = JP.parallel_tempering_fused(
        spec, obs_fit, times_fit, y0, th0, seed=11, tile_chains=128,
        interpret=True, **kw)
    obs_t, th_t, seed, y0_t = T.inputs_from_reference(obs_fit, th0, 11, y0)
    got, rate = TP.parallel_tempering_fused(tspec, obs_t, times_fit, y0_t,
                                            th_t, seed, **kw)
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    np.testing.assert_array_equal(rate.numpy(), np.asarray(ref_rate))
    assert 0 < float(rate.mean()) <= 1
    assert 0 < float(got.acceptance_ratio[:, -1].mean()) < 1
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               rtol=1e-5)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(ref.chi),
                               rtol=5e-5)


@pytest.mark.parametrize("nits,every", [(24, 1), (24, 2), (25, 3), (2, 5)])
def test_swap_attempts_match_odelib_tpu(nits, every):
    np.testing.assert_array_equal(swap_attempts(nits, every, 3),
                                  jax_swap_attempts(nits, every, 3))


def _fake_scorer(*_args, **_kw):
    """A cheap stand-in for the solve (the RNG layout and the swap logic
    do not depend on it): chi a quadratic in log theta, R^2 from chi."""
    def score(theta):
        chi = sum((torch.log(th) - torch.tensor(0.1 * p)) ** 2
                  for p, th in enumerate(theta)) * torch.tensor(40.0)
        return chi, torch.tensor(1.0) - chi / torch.tensor(100.0)
    return score


def pt_slot_layout(K, n_walked, it):
    """pt.cu's closed-form counters of iteration ``it``: rung k's first
    slot (its walk normals, two slots each, then its accept uniform) and
    pair k's swap uniform."""
    per_rung = 2 * n_walked + 1
    return ([it * 1024 + k * per_rung for k in range(K)],
            [it * 1024 + K * per_rung + k for k in range(K - 1)])


_MASKS = {1: [0, 1, 0], 2: [1, 0, 1], 3: [1, 1, 1]}


@pytest.mark.parametrize("K", [2, 3, 4, 8])
@pytest.mark.parametrize("n_walked", [1, 2, 3])
def test_pt_slot_layout_is_the_serial_draw_order(monkeypatch, K, n_walked):
    """The counters pt_plain draws, in order, are the closed-form layout's:
    per rung its walk normals and accept uniform from its first slot, then
    each pair's uniform."""
    drawn = []

    class Recording(T.Rng):
        def bits(self):
            drawn.append(self._it * 1024 + self._slot)
            return super().bits()
    monkeypatch.setattr(TP, "Rng", Recording)
    monkeypatch.setattr(TP, "make_scorer", _fake_scorer)
    temps = tuple(1.5 ** k for k in range(K))
    mask = _MASKS[n_walked]
    scales, betas, dbetas = TP.ladder_constants(temps, 0.3, mask)
    TP.pt_plain(None, None, None, torch.as_tensor(_theta0(2).T.copy()), 5,
                nits=3, burnin=0, scales=scales,
                walked=tuple(m != 0 for m in mask), betas=betas,
                dbetas=dbetas, swap_every=1, num=3)
    expect = []
    for it in (1, 2):
        rungs, pairs = pt_slot_layout(K, n_walked, it)
        for first in rungs:
            expect += list(range(first, first + 2 * n_walked + 1))
        expect += pairs
    assert drawn == expect


def _wide_exchange(C, K, lanes):
    """pt.cu's WIDE swap exchange: chain c's lanes are threads c G + k of
    a grid of blocks of max(128, G) threads, G the next power of two >= K.
    Every lane writes its planes (``lanes[k]``: per rung a list of (C,)
    tensors) to its block's shared memory at its thread index, the block
    waits, and each lane reads the planes of thread me - k + partner.
    Returns ``read(k, partner) -> planes``, reading those block buffers."""
    G = 1 << (K - 1).bit_length()
    block = max(128, G)
    n_blocks = -(-C * G // block)
    n_planes = len(lanes[0])
    xs = torch.full((n_blocks, n_planes, block), float("nan"))
    for c in range(C):
        for k in range(K):
            t = c * G + k
            for q in range(n_planes):
                xs[t // block, q, t % block] = lanes[k][q][c]

    def read(k, partner):
        out = []
        for q in range(n_planes):
            v = torch.empty(C)
            for c in range(C):
                me = (c * G + k) % block
                v[c] = xs[(c * G + k) // block, q, me - k + partner]
            out.append(v)
        return out
    return read


def _pt_lanes(theta0, seed, nits, scales, walked, betas, dbetas, every,
              prior=None):
    """pt.cu lane by lane: each rung draws from its closed-form slots, then
    every lane takes the partner of its due pair (one parity), reads the
    partner's chi (and log prior) as the shuffles do (above 32 rungs from
    the block's shared memory, :func:`_wide_exchange`), and both lanes of
    a pair compute the same delta (lower rung's chi - lp first) and
    decision from the pair's own uniform.
    Returns the cold rung's chi per iteration, its accept and swap counts."""
    score = _fake_scorer()
    K, P = len(betas), theta0.shape[0]
    n_w = sum(walked)
    key = T.Rng(seed, torch.arange(theta0.shape[1]))._key
    chi0, _ = score(list(theta0))
    lt = [[torch.log(th) for th in theta0] for _ in range(K)]
    chi = [chi0] * K
    lp = [torch.zeros_like(chi0) if prior is None
          else logprior_plain(prior, list(theta0))] * K
    acc = sw = torch.zeros_like(chi0)
    out = []
    for it in range(1, nits):
        rungs, pairs = pt_slot_layout(K, n_w, it)
        for k in range(K):
            ctr, prop = rungs[k], []
            for p in range(P):
                if walked[p]:
                    prop.append(lt[k][p] + torch.tensor(scales[k][p])
                                * TF.rng_normal(key, ctr))
                    ctr += 2
                else:
                    prop.append(lt[k][p])
            thp = [torch.exp(v) for v in prop]
            chi_new, _ = score(thp)
            log_ratio = chi[k] - chi_new
            if prior is not None:
                lp_new = logprior_plain(prior, thp)
                log_ratio = log_ratio + (lp_new - lp[k])
            ok = torch.exp(log_ratio * torch.tensor(betas[k])) \
                > T.uniform_of(key, ctr)
            lt[k] = [torch.where(ok, a, b) for a, b in zip(prop, lt[k])]
            chi[k] = torch.where(ok, chi_new, chi[k])
            if prior is not None:
                lp[k] = torch.where(ok, lp_new, lp[k])
            if k == 0:
                acc = acc + ok.to(torch.float32)
        if it % every == 0:
            parity = (it // every) % 2
            lt0, chi0_, lp0 = [list(v) for v in lt], list(chi), list(lp)
            if K > 32:     # the WIDE layout: planes through shared memory
                read = _wide_exchange(theta0.shape[1], K, [
                    [chi0_[k], lp0[k]] + lt0[k] for k in range(K)])
            for k in range(K):          # every lane at once, from lt0/chi0_
                lo = k if k % 2 == parity else k - 1
                paired = 0 <= lo and lo + 1 < K
                partner = (k + 1 if lo == k else lo) if paired else k
                if K > 32:
                    chi_o, lp_o, *lt_o = read(k, partner)
                else:
                    chi_o = chi0_[partner]          # the width-G shuffles
                    lp_o = lp0[partner]
                    lt_o = lt0[partner]
                if not paired:
                    continue
                e, e_o = chi0_[k], chi_o
                if prior is not None:
                    e, e_o = chi0_[k] - lp0[k], chi_o - lp_o
                delta = torch.tensor(dbetas[lo]) * (
                    e - e_o if lo == k else e_o - e)
                flag = (torch.exp(delta) > T.uniform_of(key, pairs[lo])) \
                    & torch.isfinite(delta)
                lt[k] = [torch.where(flag, y, x)
                         for x, y in zip(lt0[k], lt_o)]
                chi[k] = torch.where(flag, chi_o, chi0_[k])
                lp[k] = torch.where(flag, lp_o, lp0[k])
                if k == 0:
                    sw = sw + flag.to(torch.float32)
        out.append(chi[0])
    return torch.stack(out), acc, sw


@pytest.mark.parametrize("K", [2, 3, 4, 8, 16, 32, 40])
def test_pt_lane_parallel_swaps_equal_the_serial_loop(monkeypatch, K):
    """The kernel's layout (a rung per lane, due pairs deciding at once;
    above 32 rungs a chain over two warps exchanging through the block's
    shared memory) gives pt_plain's serial-loop records bitwise: the cold
    chi, accepts and swaps (16 chains, 12 iterations, swaps every 1 and
    2)."""
    monkeypatch.setattr(TP, "make_scorer", _fake_scorer)
    temps = tuple(2.0 ** k for k in range(K))
    mask = [1, 0, 1]
    walked = (True, False, True)
    scales, betas, dbetas = TP.ladder_constants(temps, 0.4, mask)
    th0 = torch.as_tensor(_theta0(16).T.copy())
    for every in (1, 2):
        recs = TP.pt_plain(None, None, None, th0, 9, nits=13, burnin=0,
                           scales=scales, walked=walked, betas=betas,
                           dbetas=dbetas, swap_every=every, num=3)
        chi, acc, sw = _pt_lanes(th0, 9, 13, scales, walked, betas, dbetas,
                                 every)
        np.testing.assert_array_equal(chi.numpy(), recs[1].numpy())
        np.testing.assert_array_equal((acc / 12).numpy(), recs[4][-1].numpy())
        np.testing.assert_array_equal(sw.numpy(), recs[5][-1].numpy())
        assert 0 < float(sw.sum()) and 0 < float(acc.sum()) < 16 * 12


@pytest.mark.parametrize("K", [3, 4])
def test_pt_lane_parallel_swaps_with_priors(monkeypatch, K):
    """As above with in-kernel priors: each lane carries its rung's log
    prior, the due pairs' delta takes chi - lp, and lp swaps with chi."""
    monkeypatch.setattr(TP, "make_scorer", _fake_scorer)
    temps = tuple(2.0 ** k for k in range(K))
    mask = [1, 0, 1]
    walked = (True, False, True)
    scales, betas, dbetas = TP.ladder_constants(temps, 0.4, mask)
    th0 = torch.as_tensor(_theta0(16).T.copy())
    prior = prior_table(PRIOR_SETS["gamma-truncnorm-exponential"])
    for every in (1, 2):
        recs = TP.pt_plain(None, None, None, th0, 9, nits=13, burnin=0,
                           scales=scales, walked=walked, betas=betas,
                           dbetas=dbetas, swap_every=every, num=3,
                           prior=prior)
        chi, acc, sw = _pt_lanes(th0, 9, 13, scales, walked, betas, dbetas,
                                 every, prior)
        np.testing.assert_array_equal(chi.numpy(), recs[1].numpy())
        np.testing.assert_array_equal((acc / 12).numpy(), recs[4][-1].numpy())
        np.testing.assert_array_equal(sw.numpy(), recs[5][-1].numpy())
        assert 0 < float(sw.sum()) and 0 < float(acc.sum()) < 16 * 12


def test_pt_twin_with_priors_matches_pallas_interpret(setup):  # noqa: F811
    """In-kernel priors of the new families: the T=1 accept sequence and
    the cold pair's swap counts equal the JAX kernel's with the same
    priors; theta and chi within the no-prior test's tolerances."""
    spec, tspec, obs_fit, times_fit, y0 = setup
    priors = PRIOR_SETS["cauchy-halfnormal-weibull"]
    th0 = _theta0(128)
    kw = dict(temperatures=_TEMPS, swap_every=1, nits=_NITS, burnin=_BURNIN,
              substeps=1, rwalk_std=0.1)
    ref, ref_rate = JP.parallel_tempering_fused(
        spec, obs_fit, times_fit, y0, th0, seed=7, tile_chains=128,
        interpret=True, priors=jax_priors(priors), **kw)
    obs_t, th_t, seed, y0_t = T.inputs_from_reference(obs_fit, th0, 7, y0)
    got, rate = TP.parallel_tempering_fused(tspec, obs_t, times_fit, y0_t,
                                            th_t, seed, priors=priors, **kw)
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    np.testing.assert_array_equal(rate.numpy(), np.asarray(ref_rate))
    plain, _ = TP.parallel_tempering_fused(tspec, obs_t, times_fit, y0_t,
                                           th_t, seed, **kw)
    assert (plain.acceptance_ratio != got.acceptance_ratio).any()
    assert 0 < float(rate.mean()) <= 1
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               rtol=1e-5)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(ref.chi),
                               rtol=5e-5)


def test_pt_twin_with_priors_on_a_schedule_matches_pallas_interpret(
        setup):  # noqa: F811
    """Priors on a non-uniform schedule, the shape substeps='auto' gives:
    the T=1 accept sequence and the cold pair's swap counts equal the JAX
    kernel's with the same priors and schedule; theta and chi within the
    no-prior test's tolerances."""
    spec, tspec, obs_fit, times_fit, y0 = setup
    priors = PRIOR_SETS["beta-none-gamma"]
    th0 = _theta0(128)
    sched = (3,) + (1,) * (len(times_fit) - 4) + (2, 2)
    kw = dict(temperatures=_TEMPS, swap_every=1, nits=_NITS, burnin=_BURNIN,
              substeps=sched, rwalk_std=0.1)
    ref, ref_rate = JP.parallel_tempering_fused(
        spec, obs_fit, times_fit, y0, th0, seed=7, tile_chains=128,
        interpret=True, priors=jax_priors(priors), **kw)
    obs_t, th_t, seed, y0_t = T.inputs_from_reference(obs_fit, th0, 7, y0)
    got, rate = TP.parallel_tempering_fused(tspec, obs_t, times_fit, y0_t,
                                            th_t, seed, priors=priors, **kw)
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    np.testing.assert_array_equal(rate.numpy(), np.asarray(ref_rate))
    assert 0 < float(got.acceptance_ratio[:, -1].mean()) < 1
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               rtol=1e-5)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(ref.chi),
                               rtol=5e-5)


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
            (dict(swap_every=0), ValueError, "swap_every"),
            (dict(burnin=7), ValueError, "no recorded"),
            (dict(priors=[None, DiscreteNormal(0.0, 1.0), None]),
             ValueError, "unsupported prior family"),
            (dict(checkpoint_every=0), ValueError, ">= 1")):
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
