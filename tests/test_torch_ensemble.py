"""Fused ensemble: the port's ``ensemble_fused`` (torch twin on the CPU)
against ``odelib_tpu``'s Pallas kernel in interpret mode, and the whole
``MCMC(sampler='ensemble')`` slice against odelib_tpu's. Kernel-versus-twin
on the card is in tests/test_torch_cuda.py and chip_smoke.py.

Where the values part: the two packages start from bitwise-equal walkers
and make the same accept decisions, but take ``log``/``exp`` from
different libraries (XLA:CPU's own against torch's), so log-theta differs
by an ulp from the first iteration on. A stretch move
``c + (1 - z)(partner - c)`` with z up to a = 2 extrapolates: it can
triple a state's error and hands it on to every walker that takes it as a
partner, so the ulps grow with the iterations (MH keeps them at ~1e-6).
Measured after 23 iterations (max relative, CPU): theta 2.7e-5, R^2
1.5e-5, chi 5.0e-4 and AIC 3.5e-4 (two ensembles, substeps=1); chi's
log residuals amplify a theta difference. The witness argument that this
is the state's ulps and not a difference of scheme: each package's chi
records are the scores of its own recorded thetas (the port's exactly;
the reference's within 5.6e-5, the interpret-mode arithmetic gap of
tests/test_torch_survey.py), while the accept sequences are equal.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import odelib_tpu
import odelib_tpu_torch
from odelib_tpu.ops import pallas_mh as J
from odelib_tpu_torch.distributions import DiscreteNormal
from odelib_tpu_torch.ops import cuda_mh as T

from test_torch_api import _framework, _report_numbers
from test_torch_mh_prefetch import PRIOR_SETS
from test_torch_priors import jax_priors
from test_torch_survey import setup  # noqa: F401  (module fixture)

_NITS, _BURNIN = 24, 12
# (W0, tile, walk_mask, substeps, seed): one full ensemble; the padding
# case W0 < tile with a static slot; two ensembles side by side. The
# padding case runs seed 8; at seed 7 it meets an ulp tie in a padded
# walker (test_ensemble_ulp_tie_at_seed_7).
_CASES = {"one-ensemble": (256, 256, None, 2, 7),
          "padded-static": (200, 256, [1, 0, 1], 2, 8),
          "two-ensembles": (512, 256, None, 1, 7)}


def _theta0(W0, seed=3):
    rng = np.random.default_rng(seed)
    return (np.array([0.6, 2.4e-8, 24.0])
            * np.exp(rng.normal(0, 0.05, (W0, 3)))).astype(np.float32)


@pytest.fixture(scope="module")
def refs(setup):  # noqa: F811
    """The JAX kernel's records for every case, computed once, with the
    walkers it started from (captured at its run function)."""
    spec, _, obs_fit, times_fit, y0 = setup
    out = {}
    orig = J._cached_ens_run
    for name, (W0, tile, mask, substeps, seed) in _CASES.items():
        seen = {}

        def capture(*a, **k):
            run = orig(*a, **k)

            def wrapped(seed_arr, theta_tiles):
                seen["theta0"] = np.asarray(theta_tiles)
                return run(seed_arr, theta_tiles)
            return wrapped
        J._cached_ens_run = capture
        try:
            ref = J.ensemble_fused(spec, obs_fit, times_fit, y0,
                                   _theta0(W0), seed=seed, nits=_NITS,
                                   burnin=_BURNIN, walk_mask=mask,
                                   substeps=substeps, tile_chains=tile,
                                   interpret=True)
        finally:
            J._cached_ens_run = orig
        P = seen["theta0"].shape[0]
        out[name] = (ref, seen["theta0"].reshape(P, -1).T)
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.array(x)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_ensemble_twin_matches_pallas_interpret(setup, refs, case):  # noqa: F811
    spec, tspec, obs_fit, times_fit, y0 = setup
    W0, tile, mask, substeps, seed = _CASES[case]
    ref, ref_theta0 = refs[case]
    th0 = _theta0(W0)
    # the jittered and padded start points are the JAX package's, bitwise
    walk = tuple(float(w) for w in (mask or [1.0] * 3))
    start = T.ensemble_init(th0, seed, tile, walk, 0.01)
    assert start.shape == (-(-W0 // tile) * tile, 3)
    np.testing.assert_array_equal(start, ref_theta0)

    obs_t, th_t, seed, y0_t = T.inputs_from_reference(obs_fit, th0, seed,
                                                      y0)
    got = T.ensemble_fused(tspec, obs_t, times_fit, y0_t, th_t, seed,
                           nits=_NITS, burnin=_BURNIN, walk_mask=mask,
                           substeps=substeps, tile_chains=tile)
    R = _NITS - 1 - _BURNIN
    assert got.theta.shape == (W0, R, 3) and got.chi.shape == (W0, R)
    np.testing.assert_array_equal(got.iteration.numpy(),
                                  np.asarray(ref.iteration))
    # the accept sequences are equal for every walker and record
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    assert 0 < float(got.acceptance_ratio[:, -1].mean()) < 1
    # the grown ulps (module docstring): measured max over the cases
    # theta 2.7e-5, R^2 1.5e-5, chi 5.0e-4, aic 3.5e-4
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               rtol=5e-5)
    np.testing.assert_allclose(got.rsquared.numpy(),
                               np.asarray(ref.rsquared), rtol=5e-5)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(ref.chi),
                               rtol=1e-3)
    np.testing.assert_allclose(got.aic.numpy(), np.asarray(ref.aic),
                               rtol=1e-3)
    # the witnesses: each side's chi is the port's score of its own theta
    # (the port's exactly, the reference's within 5.6e-5)
    for chi, theta, tol in ((got.chi, got.theta, 0.0),
                            (ref.chi, ref.theta, 1e-4)):
        s = T.survey_fused(tspec, obs_t, times_fit, y0_t,
                           _np(theta).reshape(-1, 3), substeps=substeps,
                           device="cpu")
        np.testing.assert_allclose(s.numpy(), _np(chi).reshape(-1),
                                   rtol=tol)
    np.testing.assert_array_equal(
        got.aic.numpy(), np.float32(2.0) * got.chi.numpy() + np.float32(6.0))
    if mask is not None:        # the static slot never moves
        fixed = got.theta[:, :, 1].numpy()
        assert (fixed == fixed[:, :1]).all()
        np.testing.assert_allclose(fixed[:, 0], th0[:, 1], rtol=1e-6)


@pytest.mark.parametrize("prior_set,substeps", [
    pytest.param("beta-none-gamma", 2, id="beta-none-gamma"),
    pytest.param("cauchy-halfnormal-weibull", 2,
                 id="cauchy-halfnormal-weibull"),
    pytest.param("gamma-truncnorm-exponential", "auto-like",
                 id="gamma-truncnorm-exponential-schedule")])
def test_ensemble_twin_with_priors_matches_pallas_interpret(
        setup, prior_set, substeps):  # noqa: F811
    """In-kernel priors of the new families on one ensemble of 256, on 2
    substeps or the shape of schedule substeps='auto' gives (3 steps in the
    first interval, 1 in most, 2 in the last two): the same accept
    sequences as the JAX kernel with the same priors and schedule, theta
    and chi within the no-prior test's tolerances."""
    spec, tspec, obs_fit, times_fit, y0 = setup
    priors = PRIOR_SETS[prior_set]
    th0 = _theta0(256)
    if substeps == "auto-like":
        substeps = (3,) + (1,) * (len(times_fit) - 4) + (2, 2)
    kw = dict(nits=_NITS, burnin=_BURNIN, substeps=substeps, tile_chains=256)
    ref = J.ensemble_fused(spec, obs_fit, times_fit, y0, th0, seed=7,
                           interpret=True, priors=jax_priors(priors), **kw)
    obs_t, th_t, seed, y0_t = T.inputs_from_reference(obs_fit, th0, 7, y0)
    got = T.ensemble_fused(tspec, obs_t, times_fit, y0_t, th_t, seed,
                           priors=priors, **kw)
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    plain = T.ensemble_fused(tspec, obs_t, times_fit, y0_t, th_t, seed, **kw)
    assert (plain.acceptance_ratio != got.acceptance_ratio).any()
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               rtol=5e-5)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(ref.chi),
                               rtol=1e-3)


def _accept_steps(ar):
    """Per-iteration accept indicators (W, R) from running acceptance
    ratios (W, R) recorded from iteration 1."""
    its = np.arange(1, ar.shape[1] + 1)
    return np.diff(np.concatenate([np.zeros((ar.shape[0], 1)),
                                   np.round(ar * its)], 1), axis=1)


def _log_ratio_gap(tspec, obs, times, y0, theta_rows, chi_rows, start, seed,
                   tile, it, g, a, walk, substeps):
    """|log_ratio - log u| of walker ``g``'s stretch move at iteration
    ``it``, recomputed from the port's records (rows = iterations from 1),
    as the twin forms it: the walker's state before the iteration, its
    partner's after the first half when ``g`` is in the second."""
    M32 = 0xFFFFFFFF
    half = tile // 256
    e, rem = divmod(g, tile)
    row, lane = divmod(rem, 128)
    hb = int(row >= half)
    scal = T.mix(torch.tensor((seed * 0x7FEB352D + e * tile + 0xE75) & M32))
    sbits = int(T.mix(scal ^ T.mix(torch.tensor(it * 2 + hb))))
    r_sub, r_lane = sbits % half, (sbits >> 8) % 128
    partner = e * tile + ((0 if hb else half) + (row - hb * half - r_sub)
                          % half) * 128 + (lane - r_lane) % 128

    def state(w, after):
        r = it - 2 + after
        return start[w] if r < 0 else theta_rows[w, r]
    cur = torch.log(torch.as_tensor(state(g, 0)))
    other = torch.log(torch.as_tensor(state(partner, hb)))
    rng = T.Rng(seed, torch.tensor([g]))
    rng.start(it)
    draws = [rng.uniform()[0] for _ in range(4)]
    u, uacc = draws[2 * hb], draws[2 * hb + 1]
    one = torch.tensor(1.0)
    t = one + torch.tensor(np.float32(a - 1.0)) * u
    z = (t * t) / torch.tensor(np.float32(a))
    prop = torch.stack([c + ((one - z) * (o - c)) * torch.tensor(np.float32(w))
                        if w else c for c, o, w in zip(cur, other, walk)])
    chi_new = float(T.survey_fused(tspec, obs, times, y0,
                                   torch.exp(prop)[None], substeps=substeps)[0])
    chi_old = float(chi_rows[g, it - 2]) if it >= 2 else float(
        T.survey_fused(tspec, obs, times, y0, torch.as_tensor(start[g:g + 1]),
                       substeps=substeps)[0])
    nw1 = np.float32(sum(w != 0 for w in walk) - 1)
    log_ratio = (float(nw1 * torch.log(z)) + chi_old) - chi_new
    return abs(log_ratio - float(torch.log(uacc)))


def test_ensemble_ulp_tie_at_seed_7(setup):  # noqa: F811
    """The padding case at seed 7, every walker recorded (the padded start
    points passed in, no jitter): the packages' accept decisions part at one
    ulp-level tie, walker 219 (a padded clone) at iteration 6, where the
    stretch move's |log_ratio - log u| lies inside the packages' chi gap.
    Up to it every walker's accept sequence is equal and every record
    agrees within the kernel-level tolerances."""
    spec, tspec, obs_fit, times_fit, y0 = setup
    seed, tile, mask, nits, substeps = 7, 256, [1, 0, 1], 8, 2
    walk = (1.0, 0.0, 1.0)
    start = T.ensemble_init(_theta0(200), seed, tile, walk, 0.01)
    kw = dict(nits=nits, burnin=0, substeps=substeps, walk_mask=mask,
              init_jitter=0.0, tile_chains=tile)
    ref = J.ensemble_fused(spec, obs_fit, times_fit, y0, start, seed=seed,
                           interpret=True, **kw)
    obs = T.obsdata_from_arrays(obs_fit)
    got = T.ensemble_fused(tspec, obs, times_fit, y0, torch.as_tensor(start),
                           seed, **kw)
    flip = _accept_steps(got.acceptance_ratio.numpy()) != _accept_steps(
        np.asarray(ref.acceptance_ratio))
    first = int(flip.any(0).argmax())
    assert flip.any() and first + 1 == 6
    assert np.where(flip[:, first])[0].tolist() == [219]
    gap = _log_ratio_gap(tspec, obs, times_fit, y0, got.theta.numpy(),
                         got.chi.numpy(), start, seed, tile, first + 1, 219,
                         2.0, walk, substeps)
    assert gap < 1e-4, gap          # measured 1.2e-5
    before = slice(0, first)
    for a, b, tol in ((got.theta, ref.theta, 5e-5),
                      (got.rsquared, ref.rsquared, 5e-5),
                      (got.chi, ref.chi, 1e-3), (got.aic, ref.aic, 1e-3)):
        np.testing.assert_allclose(_np(a)[:, before], _np(b)[:, before],
                                   rtol=tol)
    np.testing.assert_array_equal(
        got.acceptance_ratio.numpy()[:, before],
        np.asarray(ref.acceptance_ratio)[:, before])


def test_ensembles_are_independent(setup):  # noqa: F811
    """Each tile is its own ensemble: the second ensemble's walkers do not
    depend on the first's, and the first runs alone as it does beside the
    second."""
    _, tspec, obs_fit, times_fit, y0 = setup
    obs = T.obsdata_from_arrays(obs_fit)
    th0 = torch.as_tensor(_theta0(512))
    kw = dict(nits=6, burnin=2, substeps=1, tile_chains=256,
              init_jitter=0.0)
    both = T.ensemble_fused(tspec, obs, times_fit, y0, th0, 5, **kw)
    first = T.ensemble_fused(tspec, obs, times_fit, y0, th0[:256], 5, **kw)
    np.testing.assert_array_equal(both.theta[:256].numpy(),
                                  first.theta.numpy())
    changed = th0.clone()
    changed[:256] *= 1.01
    other = T.ensemble_fused(tspec, obs, times_fit, y0, changed, 5, **kw)
    np.testing.assert_array_equal(both.theta[256:].numpy(),
                                  other.theta[256:].numpy())


def test_ensemble_rejects_bad_arguments(setup):  # noqa: F811
    _, tspec, obs_fit, times_fit, y0 = setup
    obs = T.obsdata_from_arrays(obs_fit)
    th0 = torch.as_tensor(_theta0(8))
    for kw, err, msg in ((dict(tile_chains=128), ValueError, "256"),
                         (dict(a=1.0), ValueError, "exceed 1"),
                         (dict(burnin=7), ValueError, "no recorded"),
                         (dict(priors=[None, DiscreteNormal(0.0, 1.0),
                                       None]), ValueError,
                          "unsupported prior family"),
                         (dict(checkpoint_every=0), ValueError, ">= 1")):
        with pytest.raises(err, match=msg):
            T.ensemble_fused(tspec, obs, times_fit, y0, th0, 0, nits=8,
                             **{"burnin": 2, **kw})

_M32 = 0xFFFFFFFF


def _kernel_columns(j, tile, seed, it, hb):
    """ensemble.cu's thread-column mapping in its C integer arithmetic:
    the walker of column ``j`` in half ``hb`` and, at iteration ``it``, its
    partner in the other half."""
    hn, half = tile // 2, tile // 256
    e = j // hn
    jj = j - e * hn
    rp, lane = jj // 128, jj % 128
    lo = half if hb else 0
    scal_base = T.mix((seed * 0x7FEB352D + e * tile + 0xE75) & _M32)
    sbits = T.mix(scal_base ^ T.mix(torch.tensor(it * 2 + hb)))
    r_sub, r_lane = sbits % half, (sbits >> 8) % 128
    g = e * tile + hb * hn + jj
    gp = e * tile + ((half - lo) + (rp - r_sub + half) % half) * 128 \
        + (lane - r_lane + 128) % 128
    return g, gp


@pytest.mark.parametrize("tile", [256, 1024, 4096])
def test_ensemble_columns_are_the_halves(tile):
    """Thread j's walkers are ensemble_halves' j-th of each half (the
    twin's order), and the kernel's partner is the one ensemble_plain forms
    from (ensemble, row, lane): a roll of the other half of the same
    ensemble."""
    W, seed, half, hn = 2 * tile, 12345, tile // 256, tile // 2
    j = torch.arange(W // 2)
    halves = T.ensemble_halves(W, tile, "cpu")
    scal = T.mix((seed * 0x7FEB352D + torch.arange(W // tile) * tile + 0xE75)
                 & _M32)
    for it in (1, 2, 999):
        for hb, (idx, e, r, lane) in enumerate(halves):
            g, gp = _kernel_columns(j, tile, seed, it, hb)
            assert torch.equal(g, idx)
            sbits = T.mix(scal ^ T.mix(torch.tensor(it * 2 + hb)))
            r_sub, r_lane = (sbits % half)[e], ((sbits >> 8) % 128)[e]
            comp = half - (half if hb else 0)
            assert torch.equal(gp, e * tile + (comp + (r - r_sub) % half) * 128
                               + (lane - r_lane) % 128)
            assert torch.equal(gp // tile, e)
            assert ((gp % tile) // hn == 1 - hb).all()
            assert torch.unique(gp).numel() == W // 2


# (W0, tile, walk mask, threads): the grid's columns (three threads
# each); 96 over 256 columns (passes of 96, 96, 64); 700 walkers padded to
# three ensembles, 40 over 384 columns, a static slot
@pytest.mark.parametrize("W0,tile,mask,threads", [
    (512, 256, (1.0, 1.0, 1.0), 256), (512, 256, (1.0, 1.0, 1.0), 96),
    (700, 256, (1.0, 0.0, 1.0), 40)])
def test_ensemble_column_loop_equals_twin(monkeypatch, W0, tile, mask,
                                          threads):
    """The kernel's schedule (tests/test_torch_ensemble_spec.py: B's update
    beside A's two candidates a round, the state in two parity buffers,
    columns in passes where threads are fewer, a grid barrier a round)
    gives ensemble_plain's records bitwise."""
    from test_torch_ensemble_spec import speculative_ensemble
    from test_torch_pt import _fake_scorer
    monkeypatch.setattr(T, "make_scorer", _fake_scorer)
    seed = 9
    th0 = torch.as_tensor(np.ascontiguousarray(T.ensemble_init(
        _theta0(W0), seed, tile, mask, 0.01).T))
    kw = dict(tile=tile, nits=9, burnin=2, a=2.0, walk=mask,
              walked=tuple(w != 0.0 for w in mask), num=3, W0=W0)
    want = T.ensemble_plain(None, None, None, th0, seed, **kw)
    got = speculative_ensemble(None, None, None, th0, seed, columns=threads,
                               **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert 0 < float(got[4][-1].mean()) < 1


def test_default_tile_is_the_jax_rule():
    for C in (1, 255, 256, 1000, 2048, 3000, 5000, 10000, 12289):
        assert T.pick_tile_chains(C) == J.pick_tile_chains(C), C
    assert T.pick_tile_chains(10000) == 4096


def _inits(n, seed=11):
    rng = np.random.default_rng(seed)
    base = np.array([0.62, 2.3e-8, 25.0])
    draws = base * np.exp(rng.normal(0, 0.05, (n, 3)))
    return [dict(zip(("mu", "phi", "beta"), map(float, d))) for d in draws]


def test_mcmc_ensemble_slice_matches_odelib_tpu(capsys):
    inits = _inits(256)
    kw = dict(chain_inits=inits, iterations_per_chain=_NITS, burnin=_BURNIN,
              sampler="ensemble", backend="pallas", pallas_tile_chains=256,
              print_report=True)
    ref_fw = _framework(odelib_tpu)
    ref = ref_fw.MCMC(pallas_interpret=True, **kw)
    ref_report = capsys.readouterr().out
    fw = _framework(odelib_tpu_torch, device="cpu")
    got = fw.MCMC(**kw)
    report = capsys.readouterr().out
    assert list(got.columns) == list(ref.columns)
    assert len(got) == len(ref) == 256 * (_NITS - 1 - _BURNIN)
    pd.testing.assert_index_equal(got.index, ref.index)
    for col in ref.columns:
        assert got[col].dtype == ref[col].dtype, col
    for col in ("iteration", "chain#", "all_rejected", "acceptance_ratio"):
        np.testing.assert_array_equal(got[col].to_numpy(),
                                      ref[col].to_numpy())
    # the grown ulps, as in the kernel-level test: measured max theta
    # 7.7e-6, chi 4.9e-5, aic 4.7e-5, R^2 3.9e-4 (R^2 near 0.2 here, so a
    # small absolute change of the abundance residuals is a large relative
    # one)
    for col, tol in (("mu", 2e-5), ("phi", 2e-5), ("beta", 2e-5),
                     ("chi", 1e-4), ("aic", 1e-4), ("rsquared", 1e-3)):
        np.testing.assert_allclose(got[col].to_numpy(), ref[col].to_numpy(),
                                   rtol=tol, err_msg=col)
    a, b = _report_numbers(report), _report_numbers(ref_report)
    assert a.size == b.size == 9
    np.testing.assert_allclose(a, b, rtol=1e-3)

