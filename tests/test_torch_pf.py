"""Particle-marginal MH: the port's ``pmmh_fused`` (torch twin on the CPU)
against ``odelib_tpu``'s Pallas kernel in interpret mode, record by record
(the GBM state-space model of tests/test_pallas_pf.py, one state, and a
two-state SDE, with and without a prior and adaptation); the counter-RNG
words of the filter; the weights' summation order; the resampling edge;
and ``MCMC(sampler='pmmh')`` end to end. Kernel-versus-twin on the card is
in tests/test_torch_cuda.py and chip_smoke.py's PMMH phases."""
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.stats
import torch

import odelib_tpu
import odelib_tpu_torch
from odelib_tpu import distributions as JD
from odelib_tpu.model import ObsData, make_spec
from odelib_tpu.ops.pallas_pf import _RngS
from odelib_tpu.ops.pallas_pf import pmmh_fused as jax_pmmh_fused
from odelib_tpu_torch import distributions as TD
from odelib_tpu_torch import dispatch as t_dispatch
from odelib_tpu_torch.model import make_spec as t_make_spec
from odelib_tpu_torch.model import obsdata_from_arrays
from odelib_tpu_torch.ops import cuda_pf as TP
from odelib_tpu_torch.rhs import adapt_rhs

MU, SIG, S_OBS = 0.4, 0.3, 0.15


def _gbm(t, y, ps):
    return jnp.stack([ps[0] * y[0]])


def _gbm_noise(t, y, ps):
    return jnp.stack([SIG * y[0]])


def _pair(t, y, ps):
    mu, b0 = ps
    return jnp.stack([mu * y[0], (mu - 0.2) * y[1]])


def _pair_noise(t, y, ps):
    return jnp.stack([SIG * y[0], 0.2 * y[1]])


def _gbm_obs():
    """tests/test_pallas_pf.py's data: 8 observations of log N at t = 0.5,
    ..., 4.0 (numpy seed 42)."""
    rng = np.random.default_rng(42)
    t_obs = np.arange(1, 9) * 0.5
    z, zs = np.log(2.0), []
    for dt in np.diff(np.concatenate([[0.0], t_obs])):
        z = z + (MU - 0.5 * SIG ** 2) * dt + SIG * np.sqrt(dt) * rng.normal()
        zs.append(z)
    return t_obs, np.array(zs) + S_OBS * rng.normal(size=len(zs))


def _case(name):
    """(JAX spec, port spec, host obs, grid, y0, theta0 (128, P)): the GBM
    (one state, so noise pairs straddle steps) or a two-state SDE with an
    initial-state parameter B0 and observations of both states, one at
    t = 0 (a resampling block before the first step)."""
    times = np.linspace(0, 4.0, 41)
    rng = np.random.default_rng(1)
    if name == "gbm":
        t_obs, log_o = _gbm_obs()
        obs = ObsData(log_abundance=log_o, log_sigma=np.full(8, S_OBS),
                      abundance=np.exp(log_o),
                      t_index=np.round(t_obs / 0.1).astype(np.int64),
                      state_index=np.zeros(8, np.int64),
                      sstot=float(np.var(np.exp(log_o)) * 8))
        fns, pn, sn, y0 = (_gbm, _gbm_noise), ("mu",), ("N",), [2.0]
        th0 = np.exp(rng.normal(np.log(MU), 0.3, (128, 1)))
    else:
        t_idx = np.array([0, 10, 20, 30, 5, 15, 25, 40])
        log_o = np.log(np.r_[2.0, 2.9, 4.4, 6.5, 1.2, 1.5, 1.7, 2.6]) \
            + 0.1 * np.random.default_rng(3).normal(size=8)
        obs = ObsData(log_abundance=log_o, log_sigma=np.full(8, 0.2),
                      abundance=np.exp(log_o), t_index=t_idx,
                      state_index=np.r_[np.zeros(4), np.ones(4)]
                      .astype(np.int64),
                      sstot=float(np.var(np.exp(log_o)) * 8))
        fns, pn, sn, y0 = (_pair, _pair_noise), ("mu", "B0"), ("A", "B"), \
            [2.0, 1.0]
        th0 = np.c_[np.exp(rng.normal(np.log(MU), 0.3, 128)),
                    np.exp(rng.normal(0.0, 0.1, 128))]
    spec = make_spec(fns[0], pn, sn, diffusion=fns[1])
    tspec = t_make_spec(adapt_rhs(fns[0]), pn, sn,
                        diffusion=adapt_rhs(fns[1]))
    return spec, tspec, obs, times, np.asarray(y0), th0.astype(np.float32)


def test_filter_rng_words_match_jax():
    """The per-particle and per-chain words of _RngS, bitwise, over two
    128-chain tiles: keys on the plane's lane ids, counter it * stride +
    slot; the normal pair's halves to Box-Muller's few ulps (the math
    libraries' log/cos/sin)."""
    K, stride, it, seed = 8, 64, 5, 3
    chains = torch.arange(256)
    key0, keys = TP.pf_keys(seed, K, chains)
    for pid in (0, 1):
        rng = _RngS((K, 128), jnp.asarray(seed, jnp.int32),
                    jnp.asarray(pid, jnp.int32), K * 128, stride)
        itj = jnp.asarray(it, jnp.int32)
        u0 = np.asarray(rng.uniform(itj))
        a, b = (np.asarray(v) for v in rng.normal_pair(itj))
        u3 = np.asarray(rng.uniform(itj))
        sl = slice(128 * pid, 128 * (pid + 1))
        ctr = it * stride
        np.testing.assert_array_equal(
            TP.uniform_of(keys, ctr)[:, sl].numpy(), u0)
        np.testing.assert_array_equal(
            TP.uniform_of(keys, ctr + 3)[:, sl].numpy(), u3)
        np.testing.assert_array_equal(     # particle 0's row: per chain
            TP.uniform_of(key0, ctr)[sl].numpy(), u0[0])
        ta, tb = TP.rng_normal_pair(keys, ctr + 1)
        np.testing.assert_allclose(ta[:, sl].numpy(), a, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(tb[:, sl].numpy(), b, rtol=1e-6,
                                   atol=1e-6)


# K = 128 is the main path's particle count: four warps in the kernel, the
# grouped weight sum and a seven-level prefix-sum ladder
_CASES = [("gbm", 8, False), ("gbm", 16, True), ("pair", 8, True),
          ("pair", 16, False), ("gbm", 128, True)]


@pytest.mark.parametrize("name,K,prior", _CASES,
                         ids=[f"{n}-K{k}-{'prior' if p else 'flat'}"
                              for n, k, p in _CASES])
def test_pmmh_twin_matches_pallas_interpret(name, K, prior):
    """128 chains (one JAX tile), 40 Euler steps, 6 proposals. The weights
    are summed in XLA:CPU's order (test_weight_sum_order), so the gap is
    the math libraries' ulps (log, exp, cos, sin, sqrt) carried through
    the filter: chi within 5e-6 relative, accept sequences equal."""
    spec, tspec, obs, times, y0, th0 = _case(name)
    pri = None
    if prior:
        pri = (JD.LogNormal(s=0.5, loc=0.0, scale=MU),) + (
            (JD.Normal(loc=1.0, scale=0.2),) if name == "pair" else ())
    tpri = None if pri is None else tuple(
        TD.LogNormal(s=d.s, loc=d.loc, scale=d.scale)
        if isinstance(d, JD.LogNormal) else TD.Normal(d.loc, d.scale)
        for d in pri)
    kw = dict(nits=7, burnin=3, rwalk_std=0.3, n_particles=K, substeps=1,
              adapt_proposal=prior, adapt_rate=0.15, target_accept=0.3)
    ref = jax_pmmh_fused(spec, obs, times, y0.astype(np.float32), th0,
                         seed=3, priors=pri, interpret=True, **kw)
    got = TP.pmmh_fused(tspec, obsdata_from_arrays(obs), times, y0,
                        torch.as_tensor(th0), 3, priors=tpri, **kw)
    assert got.theta.shape == (128, 3, th0.shape[1])
    np.testing.assert_array_equal(got.iteration.numpy(),
                                  np.asarray(ref.iteration))
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    assert 0 < float(got.acceptance_ratio[:, -1].mean()) < 1
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               rtol=1e-6)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(ref.chi),
                               rtol=5e-6)
    np.testing.assert_allclose(got.aic.numpy(), np.asarray(ref.aic),
                               rtol=5e-6)


@pytest.mark.parametrize("K", [8, 16, 64, 128])
def test_weight_sum_order(K):
    """group_sum is XLA:CPU's jnp.sum over the particle axis, bitwise, for
    K <= 32 and K a multiple of 32 (wide-ranging weights, zeros mixed
    in)."""
    rng = np.random.default_rng(K)
    w = (np.exp(rng.normal(0, 6, (K, 128)))
         * (rng.random((K, 128)) > 0.3)).astype(np.float32)
    ref = np.asarray(jnp.sum(jnp.asarray(w), axis=0, keepdims=True))[0]
    np.testing.assert_array_equal(TP.group_sum(torch.as_tensor(w)).numpy(),
                                  ref)


def _shfl_up(x, q):
    """__shfl_up_sync over the 32 lanes (axis 0): lane l reads lane l - q,
    lanes below q keep their own value."""
    return np.concatenate([x[:q], x[:-q]])


def _lanes(w, ppt):
    """Particles k < K of ``w`` (K, C) on lane k // ppt, slot k % ppt:
    (32, ppt, C) float32, zeros past K."""
    out = np.zeros((32 * ppt,) + w.shape[1:], np.float32)
    out[:w.shape[0]] = w
    return out.reshape((32, ppt) + w.shape[1:])


def _lane_group_sum(w, ppt):
    """pf.cu resample_block's sum of the weights, lane by lane: lane g
    adds group g's 32 weights (particles 32 g + j) in particle order, one
    shuffle each; then every lane adds the group sums in order."""
    K = w.shape[0]
    lanes, G, lpg = _lanes(w, ppt), (K + 31) // 32, 32 // ppt
    part = np.zeros((32,) + w.shape[1:], np.float32)
    for j in range(32):
        for lane in range(32):
            g = lane if lane < G else 0
            v = lanes[g * lpg + j // ppt, j % ppt]
            if 32 * g + j < K:
                part[lane] = part[lane] + v
    total = np.zeros(w.shape[1:], np.float32)
    for q in range(G):
        total = total + part[q]
    return total


def _lane_scan(w, ppt):
    """pf.cu resample_block's prefix sum, lane by lane: a level d < ppt
    adds in-lane values and, for the lane's first d slots, the previous
    lane's last ones (a shuffle up by 1); a level d >= ppt adds the same
    slot of the lane d / ppt below (a shuffle up by d / ppt)."""
    K = w.shape[0]
    c = _lanes(w, ppt)
    lane = np.arange(32).reshape((32,) + (1,) * (w.ndim - 1))
    zero = np.float32(0.0)
    d = 1
    while d < ppt:
        n = np.empty_like(c)
        for i in range(ppt):
            if i >= d:
                n[:, i] = c[:, i] + c[:, i - d]
            else:
                v = _shfl_up(c[:, i - d + ppt], 1)
                n[:, i] = c[:, i] + np.where(lane > 0, v, zero)
        c, d = n, 2 * d
    while d < K:
        q = d // ppt
        for i in range(ppt):
            v = _shfl_up(c[:, i], q)
            c[:, i] = c[:, i] + np.where(lane >= q, v, zero)
        d *= 2
    return c.reshape((32 * ppt,) + w.shape[1:])[:K]


# every (particles per lane, K) the lanes hold; the kernel's own choice is
# the least power of two with 32 ppt >= K (1, 1, 2, 4, 8 and 16 here)
_LANE_CASES = [(ppt, K) for ppt in (1, 2, 4, 8, 16)
               for K in (8, 24, 40, 128, 200, 512) if K <= 32 * ppt]


def _weights(K):
    rng = np.random.default_rng(K)
    return (np.exp(rng.normal(0, 6, (K, 64)))
            * (rng.random((K, 64)) > 0.3)).astype(np.float32)


@pytest.mark.parametrize("ppt,K", _LANE_CASES,
                         ids=[f"ppt{p}-K{k}" for p, k in _LANE_CASES])
def test_lane_blocked_scan_is_the_ladder(ppt, K):
    """The warp's lane-blocked Hillis-Steele scan associates as the ladder
    of systematic_resample (hillis_steele), bitwise."""
    w = _weights(K)
    np.testing.assert_array_equal(
        _lane_scan(w, ppt), TP.hillis_steele(torch.as_tensor(w)).numpy())


@pytest.mark.parametrize("ppt,K", _LANE_CASES,
                         ids=[f"ppt{p}-K{k}" for p, k in _LANE_CASES])
def test_lane_blocked_group_sum_is_group_sum(ppt, K):
    """The warp's lane-blocked sum of the weights is group_sum, bitwise."""
    w = _weights(K)
    np.testing.assert_array_equal(_lane_group_sum(w, ppt),
                                  TP.group_sum(torch.as_tensor(w)).numpy())


def test_resample_edge_gives_zero_states():
    """Equal weights and a uniform just below 1: pos of the last slot,
    7 + u, rounds to the total 8, matches no particle and takes all-zero
    states, as the JAX kernel's masked sum gives; every other slot copies
    its particle."""
    K = 8
    w = torch.ones((K, 2))
    u = torch.tensor([1.0 - 2.0 ** -24, 0.5])
    y = torch.arange(1.0, K + 1.0)[:, None].expand(K, 2)
    new, = TP.systematic_resample(w, u, [y])
    f32 = np.float32
    pos = (np.arange(K, dtype=f32) + f32(u[0])) * f32(1 / K) * f32(K)
    j = np.searchsorted(np.arange(1.0, K + 1), pos, side="right")
    expect = np.where(j < K, j + 1.0, 0.0)
    assert expect[-1] == 0.0 and pos[-1] == K
    np.testing.assert_array_equal(new[:, 0].numpy(), expect)
    np.testing.assert_array_equal(new[:, 1].numpy(), np.arange(1.0, K + 1))


def _masked_sum(w, u, y):
    """The JAX kernel's selection in numpy float32: the Hillis-Steele
    ladder, pos, and slot i summing the particles j with cum[j-1] <= pos_i
    < cum[j]; also the number of particles each slot takes."""
    K = w.shape[0]
    cum, d = w, 1
    while d < K:
        cum = cum + np.concatenate([np.zeros_like(cum[:d]), cum[:-d]])
        d *= 2
    pos = ((np.arange(K, dtype=np.float32)[:, None] + u)
           * np.float32(1 / K)) * cum[-1]
    out, n_sel = np.zeros_like(y), np.zeros(y.shape, np.int64)
    for j in range(K):
        sel = (pos >= (cum[j - 1] if j else np.float32(0))) & (pos < cum[j])
        out = out + np.where(sel, y[j], np.float32(0))
        n_sel += sel
    return out, n_sel, cum


def test_resample_dip_takes_the_masked_sum():
    """Chain 0's weights make the ladder dip by rounding (cum[3] > cum[4]),
    so two selection intervals overlap and slot 5 takes the sum of two
    particles, as the JAX kernel's masked sum gives: there the twin (as the
    kernel) leaves the search for the masked sum. Chain 1, equal weights,
    takes the search: slot i copies particle i."""
    e, h = 2.0 ** -24, 2.0 ** -25
    w = np.array([[e, h, 0.5, 0.25, 0.0, 0.25, h, e], [1.0] * 8],
                 np.float32).T
    u = np.array([0.9999988675117493, 0.5], np.float32)
    y = (np.arange(1.0, 9.0)[:, None] * np.array([1.0, -1.0])) \
        .astype(np.float32)
    expect, n_sel, cum = _masked_sum(w, u, y)
    assert cum[3, 0] > cum[4, 0] and n_sel[5, 0] == 2
    assert (np.diff(cum[:, 1]) >= 0).all()
    new, = TP.systematic_resample(torch.as_tensor(w), torch.as_tensor(u),
                                  [torch.as_tensor(y)])
    np.testing.assert_array_equal(new.numpy(), expect)
    np.testing.assert_array_equal(new[:, 1].numpy(), -np.arange(1.0, 9.0))


def _gbm_framework(pkg, noise=True, **kw):
    t_obs, log_o = _gbm_obs()
    df = pd.DataFrame({"organism": "N", "time": t_obs,
                       "abundance": np.exp(log_o), "log_sigma": S_OBS})

    def gbm(y, t, ps):
        return np.array([ps[0] * y[0]])

    def gnoise(y, t, ps):
        return np.array([0.3 * y[0]])

    return pkg.ModelFramework(
        ODE=gbm, diffusion=gnoise if noise else None, parameter_names=["mu"],
        state_names=["N"], dataframe=df, t_steps=41, N=2.0,
        mu=pkg.parameter(scipy.stats.lognorm, {"s": 0.5, "scale": 0.4},
                         random_seed=1),
        **kw)


def test_mcmc_pmmh_matches_odelib_tpu(monkeypatch):
    """MCMC(sampler='pmmh') end to end against odelib_tpu's fused backend
    in interpret mode, both seeded from the port's LHS draws (the JAX
    package draws its own with jax.random)."""
    fw = _gbm_framework(odelib_tpu_torch, device="cpu")
    ref_fw = _gbm_framework(odelib_tpu)
    draws = fw._lhs_samples(32)
    monkeypatch.setattr(ref_fw, "_lhs_samples", lambda samples: draws)
    kw = dict(chain_inits=4, iterations_per_chain=9, burnin=3,
              fitsurvey_samples=32, sampler="pmmh", n_particles=8,
              sde_substeps=5, rwalk_std=0.3, use_priors=True,
              adapt_rate=0.15, print_report=False)
    seen = {}

    def capture(fw_, theta0, cfg):
        seen["theta0"], seen["cfg"] = np.asarray(theta0), cfg
        return t_dispatch.run_pmmh(fw_, theta0, cfg)
    monkeypatch.setitem(t_dispatch._ARMS, "cpu:pmmh", capture)
    got = fw.MCMC(**kw)
    ref = ref_fw.MCMC(backend="pallas", pallas_interpret=True, **kw)
    assert np.asarray(fw._times_fit).tolist() == [0.5 * i for i in range(9)]
    assert seen["cfg"].adapt_proposal and seen["cfg"].target_accept == 0.3
    assert list(got.columns) == list(ref.columns)
    assert len(got) == len(ref) == 4 * 5
    for col in ref.columns:
        assert got[col].dtype == ref[col].dtype, col
    assert got["rsquared"].isna().all() and ref["rsquared"].isna().all()
    for col in ("iteration", "chain#", "all_rejected", "acceptance_ratio"):
        np.testing.assert_array_equal(got[col].to_numpy(),
                                      ref[col].to_numpy())
    np.testing.assert_allclose(got["mu"], ref["mu"], rtol=1e-6)
    np.testing.assert_allclose(got["chi"], ref["chi"], rtol=5e-6)
    np.testing.assert_allclose(got["aic"], ref["aic"], rtol=5e-6)
    assert np.isfinite(got["chi"]).all()


def test_fit_survey_scores_the_drift():
    """fit_survey: the adaptive drift solve of every LHS draw in float64
    (the PMMH seeding survey) against odelib_tpu's on the same draws."""
    fw = _gbm_framework(odelib_tpu_torch, device="cpu")
    ref_fw = _gbm_framework(odelib_tpu)
    draws = fw._lhs_samples(24)
    ref_fw._lhs_samples = lambda samples: draws
    got, ref = fw.fit_survey(24), ref_fw.fit_survey(24)
    assert list(got.columns) == list(ref.columns) == ["mu", "chi"]
    np.testing.assert_allclose(got["chi"], ref["chi"], rtol=1e-9)


def test_pmmh_options_raise(caplog):
    """The options PMMH refuses raise; backend='xla' and the particle
    counts the kernel does not take (100, 1,024) run the XLA particle
    filter, as the reference routes them (the logged arm), and 'pallas'
    at 100 particles raises the reference's ValueError."""
    import logging
    fw = _gbm_framework(odelib_tpu_torch, device="cpu")
    kw = dict(chain_inits=[{"mu": 0.4}], iterations_per_chain=6,
              print_report=False)
    for extra in (dict(backend="xla"), dict(n_particles=100),
                  dict(n_particles=1024)):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="odelib_tpu_torch"):
            post = fw.MCMC(sampler="pmmh", **kw, **extra)
        assert "the XLA particle filter" in caplog.text, extra
        assert "pf_kernel" not in caplog.text
        assert len(post) == 2 and np.isfinite(post["chi"]).all()
    with pytest.raises(ValueError, match="not available here: fused PMMH "
                       "needs euler or milstein, n_particles a multiple"):
        fw.MCMC(sampler="pmmh", n_particles=100, backend="pallas", **kw)
    # Milstein runs (tests/test_torch_milstein.py holds it to the JAX
    # kernel): the reference's columns, finite chi
    post = fw.MCMC(sampler="pmmh", sde_method="milstein", n_particles=8,
                   sde_substeps=2, **kw)
    assert list(post.columns) == ["mu", "chi", "rsquared", "aic",
                                  "iteration", "acceptance_ratio", "chain#",
                                  "all_rejected"]
    assert np.isfinite(post["chi"]).all()
    for extra, exc, match in (
            (dict(sampler="pmmh", checkpoint_every=3), ValueError,
             "requires checkpoint_path"),
            (dict(sampler="pmmh", sde_method="srk"), ValueError,
             "Euler-Maruyama")):
        with pytest.raises(exc, match=match):
            fw.MCMC(**kw, **extra)
    ode = _gbm_framework(odelib_tpu_torch, device="cpu")
    ode._spec = t_make_spec(ode._spec.rhs, ("mu",), ("N",))
    with pytest.raises(ValueError, match="diffusion"):
        ode.MCMC(sampler="pmmh", **kw)
    assert TP.pmmh_supported(fw._spec, 128, "euler")
    assert not TP.pmmh_supported(fw._spec, 100, "euler")
    assert not TP.pmmh_supported(fw._spec, 520, "euler")
    assert TP.pmmh_supported(fw._spec, 128, "milstein")
    assert not TP.pmmh_supported(fw._spec, 128, "srk")
    assert not TP.pmmh_supported(ode._spec, 128, "euler")


@pytest.mark.parametrize("sampler", ["mh", "pt"])
def test_drift_sampler_on_a_diffusion_model_warns(sampler):
    """A sampler other than 'pmmh' on a model with diffusion= warns and
    fits the drift, as odelib_tpu does: the same posterior, bitwise, as
    the model built without diffusion=, from the same seed."""
    kw = dict(chain_inits=4, iterations_per_chain=8, fitsurvey_samples=32,
              sampler=sampler, print_report=False)
    with pytest.warns(UserWarning, match="DRIFT ONLY"):
        got = _gbm_framework(odelib_tpu_torch, device="cpu").MCMC(**kw)
    want = _gbm_framework(odelib_tpu_torch, noise=False,
                          device="cpu").MCMC(**kw)
    pd.testing.assert_frame_equal(got, want)
    assert np.isfinite(got["chi"]).all()
    with pytest.warns(UserWarning, match="DRIFT ONLY"):
        _gbm_framework(odelib_tpu).MCMC(**kw)
