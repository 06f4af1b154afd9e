"""Joint fitting: the port's ``joint_metropolis_hastings_fused`` (torch
twin on the CPU) against ``odelib_tpu``'s Pallas kernel in interpret mode,
record by record, on a pair of one model and on a pair of different models;
``joint_survey`` and ``JointFit.fit_survey`` against the JAX package's in
float64; and ``JointFit.MCMC`` end to end. Kernel-versus-twin on the card is
in tests/test_torch_cuda.py and chip_smoke.py's joint phases."""
import re

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import odelib_tpu
import odelib_tpu.samplers as jax_samplers
import odelib_tpu_torch
from odelib_tpu import JointFit as JJointFit
from odelib_tpu.distributions import LogNormal as JLogNormal
from odelib_tpu.ops.pallas_joint import \
    joint_metropolis_hastings_fused as jax_joint_fused
from odelib_tpu.samplers.joint import joint_survey as jax_joint_survey
from odelib_tpu_torch import JointFit
from odelib_tpu_torch import distributions as D
from odelib_tpu_torch.distributions import LogNormal
from odelib_tpu_torch.ops import cuda_joint as TJ
from odelib_tpu_torch.ops import cuda_mh as T
from odelib_tpu_torch.ops import cuda_pf as TF
from odelib_tpu_torch.ops.priors import logprior_plain, prior_table
from odelib_tpu_torch.samplers import joint_survey

from helpers import synthetic_df, zero_i
from test_torch_priors import jax_priors

_PRI = dict(mu=((3.0, 1e-8)), phi=(3.0, 1e-8), beta=(1.0, 25.0))


def _zero_i_pair(pkg, dist, **kw):
    """zero_i on synthetic data (a; every other time point, so an 8-point
    grid) and on the same frame with perturbed log abundances and initial
    abundances x 1.13 (b)."""
    df_a = synthetic_df()
    df_a = df_a[np.isclose(np.mod(np.round(df_a["time"] / 0.2), 2), 0)]
    df_b = df_a.copy()
    df_b["abundance"] = df_b["abundance"] * np.exp(
        np.random.default_rng(7).normal(0, 0.1, len(df_b)))
    y0 = {s: float(df_a[(df_a.organism == s) & (df_a.time == 0)]
                   .abundance.iloc[0]) for s in ("S", "V")}
    fws = {}
    for nm, df, scale in (("a", df_a, 1.0), ("b", df_b, 1.13)):
        fws[nm] = pkg.ModelFramework(
            ODE=zero_i, parameter_names=["mu", "phi", "beta"],
            state_names=["S", "V"], dataframe=df, t_steps=32,
            ode_style="jax", random_seed=0,
            **{p: pkg.parameter(stats_gen=dist(s=s, scale=sc),
                                hyperparameters={}, random_seed=i)
               for i, (p, (s, sc)) in enumerate(_PRI.items())},
            **{s: v * scale for s, v in y0.items()}, **kw)
    return fws


def _decay(t, y, ps):
    (k,) = ps
    return jnp.stack([-k * y[0]])


def _logistic(t, y, ps):
    k, cap = ps
    return jnp.stack([k * y[0] * (1.0 - y[0] / cap)])


def _hetero_pair(pkg, dist, **kw):
    """tests/test_joint.py's heterogeneous pair: decay (a) and logistic
    growth (b), different grids and observation counts, sharing k."""
    rng = np.random.default_rng(20)
    t_a = np.linspace(0.0, 3.0, 12)
    df_a = pd.DataFrame([{"organism": "y", "time": t,
                          "abundance": 1e6 * np.exp(-t + rng.normal(0, 0.15)),
                          "log_sigma": 0.15} for t in t_a])
    rng = np.random.default_rng(21)
    t_b = np.linspace(0.0, 4.0, 7)
    yb = 1e6 / (1 + (1e6 / 1e4 - 1) * np.exp(-t_b))
    df_b = pd.DataFrame([{"organism": "y", "time": t,
                          "abundance": v * np.exp(rng.normal(0, 0.1)),
                          "log_sigma": 0.1} for t, v in zip(t_b, yb)])
    k = lambda: pkg.parameter(stats_gen=dist(s=0.7, scale=1.0),  # noqa: E731
                              hyperparameters={}, random_seed=0)
    return {"a": pkg.ModelFramework(
                ODE=_decay, parameter_names=["k"], state_names=["y"],
                dataframe=df_a, t_steps=32, ode_style="jax", k=k(), **kw),
            "b": pkg.ModelFramework(
                ODE=_logistic, parameter_names=["k", "cap"],
                state_names=["y"], dataframe=df_b, t_steps=24,
                ode_style="jax", k=k(), cap=pkg.parameter(init_value=1e6),
                **kw)}


_PAIRS = {"zero_i-pair": (_zero_i_pair, ["phi", "beta"]),
          "heterogeneous": (_hetero_pair, ["k"])}
# where the parity chains start: near the fit, in joint column order
_CENTRES = {"zero_i-pair": [2.4e-8, 24.0, 0.6, 0.6],
            "heterogeneous": [1.0, 1e6]}


def _fits(name):
    make, shared = _PAIRS[name]
    ref = JJointFit(make(odelib_tpu, JLogNormal), shared=shared,
                    random_seed=3)
    got = JointFit(make(odelib_tpu_torch, LogNormal, device="cpu"),
                   shared=shared, random_seed=3)
    return ref, got


def _host_args(jf):
    fws = list(jf.frameworks.values())
    return ([fw._spec for fw in fws],
            [jf._idx_maps[nm] for nm in jf.frameworks],
            [fw._obsdata_fit_host for fw in fws],
            [np.asarray(fw._times_fit) for fw in fws],
            [np.asarray(fw.get_inits()) for fw in fws])


@pytest.mark.parametrize("name", sorted(_PAIRS))
def test_joint_twin_matches_pallas_interpret(name):
    ref_jf, jf = _fits(name)
    assert jf.columns == ref_jf.columns and jf._idx_maps == ref_jf._idx_maps
    rng = np.random.default_rng(5)
    th0 = (np.array(_CENTRES[name])
           * np.exp(rng.normal(0, 0.05, (128, jf.dim)))).astype(np.float32)
    mask = jf._walk_mask(["b:cap"] if name == "heterogeneous" else ())
    kw = dict(nits=13, burnin=2, walk_mask=mask, rwalk_std=0.05,
              substeps_list=[1, 1])
    ref = jax_joint_fused(*_host_args(ref_jf), th0, seed=4,
                          tile_chains=128, interpret=True, **kw)
    got = TJ.joint_metropolis_hastings_fused(*_host_args(jf),
                                             torch.as_tensor(th0), 4, **kw)
    assert got.theta.shape == (128, 10, jf.dim)
    assert got.chi_parts.shape == (128, 10, 2)
    np.testing.assert_array_equal(got.iteration.numpy(),
                                  np.asarray(ref.iteration))
    # the accept sequences: the running ratio is an exact function of them
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    assert 0 < float(got.acceptance_ratio[:, -1].mean()) < 1
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               rtol=1e-5)
    # chi and its parts: the MH parity tolerance 5e-5 where both packages'
    # theta agree bitwise (the interpret-mode reference's XLA:CPU arithmetic
    # moves chi by a few 1e-5 near the fit, tests/test_torch_survey.py).
    # Where accepted walks have left theta ulps apart (Box-Muller's and
    # exp's math libraries, as in the ensemble), chi is the score of a
    # slightly different theta: zero_i's exponential growth makes that up
    # to 1e-4.
    same = (got.theta.numpy() == np.asarray(ref.theta)).all(-1)
    assert same.mean() > 0.4
    parts, ref_parts = got.chi_parts.numpy(), np.asarray(ref.chi_parts)
    np.testing.assert_allclose(got.chi.numpy()[same],
                               np.asarray(ref.chi)[same], rtol=5e-5)
    np.testing.assert_allclose(parts[same], ref_parts[same], rtol=5e-5)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(ref.chi),
                               rtol=1e-4)
    np.testing.assert_allclose(parts, ref_parts, rtol=1e-4)
    # the total is the parts added in experiment order, in float32
    np.testing.assert_array_equal(got.chi.numpy(),
                                  parts[..., 0] + parts[..., 1])
    if name == "heterogeneous":     # the static slot never moves
        fixed = got.theta[:, :, 1].numpy()
        assert (fixed == fixed[:, :1]).all()
        np.testing.assert_allclose(fixed[:, 0], th0[:, 1], rtol=1e-6)


def _joint_warps(specs, plans, y0s, idx_maps, theta0, seed, *, nits, burnin,
                 walk, walked, prior=None, warps=None):
    """joint.cu's layout: blocks of 32 chains (lanes) and W = ``warps``
    warps (K by default; min(K, 8) for joint_kernel's WIDE
    instantiations); lanes past the last chain run chain C - 1's copy and store nothing.
    Warp w draws the proposal's dimensions d = w, w + W, ... from their
    closed-form slots (two per walked dimension before d), scores
    experiments k = w, w + W, ... on exp(prop[idx_k]) and puts their parts
    in the shared buffer; then every warp sums the parts in k order from
    part 0, draws the accept uniform after the walked dimensions' slots
    and decides for itself. Warp w keeps its experiments' parts (in
    shared memory beside the proposal's) and its dimensions and writes
    their records, and chi's and the ratio's where D and D + 1 fall mod
    W. With a ``prior`` every warp evaluates the log prior of the whole
    proposal itself and adds it once."""
    scorers = [T.make_scorer(sp, pl, y0, "dopri5")
               for sp, pl, y0 in zip(specs, plans, y0s)]
    D, C = theta0.shape
    K = len(specs)
    W = K if warps is None else warps
    c_own = torch.arange(-(-C // 32) * 32)
    live = c_own < C
    th0 = theta0[:, c_own.clamp(max=C - 1)]
    key = T.Rng(seed, c_own.clamp(max=C - 1))._key
    slot, n_walked = [], 0
    for w in walked:
        slot.append(2 * n_walked if w else -1)
        n_walked += w
    f32 = lambda v: torch.tensor(np.float32(v))  # noqa: E731

    def total(part):
        out = part[0]
        for p in part[1:]:
            out = out + p
        return out
    part = [score([th0[i] for i in idx])[0]
            for score, idx in zip(scorers, idx_maps)]
    part_k = list(part)
    lt = [torch.log(th) for th in th0]
    chi, acc = [total(part)] * W, [torch.zeros(len(c_own))] * W
    lp = [None if prior is None else logprior_plain(prior, list(th0))] * W
    R = nits - 1 - burnin
    recs = (torch.full((R, D, C), np.nan), torch.full((R, C), np.nan),
            torch.full((R, K, C), np.nan), torch.full((R, C), np.nan))
    for it in range(1, nits):
        base, prop = it * 1024, [None] * D
        for w in range(W):
            for d in range(w, D, W):
                prop[d] = lt[d] + f32(walk[d]) * TF.rng_normal(
                    key, base + slot[d]) if slot[d] >= 0 else lt[d]
        part = [score([torch.exp(prop[i]) for i in idx])[0]
                for score, idx in zip(scorers, idx_maps)]
        oks = []
        for w in range(W):
            chi_new = total(part)
            log_ratio = chi[w] - chi_new
            if prior is not None:
                lp_new = logprior_plain(prior, [torch.exp(v) for v in prop])
                log_ratio = log_ratio + (lp_new - lp[w])
            ok = torch.exp(log_ratio) > T.uniform_of(key, base + 2 * n_walked)
            if prior is not None:
                lp[w] = torch.where(ok, lp_new, lp[w])
            oks.append(ok)
            for d in range(w, D, W):
                lt[d] = torch.where(ok, prop[d], lt[d])
            for k in range(w, K, W):
                part_k[k] = torch.where(ok, part[k], part_k[k])
            chi[w] = torch.where(ok, chi_new, chi[w])
            acc[w] = acc[w] + ok.to(torch.float32)
        assert all(torch.equal(ok, oks[0]) for ok in oks)
        r = it - 1 - burnin
        if r >= 0:
            for w in range(W):
                for d in range(w, D, W):
                    recs[0][r, d] = torch.exp(lt[d])[live]
                for k in range(w, K, W):
                    recs[2][r, k] = part_k[k][live]
                if w == D % W:
                    recs[1][r] = chi[w][live]
                if w == (D + 1) % W:
                    recs[3][r] = (acc[w] / f32(float(it)))[live]
    return recs


def test_joint_warp_per_experiment_equals_twin():
    """The kernel's warp-per-experiment layout gives joint_plain's records
    bitwise: decay (a) and logistic growth (b) of the heterogeneous pair
    plus a third experiment, decay on a's data with its own rate (K = 3,
    D = 3, the logistic's capacity static), on 100 chains (the last block
    of 32 holds 4)."""
    jf = JointFit(_hetero_pair(odelib_tpu_torch, LogNormal, device="cpu"),
                  shared=["k"], random_seed=3)
    specs, idx_maps, obs, times, y0s = (list(x) for x in _host_args(jf))
    for x, extra in zip((specs, idx_maps, obs, times, y0s),
                        (specs[0], (2,), obs[0], times[0], y0s[0])):
        x.append(extra)
    plans = [T._build_plan(sp, ob, tm, 1)
             for sp, ob, tm in zip(specs, obs, times)]
    rng = np.random.default_rng(8)
    th0 = torch.as_tensor((np.array([1.0, 1e6, 1.1]) * np.exp(rng.normal(
        0, 0.05, (100, 3)))).astype(np.float32).T.copy())
    kw = dict(nits=11, burnin=2, walk=(0.05, 0.0, 0.05),
              walked=(True, False, True))
    want = TJ.joint_plain(specs, plans, y0s, idx_maps, th0, 4, **kw)
    got = _joint_warps(specs, plans, y0s, idx_maps, th0, 4, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert 0 < float(got[3][-1].mean()) < 1


@pytest.mark.parametrize("K", [9, 20])
def test_joint_wide_layout_equals_twin(K):
    """The WIDE joint kernel's layout, 8 warps looping over K = 9 or 20
    experiments (warp 0 scores experiments 0, 8 and 16 and keeps their
    parts), gives joint_plain's records bitwise: decay experiments on the
    heterogeneous pair's data, each with its own rate and a shared static
    slot, 40 chains, with in-kernel priors at K = 20."""
    jf = JointFit(_hetero_pair(odelib_tpu_torch, LogNormal, device="cpu"),
                  shared=["k"], random_seed=3)
    specs, _, obs, times, y0s = (list(x) for x in _host_args(jf))
    specs, obs, times, y0s = ([x[0]] * K for x in (specs, obs, times, y0s))
    dim = K + 1                 # slot 0 static, experiment k's rate k + 1
    idx_maps = [(k + 1,) for k in range(K)]
    plans = [T._build_plan(sp, ob, tm, 1)
             for sp, ob, tm in zip(specs, obs, times)]
    rng = np.random.default_rng(9)
    th0 = torch.as_tensor((np.linspace(0.8, 1.2, dim) * np.exp(rng.normal(
        0, 0.05, (40, dim)))).astype(np.float32).T.copy())
    kw = dict(nits=9, burnin=2, walk=(0.0,) + (0.05,) * K,
              walked=(False,) + (True,) * K,
              prior=prior_table([None] + [D.LogNormal(s=0.5, scale=1.0)] * K)
              if K == 20 else None)
    want = TJ.joint_plain(specs, plans, y0s, idx_maps, th0, 4, **kw)
    got = _joint_warps(specs, plans, y0s, idx_maps, th0, 4, warps=8, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert 0 < float(got[3][-1].mean()) < 1


# one prior per joint dimension of the zero_i pair (phi, beta, a:mu, b:mu)
_JOINT_PRIORS = (D.TruncNormal(a=-1.5, b=1.5, loc=2.4e-8, scale=0.1e-8),
                 D.Weibull(c=40.0, scale=24.5), D.Beta(a=60.0, b=40.0),
                 D.Gamma(a=400.0, scale=0.0015))


def test_joint_warp_per_experiment_with_priors_equals_twin():
    """The warp-per-experiment layout with in-kernel priors (every warp
    adds the whole proposal's log prior once) gives joint_plain's records
    bitwise, on the zero_i pair (D = 4, K = 2) and 40 chains."""
    _, jf = _fits("zero_i-pair")
    specs, idx_maps, obs, times, y0s = _host_args(jf)
    plans = [T._build_plan(sp, ob, tm, 1)
             for sp, ob, tm in zip(specs, obs, times)]
    rng = np.random.default_rng(8)
    th0 = torch.as_tensor((np.array(_CENTRES["zero_i-pair"]) * np.exp(
        rng.normal(0, 0.05, (40, 4)))).astype(np.float32).T.copy())
    kw = dict(nits=11, burnin=2, walk=(0.1,) * 4, walked=(True,) * 4,
              prior=prior_table(_JOINT_PRIORS))
    want = TJ.joint_plain(specs, plans, y0s, idx_maps, th0, 4, **kw)
    got = _joint_warps(specs, plans, y0s, idx_maps, th0, 4, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert 0 < float(got[3][-1].mean()) < 1


def test_joint_twin_with_priors_matches_pallas_interpret():
    """In-kernel priors of the new families, one per joint dimension: the
    same accept sequences as the JAX kernel with the same priors; theta
    and chi within the no-prior test's tolerances."""
    ref_jf, jf = _fits("zero_i-pair")
    rng = np.random.default_rng(5)
    th0 = (np.array(_CENTRES["zero_i-pair"])
           * np.exp(rng.normal(0, 0.05, (128, jf.dim)))).astype(np.float32)
    kw = dict(nits=13, burnin=2, rwalk_std=0.1, substeps_list=[1, 1])
    ref = jax_joint_fused(*_host_args(ref_jf), th0, seed=4, tile_chains=128,
                          interpret=True, priors=jax_priors(_JOINT_PRIORS),
                          **kw)
    got = TJ.joint_metropolis_hastings_fused(
        *_host_args(jf), torch.as_tensor(th0), 4, priors=_JOINT_PRIORS, **kw)
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    plain = TJ.joint_metropolis_hastings_fused(
        *_host_args(jf), torch.as_tensor(th0), 4, **kw)
    assert (plain.acceptance_ratio != got.acceptance_ratio).any()
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               rtol=1e-5)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(ref.chi),
                               rtol=1e-4)


def test_joint_twin_with_priors_on_schedules_matches_pallas_interpret():
    """Priors with a non-uniform schedule in each experiment, the shape
    substeps='auto' gives (the two differ): the same accept sequences as
    the JAX kernel with the same priors and schedules; theta and chi
    within the no-prior test's tolerances."""
    ref_jf, jf = _fits("zero_i-pair")
    rng = np.random.default_rng(5)
    th0 = (np.array(_CENTRES["zero_i-pair"])
           * np.exp(rng.normal(0, 0.05, (128, jf.dim)))).astype(np.float32)
    n = [len(fw._times_fit) - 1 for fw in jf.frameworks.values()]
    scheds = [(3,) + (1,) * (n[0] - 3) + (2, 2),
              (1,) * (n[1] - 2) + (2, 3)]
    kw = dict(nits=13, burnin=2, rwalk_std=0.1, substeps_list=scheds)
    ref = jax_joint_fused(*_host_args(ref_jf), th0, seed=4, tile_chains=128,
                          interpret=True, priors=jax_priors(_JOINT_PRIORS),
                          **kw)
    got = TJ.joint_metropolis_hastings_fused(
        *_host_args(jf), torch.as_tensor(th0), 4, priors=_JOINT_PRIORS, **kw)
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    assert 0 < float(got.acceptance_ratio[:, -1].mean()) < 1
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               rtol=1e-5)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(ref.chi),
                               rtol=1e-4)


@pytest.mark.parametrize("name", sorted(_PAIRS))
def test_joint_survey_matches_jax(name):
    """joint_survey and JointFit.fit_survey in float64 against the JAX
    package's on the same draws (fixed dopri5, 4 substeps)."""
    ref_jf, jf = _fits(name)
    draws = jf.fit_survey(32)
    thetas = jf._thetas_from_df(draws)
    args = list(_host_args(jf))
    ref_args = ref_jf._device_args({})
    ref = np.asarray(jax_joint_survey(
        *ref_args[:5], jnp.asarray(thetas), method=ref_args[5],
        substeps_list=ref_args[6]))
    got = joint_survey(*args, torch.as_tensor(thetas), method="fixed_dopri5",
                       substeps_list=[4, 4]).numpy()
    assert got.dtype == np.float64 and np.isfinite(ref).mean() > 0.5
    # prior draws that blow the solve up give NaN on both sides
    np.testing.assert_allclose(got, ref, rtol=1e-9, equal_nan=True)
    np.testing.assert_allclose(draws["chi"].to_numpy(), ref, rtol=1e-9,
                               equal_nan=True)


def _report_numbers(text):
    body = text.split("Joint Fitting Report")[1]
    return np.array([float(v) for v in
                     re.findall(r"[-+]?\d\.\d{3}e[-+]\d+", body)])


def test_joint_mcmc_matches_odelib_tpu(monkeypatch, capsys):
    """JointFit.MCMC end to end on the zero_i pair: both packages score the
    port's LHS draws (the JAX package's LHS draws come from jax.random),
    seed the same chains and run their joint kernels."""
    ref_jf, jf = _fits("zero_i-pair")
    seen = {}
    orig = jf.fit_survey

    def capture(samples, **kw):
        out = orig(samples, **kw)
        seen["thetas"] = jf._thetas_from_df(out)
        return out
    monkeypatch.setattr(jf, "fit_survey", capture)
    got = jf.MCMC(chain_inits=6, iterations_per_chain=12, burnin=4,
                  fitsurvey_samples=48, substeps=1)
    report = capsys.readouterr().out

    dists = ref_jf._dists()
    draw_dims = [j for j, d in enumerate(dists) if d is not None]
    monkeypatch.setattr(jax_samplers, "sample_lhs",
                        lambda key, ds, n: seen["thetas"][:, draw_dims])
    ref = ref_jf.MCMC(chain_inits=6, iterations_per_chain=12, burnin=4,
                      fitsurvey_samples=48, backend="pallas",
                      pallas_interpret=True, pallas_tile_chains=128,
                      substeps=1)
    ref_report = capsys.readouterr().out
    assert list(got.columns) == list(ref.columns) == [
        "phi", "beta", "a:mu", "b:mu", "chi", "chi:a", "chi:b", "iteration",
        "acceptance_ratio", "chain#", "all_rejected"]
    assert len(got) == len(ref) == 6 * 7
    pd.testing.assert_index_equal(got.index, ref.index)
    for col in ref.columns:
        assert got[col].dtype == ref[col].dtype, col
    for col in ("iteration", "chain#", "all_rejected", "acceptance_ratio"):
        np.testing.assert_array_equal(got[col].to_numpy(),
                                      ref[col].to_numpy())
    for col in ("phi", "beta", "a:mu", "b:mu"):
        np.testing.assert_allclose(got[col], ref[col], rtol=1e-5, err_msg=col)
    for col in ("chi", "chi:a", "chi:b"):
        np.testing.assert_allclose(got[col], ref[col], rtol=5e-5, err_msg=col)
    a, b = _report_numbers(report), _report_numbers(ref_report)
    assert a.size == b.size == 2 * 4 + 3    # 4 x (median, std) + best chis
    np.testing.assert_allclose(a, b, rtol=1e-3)
    best = jf.set_best_params(got)
    assert jf.frameworks["a"].parameters["phi"].val == best["phi"]
    assert jf.frameworks["b"].parameters["mu"].val == best["b:mu"]


def test_joint_mcmc_use_priors_matches_odelib_tpu(monkeypatch):
    """JointFit.MCMC(use_priors=True) on the zero_i pair with priors of the
    new families (scipy generators; the shared phi's from framework a):
    both packages score the port's LHS draws, seed the same chains and run
    their joint kernels with the joint priors. Equal accept sequences,
    theta within 1e-5 and chi within 1e-4."""
    import scipy.stats
    ref_jf, jf = _fits("zero_i-pair")
    for pkg, fit in ((odelib_tpu, ref_jf), (odelib_tpu_torch, jf)):
        for fw in fit.frameworks.values():
            fw.set_parameters(
                mu=pkg.parameter(scipy.stats.gamma,
                                 {"a": 400.0, "scale": 0.0015},
                                 random_seed=1),
                phi=pkg.parameter(scipy.stats.halfnorm,
                                  {"loc": 2.2e-8, "scale": 0.2e-8},
                                  random_seed=2),
                beta=pkg.parameter(scipy.stats.weibull_min,
                                   {"c": 40.0, "scale": 24.5},
                                   random_seed=3))
    seen = {}
    orig = jf.fit_survey

    def capture(samples, **kw):
        out = orig(samples, **kw)
        seen["thetas"] = jf._thetas_from_df(out)
        return out
    monkeypatch.setattr(jf, "fit_survey", capture)
    kw = dict(chain_inits=16, iterations_per_chain=12, burnin=4,
              fitsurvey_samples=48, substeps=1, rwalk_std=0.1,
              print_report=False)
    got = jf.MCMC(use_priors=True, **kw)
    dists = ref_jf._dists()
    draw_dims = [j for j, d in enumerate(dists) if d is not None]
    monkeypatch.setattr(jax_samplers, "sample_lhs",
                        lambda key, ds, n: seen["thetas"][:, draw_dims])
    ref = ref_jf.MCMC(use_priors=True, backend="pallas",
                      pallas_interpret=True, pallas_tile_chains=128, **kw)
    for col in ("iteration", "chain#", "acceptance_ratio"):
        np.testing.assert_array_equal(got[col].to_numpy(),
                                      ref[col].to_numpy())
    for col in ("phi", "beta", "a:mu", "b:mu"):
        np.testing.assert_allclose(got[col], ref[col], rtol=1e-5, err_msg=col)
    for col in ("chi", "chi:a", "chi:b"):
        np.testing.assert_allclose(got[col], ref[col], rtol=1e-4, err_msg=col)
    plain = jf.MCMC(use_priors=False, **kw)
    assert (plain.acceptance_ratio != got.acceptance_ratio).any()


def test_joint_unported_options_raise():
    """The options not ported raise naming their ROADMAP item; the
    checkpoint and run-length options, ported, raise the reference's
    ValueErrors where misused (tests/test_torch_joint_checkpoint.py runs
    them)."""
    _, jf = _fits("zero_i-pair")
    for kw, exc, match in (
            (dict(sampler="hmc"), NotImplementedError, "item 16"),
            (dict(backend="xla"), NotImplementedError, "item 15"),
            (dict(checkpoint_every=5), ValueError,
             "requires checkpoint_path"),
            (dict(until_rhat=1.1, checkpoint_every=5,
                  checkpoint_path="x.npz"), ValueError,
             "cannot be combined")):
        with pytest.raises(exc, match=match):
            jf.MCMC(chain_inits=4, iterations_per_chain=6,
                    fitsurvey_samples=16, print_report=False, **kw)
    # a prior without an in-kernel form: the reference's XLA joint sampler
    # under backend='auto', its ValueError under 'pallas'
    jf.frameworks["b"].set_parameters(mu=odelib_tpu_torch.parameter(
        D.DiscreteNormal(mu=1.0, sigma=0.2)))
    with pytest.raises(NotImplementedError, match="item 15"):
        jf.MCMC(chain_inits=4, iterations_per_chain=6, fitsurvey_samples=16,
                print_report=False, use_priors=True)
    with pytest.raises(ValueError, match="unsupported prior family"):
        jf.MCMC(chain_inits=4, iterations_per_chain=6, fitsurvey_samples=16,
                print_report=False, use_priors=True, backend="pallas")
    fws = _zero_i_pair(odelib_tpu_torch, LogNormal, device="cpu")
    with pytest.raises(NotImplementedError, match="item 16"):
        JointFit(fws, shared=["phi"], hierarchical=["beta"])
    with pytest.raises(ValueError, match="lacks tied"):
        JointFit(fws, shared=["lam"])
