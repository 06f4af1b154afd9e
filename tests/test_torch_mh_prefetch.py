"""The MH kernel's prefetching schedule (csrc/mh.cu) emulated lane by lane
in torch on the CPU, held bitwise against the serial twin ``mh_plain``.

A chain runs on a group of four lanes with replicated state. At the start
of a round at iteration ``it`` the lanes solve the four nodes of a
speculation tree picked by the chain's acceptance so far: lane 0 (A) the
proposal of ``it``, lane 1 (B) that of ``it + 1`` built on A's proposal,
and lanes 2 and 3 C (``it + 1`` on the current state) and D (``it + 2``
after A and C reject), or C and BB (``it + 2`` after A and B accept), or
BB and BBB. The group exchanges chi and R^2 (the kernel's width-4
shuffles) and every lane replays the serial decisions down the tree with
the serial uniforms, so a round completes 1 to 4 iterations, and lane k
stores the k-th row it completes. With priors each lane evaluates the log
prior of its own node beside its solve, and the group exchanges it with
chi and R^2. The emulation pads the lanes to whole
warps as the kernel does (lanes past the last chain run no round and
store nothing). This file imports neither jax nor the JAX package;
``CASES`` also drive the kernel-versus-twin cases on the card
(tests/test_torch_cuda.py).
"""
import math
from collections import Counter

import numpy as np
import pytest
import torch

from odelib_tpu_torch.data import (build_obsdata_host,
                                   compact_observation_grid,
                                   format_dataframe, load_demo_dataframe)
from odelib_tpu_torch import distributions as D
from odelib_tpu_torch.models import zero_i
from odelib_tpu_torch.ops import cuda_mh as T
from odelib_tpu_torch.ops.priors import logprior_plain, prior_table
from odelib_tpu_torch.ops.runge_kutta import const

G = 4          # lanes a chain
WARP = 32

# Prior assignments over zero_i's slots (mu, phi, beta) that cover the ten
# in-kernel families, centred on the start region (0.6, 2.4e-8, 24) so the
# chains accept; the last leaves phi without a prior.
PRIOR_SETS = {
    "lognormal-normal-uniform": (
        D.LogNormal(s=0.05, scale=0.6), D.Normal(loc=2.4e-8, scale=0.1e-8),
        D.Uniform(loc=22.0, scale=4.0)),
    "gamma-truncnorm-exponential": (
        D.Gamma(a=400.0, scale=0.0015),
        D.TruncNormal(a=-1.5, b=1.5, loc=2.4e-8, scale=0.1e-8),
        D.Exponential(loc=20.0, scale=2.0)),
    "cauchy-halfnormal-weibull": (
        D.Cauchy(loc=0.6, scale=0.01), D.HalfNormal(loc=2.2e-8, scale=0.2e-8),
        D.Weibull(c=40.0, scale=24.5)),
    "beta-none-gamma": (
        D.Beta(a=60.0, b=40.0), None, D.Gamma(a=600.0, scale=0.04)),
}

# name: (chains, nits, burnin, walk_mask, rwalk_std, stepper, priors); 13
# chains are 52 lanes, so the second warp is part empty; nits 2-7 end the
# last round at every residue of rounds of 2, 3 and 4 iterations
CASES = {
    **{f"nits{n}": (13, n, 0, None, 0.05, "dopri5", None)
       for n in range(2, 8)},
    "burnin-mid-round": (13, 21, 6, None, 0.05, "dopri5", None),
    "burnin-mid-round-odd": (13, 22, 7, None, 0.05, "dopri5", None),
    "walk-101": (13, 20, 4, [1, 0, 1], 0.05, "dopri5", None),
    "rk4": (13, 20, 4, None, 0.05, "rk4", None),
    "accept-near-0": (13, 24, 0, None, 3.0, "dopri5", None),
    "accept-near-1": (13, 24, 0, None, 1e-5, "dopri5", None),
    **{f"priors-{k}": (13, 21, 6, None, 0.1, "dopri5", v)
       for k, v in PRIOR_SETS.items()},
}


def demo_inputs():
    """zero_i on the committed demo data, the main path's grid."""
    df = format_dataframe(load_demo_dataframe(host="S", virus="V"), ("S", "V"))
    times = np.linspace(0, df["time"].max(), 288)
    spec = zero_i.spec()
    obs, _ = build_obsdata_host(df, times, spec.post_snames)
    tf, obs = compact_observation_grid(obs, times)
    y0 = np.array([df.loc["S"].iloc[0]["abundance"],
                   df.loc["V"].iloc[0]["abundance"]])
    return spec, obs, tf, y0


def start_points(C, seed=0):
    rng = np.random.default_rng(seed)
    return (np.array([0.6, 2.4e-8, 24.0])
            * np.exp(rng.normal(0, 0.05, (C, 3)))).astype(np.float32)


def walk_of(walk_mask, rwalk_std):
    mask = [1.0] * 3 if walk_mask is None else walk_mask
    return (tuple(float(rwalk_std) * float(w) for w in mask),
            tuple(float(w) != 0.0 for w in mask))


def _uniform(key, ctr):
    """The counter RNG's uniform for a per-lane counter tensor."""
    return T._unit(T.mix(key ^ T.mix(ctr & 0xFFFFFFFF)))


def _normal(key, ctr):
    u1, u2 = _uniform(key, ctr), _uniform(key, ctr + 1)
    return torch.sqrt(const(-2.0, u1) * torch.log(u1)) * torch.cos(
        const(2.0 * math.pi, u2) * u2)


# the kernel's speculation trees (csrc/mh.cu): per tree, each node's depth
# and its child after a reject and after an accept (-1: the tree ends)
DEPTH = torch.tensor([[0, 1, 1, 2], [0, 1, 1, 2], [0, 1, 2, 3]])
CHILD = torch.tensor([[[2, 1], [-1, -1], [3, -1], [-1, -1]],
                      [[2, 1], [-1, 3], [-1, -1], [-1, -1]],
                      [[-1, 1], [-1, 2], [-1, 3], [-1, -1]]])


def prefetch_mh(spec, plan, y0, theta0, seed, *, nits, burnin, walk, walked,
                num, stepper="dopri5", prior=None):
    """mh.cu's mh_kernel lane by lane. ``theta0`` (P, C) float32, ``prior``
    a prior table or None; returns mh_plain's records, a Counter of the
    iterations each chain's rounds completed and a Counter of the trees
    they used."""
    score = T.make_scorer(spec, plan, y0, stepper)
    P, C = theta0.shape
    R = nits - 1 - burnin
    L = -(-C * G // WARP) * WARP            # lanes of whole warps
    t = torch.arange(L)
    c_own, role = t // G, t % G
    live = c_own < C
    c = torch.where(live, c_own, torch.full_like(c_own, C - 1))
    key = T.Rng(seed, c)._key
    th = theta0[:, c]
    chi, rsq = score(list(th))
    lp = None if prior is None else logprior_plain(prior, list(th))
    lt = [torch.log(v) for v in th]
    acc = torch.zeros_like(chi)
    it = torch.where(live, torch.ones_like(t), torch.full_like(t, nits))
    recs = [torch.full((R, P, C), float("nan"))] + [
        torch.full((R, C), float("nan")) for _ in range(4)]
    scale = [const(w, chi) for w in walk]
    two, aic_c = const(2.0, chi), const(2.0 * num, chi)
    slot = 2 * sum(walked)
    rounds, trees = Counter(), Counter()

    def record(mask, k, its):
        """Lane k of each group stores the row of iteration ``its``."""
        r = its - 1 - burnin
        m = mask & live & (role == k) & (r >= 0)
        rows, cols = r[m], c[m]
        for p in range(P):
            recs[0][rows, p, cols] = torch.exp(lt[p][m])
        recs[1][rows, cols] = chi[m]
        recs[2][rows, cols] = rsq[m]
        recs[3][rows, cols] = two * chi[m] + aic_c
        recs[4][rows, cols] = acc[m] / its[m].to(torch.float32)

    while bool((it < nits).any()):          # the warp's __any_sync
        b0 = it * 1024
        past = (it - 1).to(torch.float32)
        tree = torch.where(acc > const(0.8, acc) * past, 2, torch.where(
            acc > const(0.5, acc) * past, 1, 0))
        nd = [[], [], [], []]
        for p in range(P):
            if not walked[p]:
                for n in range(4):
                    nd[n].append(lt[p])
                continue
            first = 2 * sum(walked[:p])     # this slot's normal counter
            sp = [scale[p] * _normal(key, b0 + 1024 * d + first)
                  for d in range(4)]
            a = lt[p] + sp[0]
            b = a + sp[1]
            bb = b + sp[2]
            nd[0].append(a)
            nd[1].append(b)
            nd[2].append(torch.where(tree == 2, bb, lt[p] + sp[1]))
            nd[3].append(torch.where(tree == 2, bb + sp[3], torch.where(
                tree == 0, lt[p] + sp[2], bb)))
        nodes = [torch.stack(v) for v in zip(*nd)]       # P x (4, L)
        own = [torch.exp(v[role, t]) for v in nodes]
        chi_new, rsq_new = score(own)
        solved = it + DEPTH[tree, role] < nits  # past nits - 1: no solve
        chi_new = torch.where(solved, chi_new, torch.zeros_like(chi_new))
        rsq_new = torch.where(solved, rsq_new, torch.zeros_like(rsq_new))
        lp_new = torch.zeros_like(chi_new) if prior is None else torch.where(
            solved, logprior_plain(prior, own), torch.zeros_like(chi_new))
        # the width-4 shuffles: every lane reads its group's four results
        base = t - role
        chi_n = torch.stack([chi_new[base + n] for n in range(G)])
        rsq_n = torch.stack([rsq_new[base + n] for n in range(G)])
        lp_n = torch.stack([lp_new[base + n] for n in range(G)])
        act = it < nits
        n, k, going = torch.zeros_like(it), torch.zeros_like(it), act
        for _ in range(G):                  # the replay down the tree
            u = _uniform(key, b0 + 1024 * k + slot)
            log_ratio = chi - chi_n[n, t]
            if prior is not None:
                log_ratio = log_ratio + (lp_n[n, t] - lp)
            ok = going & (torch.exp(log_ratio) > u)
            lt = [torch.where(ok, v[n, t], x) for v, x in zip(nodes, lt)]
            if prior is not None:
                lp = torch.where(ok, lp_n[n, t], lp)
            chi = torch.where(ok, chi_n[n, t], chi)
            rsq = torch.where(ok, rsq_n[n, t], rsq)
            acc = acc + ok.to(torch.float32)
            record(going, k, it + k)
            k = k + going.to(torch.int64)
            nxt = CHILD[tree, n, ok.to(torch.int64)]
            going = going & (nxt >= 0) & (it + k < nits)
            n = torch.where(going, nxt, n)
        # the group's lanes hold one state: no second exchange is needed
        for v in lt + [chi, rsq, acc] + ([] if lp is None else [lp]):
            g = v.view(-1, G)
            assert torch.equal(g, g[:, :1].expand_as(g))
        head = act & live & (role == 0)
        rounds.update(k[head].tolist())
        trees.update(tree[head].tolist())
        it = it + k
    assert not any(torch.isnan(r).any() for r in recs), "a row was not stored"
    return tuple(recs), rounds, trees


@pytest.fixture(scope="module")
def demo():
    return demo_inputs()


def run_case(demo, case, device="cpu", substeps=1, chains=None):
    """The emulation's (or, on the card, the kernel's) records and
    mh_plain's on one case (``chains`` replaces its chain count); returns
    (got, want, rounds, trees), the last two None on the card."""
    spec, obs, tf, y0 = demo
    C, nits, burnin, mask, std, stepper, priors = CASES[case]
    C = chains or C
    walk, walked = walk_of(mask, std)
    plan = T._build_plan(spec, obs, tf, substeps)
    th0 = torch.as_tensor(start_points(C).T.copy(), device=device)
    prior = None if priors is None else prior_table(priors)
    kw = dict(nits=nits, burnin=burnin, walk=walk, walked=walked, num=3,
              stepper=stepper, prior=prior)
    want = T.mh_plain(spec, plan, y0, th0, 11, **kw)
    if device == "cpu":
        got, rounds, trees = prefetch_mh(spec, plan, y0, th0, 11, **kw)
        return got, want, rounds, trees
    out = T.metropolis_hastings_fused(
        spec, obs, tf, y0, th0.t().contiguous(), 11, nits=nits,
        burnin=burnin, walk_mask=mask, rwalk_std=std, substeps=substeps,
        stepper=stepper, priors=priors)
    got = (out.theta.permute(1, 2, 0), out.chi.t(), out.rsquared.t(),
           out.aic.t(), out.acceptance_ratio.t())
    return got, want, None, None


def assert_bitwise(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefetch_schedule_equals_the_serial_chain(demo, case):
    got, want, rounds, _ = run_case(demo, case)
    assert_bitwise(got, want)
    nits = CASES[case][1]
    # every chain's rounds add up to its nits - 1 iterations
    assert sum(k * n for k, n in rounds.items()) == 13 * (nits - 1)
    assert set(rounds) <= {1, 2, 3, 4}


def test_prefetch_trees_follow_the_acceptance(demo):
    """Near acceptance 1 the chains take the all-accept tree, 4 iterations
    a round; near 0 the first tree, mostly 3 (A, C and D reject); a
    moderate walk gives rounds of 2 and 3."""
    seen = {}
    for case in ("accept-near-1", "accept-near-0", "burnin-mid-round"):
        got, want, rounds, trees = run_case(demo, case)
        assert_bitwise(got, want)
        seen[case] = rounds, trees
    (hi, hi_t), (lo, lo_t), (mid, mid_t) = (
        seen[k] for k in ("accept-near-1", "accept-near-0",
                          "burnin-mid-round"))
    # every chain starts on the first tree (no acceptance yet)
    assert hi_t[2] > 3 * (hi_t[0] + hi_t[1]) and hi[4] > 3 * hi[3]
    assert lo_t[0] > 10 * lo_t[2] and lo[3] > 2 * lo[2]
    assert mid[2] > 0 and mid[3] > 0 and mid_t[0] > 0 and mid_t[1] > 0
