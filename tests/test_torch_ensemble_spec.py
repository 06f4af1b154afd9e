"""The ensemble kernel's speculative schedule (csrc/ensemble.cu) emulated
lane by lane in torch on the CPU, held bitwise against the serial twin
``ensemble_plain``.

Column j of a run holds walker j of half A and walker j of half B. A launch
runs rounds r = it_base .. it_end - 1. After the round's grid barrier, warp
0's lane of the column solves B's proposal at r (from r >= it_base + 1),
decides it and posts the decision; warps 1 and 2 solve A's two candidates
at r + 1 (to r + 1 <= it_end - 1): the proposal towards its partner's
position if the partner rejects at r (in the first round, where the
partner does not move, the proposal itself) and towards the partner's own
proposal at r, recomputed, if it accepts. After a block barrier warp 1
waits for the partner's posted decision, takes the matching candidate
without solving again, decides and records. Iteration it's state lives in
buffer (it_end - 1 - it) & 1; the emulation stamps every state write with
its round and asserts that no state a round reads is written in the same
round (which the one grid barrier a round requires). Threads fewer than
columns take the columns in passes of 32 x blocks. This file imports neither jax nor the
JAX package; ``CASES`` also drive the kernel-versus-twin cases on the card
(tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

from odelib_tpu_torch.ops import cuda_mh as T
from odelib_tpu_torch.ops.priors import logprior_plain, prior_table
from odelib_tpu_torch.ops.runge_kutta import const

from test_torch_mh_prefetch import PRIOR_SETS, assert_bitwise, demo_inputs

_M32 = 0xFFFFFFFF
TILE = 256

# name: (walkers, nits, burnin, walk mask, stepper, prior set, blocks);
# 300 walkers pad to two ensembles of 256 (256 columns), 700 to three (384
# columns: 12, 4 and 2 passes on 1, 3 and 7 blocks of 32 columns); blocks
# None: a column a thread. nits 2 is the two lone rounds alone.
CASES = {
    "dopri5": (300, 12, 3, None, "dopri5", None, None),
    "dopri5-static-slot": (300, 12, 3, (1.0, 0.0, 1.0), "dopri5", None,
                           None),
    "nits2": (300, 2, 0, None, "dopri5", None, None),
    "nits3": (300, 3, 1, None, "dopri5", None, None),
    "dopri5-7-blocks": (700, 9, 2, None, "dopri5", None, 7),
    "kvaerno3": (300, 8, 2, None, "kvaerno3", None, None),
    **{f"kvaerno3-{b}-blocks": (700, 7, 2, None, "kvaerno3", None, b)
       for b in (1, 3, 7)},
    **{f"priors-{k}": (300, 9, 2, None, "dopri5", k, None)
       for k in PRIOR_SETS},
    "kvaerno3-priors": (300, 7, 2, None, "kvaerno3",
                        "lognormal-normal-uniform", None),
}


def _partner(seed, tile, e, jj, it, hb):
    """csrc/ensemble.cu partner(): the global index of the partner of
    walker ``jj`` of ensemble ``e``'s half ``hb`` at iteration ``it``."""
    half = tile // 256
    rp, lane = jj // 128, jj % 128
    lo = half if hb else 0
    scal_base = T.mix((seed * 0x7FEB352D + e * tile + 0xE75) & _M32)
    sbits = T.mix(scal_base ^ T.mix(torch.tensor(it * 2 + hb)))
    r_sub, r_lane = sbits % half, (sbits >> 8) % 128
    return e * tile + ((half - lo) + (rp - r_sub + half) % half) * 128 \
        + (lane - r_lane + 128) % 128


def speculative_ensemble(spec, plan, y0, theta0, seed, *, tile, nits, burnin,
                         a, walk, walked, num, W0, stepper="dopri5",
                         prior=None, R_chunk=None, it_base=0, state=None,
                         columns=None):
    """ens_kernel's rounds lane by lane; the arguments and the return value
    are ``ensemble_plain``'s (``columns``: the grid's columns, 32 a block,
    which threads loop over where the run has more; None: every column at
    once)."""
    score = T.make_scorer(spec, plan, y0, stepper)
    P, W = theta0.shape
    hn, cols = tile // 2, W // 2
    s = int(np.uint32(np.int64(seed) & _M32))
    it_end, rec0 = T.chunk_range(nits, burnin, R_chunk, it_base)
    i0, i1 = it_base + 1, it_end - 1
    R = it_end - 1 - rec0
    step = columns or cols
    passes = [torch.arange(j0, min(j0 + step, cols))
              for j0 in range(0, cols, step)]
    f32 = lambda v: const(float(np.float32(v)), theta0)  # noqa: E731
    one, am1, a_c, two = f32(1.0), f32(a - 1.0), f32(a), f32(2.0)
    nw1, aic_c = f32(sum(walked) - 1), f32(2.0 * num)
    scale = [f32(w) for w in walk]
    key = T.Rng(seed, torch.arange(W))._key
    # the two parities' state buffers, (P + 4) x W, and each walker's round
    # of its last write to each (the prologue's: it_base - 1)
    bufs = [torch.zeros(P + 4, W), torch.full((P + 4, W), float("nan"))]
    stamp = [torch.full((W,), -2 ** 40, dtype=torch.int64) for _ in bufs]
    dec = torch.full((cols,), -1, dtype=torch.int64)
    recs = [torch.full((R, P, W0), float("nan"))] + [
        torch.full((R, W0), float("nan")) for _ in range(4)]

    def par(it):
        return (i1 - it) & 1

    def read(it, g, r):
        """Rows of walkers g in iteration it's buffer, read in round r."""
        b = par(it)
        reads.append((b, g))
        return bufs[b][:, g]

    def settle(it, g, rows, r):
        """Walkers g's state (P + 4 rows) into iteration it's buffer in
        round r, and their records."""
        b = par(it)
        bufs[b][:, g] = rows
        stamp[b][g] = r
        k = it - 1 - rec0
        m = g < W0
        if k >= 0 and bool(m.any()):
            gm = g[m]
            recs[0][k][:, gm] = torch.exp(rows[:P, m])
            recs[1][k][gm] = rows[P, m]
            recs[2][k][gm] = rows[P + 1, m]
            recs[3][k][gm] = two * rows[P, m] + aic_c
            recs[4][k][gm] = rows[P + 2, m] / torch.full_like(
                rows[P + 2, m], float(it))

    def stretch(g, it, hb):
        u = T._unit(T.mix(key[g] ^ T.mix(torch.tensor(it * 1024 + 2 * hb))))
        t = one + am1 * u
        return (t * t) / a_c

    def accepts(g, it, hb, z, chi, chi_new, lp, lp_new):
        log_ratio = (nw1 * torch.log(z) + chi) - chi_new
        if prior is not None:
            log_ratio = log_ratio + (lp_new - lp)
        uacc = T._unit(T.mix(key[g] ^ T.mix(torch.tensor(
            it * 1024 + 2 * hb + 1))))
        return torch.exp(log_ratio) > uacc       # NaN / -inf rejects

    def moved(c, pt, omz, p):
        return c + (omz * (pt - c)) * scale[p] if walked[p] else c

    def solve(prop):
        thp = [torch.exp(v) for v in prop]
        chi_new, rsq_new = score(thp)
        lp_new = torch.zeros_like(chi_new) if prior is None \
            else logprior_plain(prior, thp)
        return chi_new, rsq_new, lp_new

    # the prologue: both walkers of every column into it_base's buffer
    for j in passes:
        e = j // hn
        for hb in (0, 1):
            g = e * tile + hb * hn + (j - e * hn)
            if state is not None:
                rows = state[:, g].clone()
            else:
                th = theta0[:, g]
                chi, rsq = score(list(th))
                lp = torch.zeros_like(chi) if prior is None \
                    else logprior_plain(prior, list(th))
                rows = torch.cat([torch.log(th), torch.stack(
                    [chi, rsq, torch.zeros_like(chi), lp])])
            b = par(it_base)
            bufs[b][:, g] = rows
            stamp[b][g] = it_base - 1

    for r in range(it_base, i1 + 1):            # after the grid barrier
        bprev = it_base if r < i0 else r - 1    # B before its update
        cand, reads = {}, []
        if r >= i0:                             # warp 0: B's update at r
            for j in passes:
                e, jj = j // hn, j % hn
                g = e * tile + hn + jj
                gp = _partner(s, tile, e, jj, r, 1)
                z = stretch(g, r, 1)
                old = read(bprev, g, r)
                pos = read(r, gp, r)[:P]
                prop = [moved(old[p], pos[p], one - z, p) for p in range(P)]
                chi_new, rsq_new, lp_new = solve(prop)
                ok = accepts(g, r, 1, z, old[P], chi_new, old[P + 3], lp_new)
                dec[j] = 2 * r + ok.to(torch.int64)
                new = torch.stack(prop + [chi_new, rsq_new,
                                          old[P + 2] + one, lp_new])
                settle(r, g, torch.where(ok, new, old), r)
        if r + 1 <= i1:                         # warps 1 and 2
            for c in ((0,) if r < i0 else (0, 1)):
                for j in passes:
                    e, jj = j // hn, j % hn
                    g = e * tile + jj
                    gp = _partner(s, tile, e, jj, r + 1, 0)
                    z = stretch(g, r + 1, 0)
                    pos = read(bprev, gp, r)[:P]
                    if c == 1:                  # the partner's proposal
                        gpp = _partner(s, tile, e, gp - e * tile - hn, r, 1)
                        pz = one - stretch(gp, r, 1)
                        at = read(r, gpp, r)[:P]
                        pos = [moved(pos[p], at[p], pz, p) for p in range(P)]
                    own = read(r, g, r)[:P]
                    prop = [moved(own[p], pos[p], one - z, p)
                            for p in range(P)]
                    cand[c, int(j[0])] = torch.stack(
                        prop + list(solve(prop)))
            # the block barrier; warp 1 waits for each partner's decision
            for j in passes:
                e, jj = j // hn, j % hn
                g = e * tile + jj
                gp = _partner(s, tile, e, jj, r + 1, 0)
                if r >= i0:
                    d = dec[e * hn + (gp - e * tile - hn)]
                    assert bool((d >= 2 * r).all()), "decision not posted"
                    took = (d - 2 * r).bool()
                else:
                    took = torch.zeros(len(j), dtype=torch.bool)
                own = cand[0, int(j[0])]
                if (1, int(j[0])) in cand:
                    own = torch.where(took, cand[1, int(j[0])], own)
                old = read(r, g, r)
                z = stretch(g, r + 1, 0)
                ok = accepts(g, r + 1, 0, z, old[P], own[P], old[P + 3],
                             own[P + 2])
                new = torch.cat([own[:P + 2], (old[P + 2] + one)[None],
                                 own[P + 2:]])
                settle(r + 1, g, torch.where(ok, new, old), r)
        # the round's lanes run in any order: none reads a state that
        # another writes in the same round
        for b, g in reads:
            assert bool((stamp[b][g] != r).all()), "a read races a write"
    assert not any(torch.isnan(v).any() for v in recs), "a row not stored"
    if R_chunk is None:
        return tuple(recs)
    out = bufs[0].clone()
    if prior is None:
        out[P + 3] = 0.0
    return tuple(recs), out


def grid_columns(case):
    """The columns of a case's grid (32 a block), or None."""
    blocks = CASES[case][-1]
    return None if blocks is None else 32 * blocks


@pytest.fixture(scope="module")
def demo():
    return demo_inputs()


def case_inputs(demo, case, device="cpu", substeps=1):
    """(spec, plan, y0, start (P, W), seed, ensemble_plain's keywords) of
    one case at ``substeps``."""
    spec, obs, tf, y0 = demo
    n, nits, burnin, mask, stepper, priors, _ = CASES[case]
    mask = (1.0, 1.0, 1.0) if mask is None else mask
    rng = np.random.default_rng(0)
    draws = (np.array([0.6, 2.4e-8, 24.0])
             * np.exp(rng.normal(0, 0.05, (n, 3)))).astype(np.float32)
    start = torch.as_tensor(np.ascontiguousarray(T.ensemble_init(
        draws, 11, TILE, mask, 0.01).T), device=device)
    kw = dict(tile=TILE, nits=nits, burnin=burnin, a=2.0, walk=mask,
              walked=tuple(w != 0.0 for w in mask), num=3, W0=n,
              stepper=stepper, prior=None if priors is None
              else prior_table(PRIOR_SETS[priors]))
    return spec, T._build_plan(spec, obs, tf, substeps), y0, start, 11, kw


@pytest.mark.parametrize("case", sorted(CASES))
def test_speculative_schedule_equals_the_serial_loop(demo, case):
    spec, plan, y0, start, seed, kw = case_inputs(demo, case)
    want = T.ensemble_plain(spec, plan, y0, start, seed, **kw)
    got = speculative_ensemble(spec, plan, y0, start, seed,
                               columns=grid_columns(case), **kw)
    assert_bitwise(got, want)
    assert 0 < float(want[4][-1].mean()) < 1


@pytest.mark.parametrize("case", ["dopri5", "kvaerno3-3-blocks",
                                  "priors-beta-none-gamma"])
def test_speculative_schedule_in_three_chunks(demo, case):
    """A run cut into 3 launches (each with its lone first and last
    rounds; the state handed on) records the whole serial run, bitwise,
    and ends in the serial chunk mode's state."""
    spec, plan, y0, start, seed, kw = case_inputs(demo, case)
    nits, burnin = kw["nits"], kw["burnin"]
    want = T.ensemble_plain(spec, plan, y0, start, seed, **kw)
    size = -(-(nits - 1) // 3)
    state, rows, it_base = None, [], 0
    while it_base < nits - 1:
        R = min(size, nits - 1 - it_base)
        recs, state = speculative_ensemble(
            spec, plan, y0, start, seed, R_chunk=R, it_base=it_base,
            state=state, columns=grid_columns(case), **kw)
        _, twin_state = T.ensemble_plain(
            spec, plan, y0, start, seed, R_chunk=it_base + R,
            it_base=0, **kw)
        assert_bitwise([state], [twin_state])
        rows.append(recs)
        it_base += R
    got = [torch.cat([r[i] for r in rows])[burnin:] for i in range(5)]
    assert_bitwise(got, want)


def test_first_round_has_no_b_and_last_no_a(demo):
    """nits 2: one proposal a half. Round 0 solves A(1) alone, round 1
    B(1) alone; both records equal the serial loop's."""
    spec, plan, y0, start, seed, kw = case_inputs(demo, "nits2")
    got = speculative_ensemble(spec, plan, y0, start, seed, **kw)
    want = T.ensemble_plain(spec, plan, y0, start, seed, **kw)
    assert_bitwise(got, want)
    assert got[0].shape[0] == 1
