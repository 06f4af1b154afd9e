"""The plan tables the kernels read (``ops/cuda_mh.py`` ``plan_tables``,
``csrc/common.cuh`` ``load_plan``/``obs_terms``): the header's offsets, each
step's observation range, and the flat per-observation records (member
mask, lab, den, ab) read as the kernels read them, held bitwise against the
twin's ``obs_terms`` on zero_i and on one_i, whose host observable sums two
states, and on chains of 33 and 42 states, whose member masks take two
words. Imports neither jax nor the JAX package."""

import numpy as np
import pytest
import torch

from odelib_tpu_torch.data import (build_obsdata_host,
                                   compact_observation_grid,
                                   format_dataframe, load_demo_dataframe)
from odelib_tpu_torch.models import one_i, zero_i
from odelib_tpu_torch.ops import cuda_mh as T

from scoring_cases import chain_case

_TABLES_I = ("step_gi", "step_obs", "obs_ptr", "obs_mask", "init_pidx")
_TABLES_F = ("steps", "lab", "den", "ab", "y0")


def _model(name):
    model, host = {"zero_i": (zero_i, "S"), "one_i": (one_i, "H")}[name]
    df = format_dataframe(load_demo_dataframe(host=host, virus="V"),
                          model.snames)
    times = np.linspace(0, df["time"].max(), 288)
    spec = model.spec()
    obs, _ = build_obsdata_host(df, times, spec.post_snames)
    tf, obs = compact_observation_grid(obs, times)
    y0 = np.ones(len(spec.snames))
    return spec, T._build_plan(spec, obs, tf, 3), y0


def _decode(plan_i, plan_f, n_states=2):
    """The tables by name, cut at the header's offsets (load_plan)."""
    n_steps, n_grid, n_obs, stepper = (int(v) for v in plan_i[:4])
    sizes_i = (n_steps, 2 * n_steps, n_grid + 1,
               n_obs * T.mask_words(n_states), None)
    tabs = {}
    for k, (name, size) in enumerate(zip(_TABLES_I, sizes_i)):
        at = int(plan_i[4 + k])
        end = int(plan_i[5 + k]) if k + 1 < len(_TABLES_I) else len(plan_i)
        assert size is None or end - at == size, name
        tabs[name] = plan_i[at:end]
    sizes_f = (8 * n_steps, n_obs, n_obs, n_obs, None)
    for k, (name, size) in enumerate(zip(_TABLES_F, sizes_f)):
        at = int(plan_i[9 + k])
        end = int(plan_i[10 + k]) if k + 1 < len(_TABLES_F) else len(plan_f)
        assert size is None or end - at == size, name
        tabs[name] = plan_f[at:end]
    return tabs, stepper


@pytest.mark.parametrize("name", ["zero_i", "one_i"])
@pytest.mark.parametrize("stepper", ["dopri5", "rk4"])
def test_plan_header_and_step_ranges(name, stepper):
    spec, plan, y0 = _model(name)
    plan_i, plan_f = T.plan_tables(spec, plan, y0, stepper)
    assert plan_i.dtype == np.int32 and plan_f.dtype == np.float32
    tabs, sid = _decode(plan_i, plan_f)
    assert sid == {"dopri5": 0, "rk4": 1}[stepper]
    assert plan_f[0] == np.float32(plan.sstot)
    assert len(tabs["init_pidx"]) == len(tabs["y0"]) == len(spec.snames)
    ptr = tabs["obs_ptr"]
    for k, (_, _, gi) in enumerate(plan.step_ts):
        assert tabs["step_gi"][k] == gi
        o0, o1 = tabs["step_obs"][2 * k:2 * k + 2]
        if gi >= 0:
            assert (o0, o1) == (ptr[gi], ptr[gi + 1])
        else:
            assert o0 == o1
    # every observation is scored exactly once: after grid point 0 or
    # after the one step that ends at its grid point
    scored = ptr[1] - ptr[0] + sum(
        int(tabs["step_obs"][2 * k + 1] - tabs["step_obs"][2 * k])
        for k in range(len(plan.step_ts)))
    assert scored == int(plan_i[2]) == ptr[-1]


@pytest.mark.parametrize("name", ["zero_i", "one_i"])
def test_flat_observation_records_score_as_the_twin(name):
    """obs_terms over the flat records, read as common.cuh reads them
    (the masked states summed in ascending order), equals the twin's
    obs_terms on the plan's member tuples bitwise, at every grid point."""
    spec, plan, y0 = _model(name)
    plan_i, plan_f = T.plan_tables(spec, plan, y0, "dopri5")
    tabs, _ = _decode(plan_i, plan_f)
    S = len(spec.snames)
    rng = np.random.default_rng(1)
    y = [torch.as_tensor(np.exp(rng.normal(3.0, 4.0, 64)).astype(np.float32))
         for _ in range(S)]
    if name == "one_i":         # H = S + I1: a two-member mask
        assert any(bin(int(m)).count("1") == 2 for m in tabs["obs_mask"])
    ptr = tabs["obs_ptr"]
    for gi in range(plan.n_grid):
        zero = torch.zeros(64)
        want = T.obs_terms(plan.obs_after[gi], y, zero, zero)
        chi, ssres = zero, zero
        for o in range(ptr[gi], ptr[gi + 1]):
            mask = int(tabs["obs_mask"][o])
            pred = None
            for s in range(S):
                if (mask >> s) & 1:
                    pred = y[s] if pred is None else pred + y[s]
            d = torch.tensor(tabs["lab"][o]) - torch.log(pred)
            chi = chi + (d * d) / torch.tensor(tabs["den"][o])
            e = pred - torch.tensor(tabs["ab"][o])
            ssres = ssres + e * e
        for a, b in zip((chi, ssres), want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def _chain_model(n):
    """two_i with n latent classes (``scoring_cases.chain_case``):
    S = n + 2 states, the observed host H = S + I1 + ... + In."""
    spec, obs, tf, _ = chain_case(n)
    return spec, T._build_plan(spec, obs, tf, 1), np.ones(len(spec.snames))


def _mask_scores(tabs, plan, S, y):
    """obs_terms over the flat records read as common.cuh reads them:
    bit s % 32 of word s // 32 of the observation's mask_words(S)."""
    ptr, mw = tabs["obs_ptr"], T.mask_words(S)
    out = []
    for gi in range(plan.n_grid):
        zero = torch.zeros(y[0].shape)
        chi, ssres = zero, zero
        for o in range(ptr[gi], ptr[gi + 1]):
            words = [int(w) & 0xFFFFFFFF
                     for w in tabs["obs_mask"][o * mw:(o + 1) * mw]]
            pred = None
            for s in range(S):
                if (words[s // 32] >> (s % 32)) & 1:
                    pred = y[s] if pred is None else pred + y[s]
            d = torch.tensor(tabs["lab"][o]) - torch.log(pred)
            chi = chi + (d * d) / torch.tensor(tabs["den"][o])
            e = pred - torch.tensor(tabs["ab"][o])
            ssres = ssres + e * e
        out.append((chi, ssres,
                    T.obs_terms(plan.obs_after[gi], y, zero, zero)))
    return out


def test_plan_tables_raise_above_32_states():
    """Above 32 states an observation's members take mask_words(S) words:
    a 33-state plan builds (no state limit raises), its host observation
    carries all n + 1 of its members, and the records read word by word
    score bitwise as the twin's obs_terms."""
    for n in (31, 40):
        spec, plan, y0 = _chain_model(n)
        S = len(spec.snames)
        assert T.mask_words(S) == 2
        plan_i, plan_f = T.plan_tables(spec, plan, y0, "dopri5")
        tabs, _ = _decode(plan_i, plan_f, S)
        masks = tabs["obs_mask"].reshape(-1, 2).astype(np.int64) \
            & 0xFFFFFFFF
        counts = [bin(int(a)).count("1") + bin(int(b)).count("1")
                  for a, b in masks]
        assert max(counts) == n + 1 and min(counts) == 1
        rng = np.random.default_rng(2)
        y = [torch.as_tensor(np.exp(rng.normal(3.0, 4.0, 16)).astype(
            np.float32)) for _ in range(S)]
        for chi, ssres, want in _mask_scores(tabs, plan, S, y):
            for a, b in zip((chi, ssres), want):
                np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("n_states", [1, 31, 32, 33, 42, 64, 65])
def test_member_mask_words(n_states):
    """One word up to 32 states, bit s of it for state s (bit 31 as the
    int32's sign); above, bit s % 32 of word s // 32."""
    mw = T.mask_words(n_states)
    assert mw == (1 if n_states <= 32 else -(-n_states // 32))
    members = tuple(range(0, n_states, 3)) + (n_states - 1,)
    words = T.member_mask(members, n_states)
    assert len(words) == mw
    assert all(-2 ** 31 <= w < 2 ** 31 for w in words)
    got = {s for s in range(n_states)
           if (words[s // 32] & 0xFFFFFFFF) >> (s % 32) & 1}
    assert got == set(members)
