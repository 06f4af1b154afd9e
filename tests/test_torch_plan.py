"""The plan tables the kernels read (``ops/cuda_mh.py`` ``plan_tables``,
``csrc/common.cuh`` ``load_plan``/``obs_terms``): the header's offsets, each
step's observation range, and the flat per-observation records (member
mask, lab, den, ab) read as the kernels read them, held bitwise against the
twin's ``obs_terms`` on zero_i and on one_i, whose host observable sums two
states. Imports neither jax nor the JAX package."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from odelib_tpu_torch.data import (build_obsdata_host,
                                   compact_observation_grid,
                                   format_dataframe, load_demo_dataframe)
from odelib_tpu_torch.models import one_i, zero_i
from odelib_tpu_torch.ops import cuda_mh as T

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


def _decode(plan_i, plan_f):
    """The tables by name, cut at the header's offsets (load_plan)."""
    n_steps, n_grid, n_obs, stepper = (int(v) for v in plan_i[:4])
    sizes_i = (n_steps, 2 * n_steps, n_grid + 1, n_obs, None)
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


def test_plan_tables_raise_above_32_states():
    """An observation's members are a 32-bit mask of states."""
    spec = SimpleNamespace(snames=tuple(f"s{i}" for i in range(33)))
    with pytest.raises(NotImplementedError, match="at most 32 states"):
        T.plan_tables(spec, None, None, "dopri5")
