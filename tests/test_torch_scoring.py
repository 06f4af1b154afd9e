"""The scorer's cases (``scoring_cases``, shared with the card tests and
``chip_smoke.py``): the pk_oral and demo frames, and the plan tables'
censoring and dose rows, read as ``csrc/common.cuh`` reads them. Imports
neither jax nor the JAX package."""
import numpy as np
import pytest
import torch

from odelib_tpu_torch.data import format_dataframe
from odelib_tpu_torch.model import make_spec
from odelib_tpu_torch.models import zero_i
from odelib_tpu_torch.ops import cuda_mh as T
from odelib_tpu_torch.rhs import adapt_rhs
from scoring_cases import (FAMILIES, PK_DOSES, demo_frame, fit_inputs,
                           pk_case, pk_frame, zero_i_case)


def test_pk_frame_and_doses():
    """The pk_oral data: 36 points, a fifth of them at the LLOQ and
    left-censored; every dose time lies on the compact grid."""
    df = pk_frame()
    assert len(df) == 36 and df["censored"].sum() == 7
    assert (df.loc[df["censored"], "abundance"]
            == df["abundance"].min()).all()
    spec, obs, tf, _ = pk_case()
    assert (np.asarray(obs.censor) == 1).sum() == 7
    for t, _, _ in PK_DOSES:
        assert np.min(np.abs(tf - t)) < 1e-12


def test_demo_frame_censoring():
    """Four host points below 1.5e6 go left-censored, two virus points
    above 2.5e8 right-censored; the count models' data is integral."""
    df = demo_frame("lognormal", ("left", "right"))
    assert (df["censored"] == "left").sum() == 4
    assert (df["censored"] == "right").sum() == 2
    spec, obs, _, _ = zero_i_case("lognormal", ("left", "right"))
    np.testing.assert_array_equal(np.bincount(np.asarray(obs.censor)),
                                  [31, 4, 2])
    counts = demo_frame("poisson")["abundance"]
    assert (counts == np.round(counts)).all()


def _decode(plan_i, plan_f):
    """The censoring and dose rows by name, at the header's entries 14-18
    (common.cuh H_CEN, H_DOSE_PTR, H_DOSE_STATE, H_F_LSIG,
    H_F_DOSE_AMT)."""
    n_grid, n_obs = int(plan_i[1]), int(plan_i[2])
    cen = plan_i[plan_i[14]:plan_i[14] + n_obs]
    ptr = plan_i[plan_i[15]:plan_i[15] + n_grid + 1]
    state = plan_i[plan_i[16]:plan_i[16] + ptr[-1]]
    lsig = plan_f[plan_i[17]:plan_i[17] + n_obs]
    amt = plan_f[plan_i[18]:plan_i[18] + ptr[-1]]
    return cen, ptr, state, lsig, amt


def test_plan_tables_censor_and_dose_rows():
    """The new rows: each observation's flag and float32 log sigma in the
    plan's order, and per grid point one dose per state, the amounts of
    one state summed in double first (two doses at one grid point)."""
    spec = make_spec(adapt_rhs(zero_i.rhs, "jax"), zero_i.pnames,
                     zero_i.snames, dose_events=(
                         (1.0, "V", 2.0e7), (1.0, "V", 0.1), (2.0, "S", 3.0)))
    df = format_dataframe(demo_frame("lognormal", ("left", "right")),
                          zero_i.snames)
    obs, tf = fit_inputs(spec, df, 288)
    plan = T._build_plan(spec, obs, tf, 2)
    plan_i, plan_f = T.plan_tables(spec, plan, np.ones(2), "dopri5")
    cen, ptr, state, lsig, amt = _decode(plan_i, plan_f)
    flat = [o for grid in plan.obs_after for o in grid]
    np.testing.assert_array_equal(cen, [o[4] for o in flat])
    np.testing.assert_array_equal(lsig, np.float32([o[2] for o in flat]))
    g1, g2 = (int(np.argmin(np.abs(tf - t))) for t in (1.0, 2.0))
    assert ptr[-1] == 2 and list(np.diff(ptr).nonzero()[0]) == [g1, g2]
    np.testing.assert_array_equal(state, [1, 0])
    np.testing.assert_array_equal(amt, np.float32([2.0e7 + 0.1, 3.0]))
    assert T.scoring(plan) == ("lognormal", 0.0, True, True)
    # the original tables keep their header entries and sizes
    assert plan_i[4] == T._HDR + len(cen) + len(ptr) + len(state)
    np.testing.assert_array_equal(plan_f[plan_i[13]:plan_i[13] + 2],
                                  np.float32([1.0, 1.0]))


@pytest.mark.parametrize("obs_model", sorted(FAMILIES))
def test_flat_records_score_as_the_twin(obs_model):
    """common.cuh's obs_terms over the flat records (flag, lab, den or
    lsig, ab; the family's float32 constants), emulated in torch, equals
    the twin's obs_terms at every grid point, bitwise; the dose rows add
    as the twin's apply_doses."""
    censor = ("left", "right") if obs_model in ("lognormal",
                                                "student_t") else ()
    spec, obs, tf, y0 = zero_i_case(obs_model, censor, dosed=True)
    plan = T._build_plan(spec, obs, tf, 2)
    plan_i, plan_f = T.plan_tables(spec, plan, y0, "rk4")
    cen, ptr, state, lsig, amt = _decode(plan_i, plan_f)
    n_obs = int(plan_i[2])
    obs_ptr = plan_i[plan_i[6]:plan_i[6] + plan.n_grid + 1]
    lab = plan_f[plan_i[10]:plan_i[10] + n_obs]
    den = plan_f[plan_i[11]:plan_i[11] + n_obs]
    ab = plan_f[plan_i[12]:plan_i[12] + n_obs]
    mask = plan_i[plan_i[7]:plan_i[7] + n_obs]
    rng = np.random.default_rng(2)
    y = [torch.as_tensor(np.exp(rng.normal(16.0, 2.0, 64)).astype(np.float32))
         for _ in range(2)]
    y[0][:3] = torch.tensor([-1.0, 0.0, float("nan")])
    p = plan.obs_param
    t32 = {k: torch.tensor(np.float32(v)) for k, v in (
        ("nu", p), ("c1", 0.5 * (p + 1.0)), ("r", p))}
    tc = T.t_constants(p if obs_model == "student_t" else 1.0)
    for gi in range(plan.n_grid):
        zero = torch.zeros(64)
        want = T.obs_terms(plan.obs_after[gi], y, zero, zero, obs_model, p)
        chi, ssres = zero, zero
        for o in range(obs_ptr[gi], obs_ptr[gi + 1]):
            pred = y[int(mask[o]).bit_length() - 1]
            la, a = torch.tensor(lab[o]), torch.tensor(ab[o])
            if cen[o]:
                z = (la - torch.log(pred)) / torch.tensor(lsig[o])
                z = -z if cen[o] == 2 else z
                chi = chi - (T.t_logcdf(z, tc) if obs_model == "student_t"
                             else T.log_ndtr(z))
                continue
            if obs_model == "lognormal":
                d = la - torch.log(pred)
                chi = chi + (d * d) / torch.tensor(den[o])
            elif obs_model == "student_t":
                t = (la - torch.log(pred)) / torch.tensor(lsig[o])
                chi = chi + t32["c1"] * torch.log1p((t * t) / t32["nu"])
            else:
                if obs_model == "poisson":
                    term = pred - a * torch.log(pred)
                else:
                    term = t32["r"] * torch.log1p(pred / t32["r"]) \
                        + a * torch.log1p(t32["r"] / pred)
                chi = chi + torch.where(pred >= 0, term,
                                        torch.tensor(float("nan")))
            ssres = ssres + (pred - a) * (pred - a)
        for got, ref in zip((chi, ssres), want):
            np.testing.assert_array_equal(got.numpy(), ref.numpy())
        dosed = list(y)
        for d in range(ptr[gi], ptr[gi + 1]):
            dosed[state[d]] = dosed[state[d]] + torch.tensor(amt[d])
        for got, ref in zip(dosed, T.apply_doses(plan, gi, y)):
            np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_count_models_keep_zero_counts():
    """The count models keep a zero count (log abundance -inf) and the
    log-space models drop it, as the likelihood masks them."""
    df = demo_frame("poisson")
    df.loc[3, "abundance"] = 0.0
    n = {}
    for fam in ("poisson", "lognormal"):
        spec = make_spec(adapt_rhs(zero_i.rhs, "jax"), zero_i.pnames,
                         zero_i.snames, obs_model=fam,
                         obs_param=FAMILIES[fam])
        with np.errstate(divide="ignore"):
            obs, tf = fit_inputs(spec, format_dataframe(df, zero_i.snames),
                                 288)
        plan = T._build_plan(spec, obs, tf, 1)
        n[fam] = sum(len(g) for g in plan.obs_after)
    assert n["poisson"] == n["lognormal"] + 1 == len(df)
