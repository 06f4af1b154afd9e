"""Array-valued parameters (``pshapes``: one theta slot per entry) on the
reference's ``vec_model`` (tests/test_array_params.py: zero_i with a
2-vector growth/clearance parameter): the theta layout against
``odelib_tpu.model.make_spec``'s, the tracer's array proxies and what it
refuses (as ``rhs_supports_tiles`` refuses it), the survey and MH twins
against ``odelib_tpu``'s Pallas kernels in interpret mode (a zero-template
entry pinned at 0, per-slot priors), and ``ModelFramework`` end to end on
the CPU: LHS dimensions, ``fit_survey`` and the posterior frame's
per-cell arrays, ``set_best_params``. Kernel against twin on the card is
in tests/test_torch_cuda.py and chip_smoke.py's array phases."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import odelib_tpu.model as JM
import odelib_tpu_torch
import odelib_tpu_torch.model as TM
from odelib_tpu.data import (build_obsdata_host, compact_observation_grid,
                             format_dataframe)
from odelib_tpu.distributions import LogNormal as JLogNormal
from odelib_tpu.ops import pallas_mh as J
from odelib_tpu.ops.pallas_mh import rhs_supports_tiles
from odelib_tpu_torch import distributions as D
from odelib_tpu_torch.ops import cuda_mh as T
from odelib_tpu_torch.rhs import RhsTraceError, adapt_rhs, trace_rhs

from test_array_params import TRUE_MU, vec_df, vec_model
from test_torch_obs_models import assert_same_chains

PN, SN, SHAPES = ("mu", "phi", "beta"), ("S", "V"), ((2,), (), ())


@pytest.fixture(scope="module")
def kernel_setup():
    """tests/test_array_params.py's kernel_setup, both packages' specs."""
    df = format_dataframe(vec_df(), SN)
    df = df[np.isclose(np.mod(np.round(df["time"] / 0.2), 2), 0)]
    times = np.linspace(0, 3.1, 288)
    jspec = JM.make_spec(vec_model, PN, SN, pshapes=SHAPES)
    tspec = TM.make_spec(adapt_rhs(vec_model, "jax"), PN, SN, pshapes=SHAPES)
    obs_host, _ = build_obsdata_host(df, times, SN)
    tf, obs = compact_observation_grid(obs_host, times)
    y0 = np.array([df.loc["S"].iloc[0]["abundance"],
                   df.loc["V"].iloc[0]["abundance"]])
    return jspec, tspec, TM.obsdata_from_arrays(obs), obs, tf, y0


def _init_rhs(t, y, ps):
    mu, S0, A = ps
    S, V = y
    return jnp.stack([mu[0] * S - A[0, 1] * S * V,
                      A[1][0] * S * V - mu[1] * V])


@pytest.mark.parametrize("pn,shapes", [
    (PN, SHAPES),
    (("mu", "S0", "A"), ((2,), (), (2, 2))),
    (("A", "V0", "b"), ((2, 3), (), (3,))),
])
def test_layout_equals_reference(pn, shapes):
    """Offsets, theta_size, pack/unpack and init_pidx (an ``<s>0``
    parameter behind an array parameter sits at its slot offset)."""
    j = JM.make_spec(vec_model, pn, SN, pshapes=shapes)
    t = TM.make_spec(adapt_rhs(vec_model, "jax"), pn, SN, pshapes=shapes)
    assert t.theta_offsets == j.theta_offsets
    assert t.theta_size == j.theta_size and t.init_pidx == j.init_pidx
    rng = np.random.default_rng(0)
    vals = [rng.normal(size=s) if s else float(rng.normal()) for s in shapes]
    flat = t.pack_theta(vals)
    np.testing.assert_array_equal(flat, np.asarray(j.pack_theta(vals)))
    for a, b in zip(t.unpack_theta(flat), j.unpack_theta(jnp.asarray(flat))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    batch = t.unpack_theta(torch.as_tensor(np.tile(flat, (3, 1))))
    assert [tuple(v.shape) for v in batch] == [(3,) + s for s in shapes]


def test_tracer_takes_elementwise_array_parameters():
    """vec_model and a 2x2 parameter read as A[i, j] and A[i][j] (with
    iteration, len and elementwise arithmetic) trace to one leaf per slot
    and evaluate as the RHS does on stacked slots."""
    spec = TM.make_spec(adapt_rhs(_init_rhs, "jax"), ("mu", "S0", "A"), SN,
                        pshapes=((2,), (), (2, 2)))
    prog = trace_rhs(spec.rhs, 2, spec.pshapes)
    assert prog.n_params == 7
    src = prog.cuda_source()
    assert "p[0]" in src and "p[4]" in src and "p[5]" in src

    def loops(t, y, ps):
        mu, A = ps
        assert len(mu) == 2 and len(A) == 2 and len(A[0]) == 2
        rows = [sum(a * s for a, s in zip(row, y)) for row in A]
        return [r - m * s for r, m, s in zip(rows, mu * 2.0, y)]
    loop_spec = TM.make_spec(adapt_rhs(loops, "jax"), ("mu", "A"), SN,
                             pshapes=((2,), (2, 2)))
    lp = trace_rhs(loop_spec.rhs, 2, loop_spec.pshapes)
    rng = np.random.default_rng(1)
    y = [torch.tensor(rng.normal(size=4)) for _ in range(2)]
    ps = [torch.tensor(rng.normal(size=4)) for _ in range(6)]
    got = lp.evaluate(0.0, y, ps)
    mu, A = np.stack(ps[:2]), np.stack(ps[2:]).reshape(2, 2, 4)
    Y = np.stack(y)
    want = np.einsum("ijn,jn->in", A, Y) - 2.0 * mu * Y
    np.testing.assert_allclose(torch.stack(got).numpy(), want, rtol=1e-12)


def _mat_model(t, y, ps):
    A, phi, beta = ps
    return A @ y


def _dot_model(t, y, ps):
    A, phi, beta = ps
    return jnp.dot(A, y)


@pytest.mark.parametrize("fn,msg", [(_mat_model, "matrix product"),
                                    (_dot_model, "jnp.dot is not supported")])
def test_tracer_refuses_linear_algebra_as_reference(fn, msg):
    """``rhs_supports_tiles`` sends these to the XLA sampler; the tracer
    refuses them naming the construct, and ``MCMC`` runs them on the scan
    MH, the RHS called per lane through torch.func.vmap."""
    jbad = JM.make_spec(fn, ("A", "phi", "beta"), SN,
                        pshapes=((2, 2), (), ()))
    assert not rhs_supports_tiles(jbad)
    tbad = TM.make_spec(adapt_rhs(fn, "jax"), ("A", "phi", "beta"), SN,
                        pshapes=((2, 2), (), ()))
    with pytest.raises(RhsTraceError, match=msg):
        trace_rhs(tbad.rhs, 2, tbad.pshapes)
    fw = odelib_tpu_torch.ModelFramework(
        fn, ["A", "phi", "beta"], list(SN), dataframe=vec_df(),
        A=np.array([[0.5, 0.0], [0.0, 0.1]]), phi=2.4e-8, beta=24.0,
        t_steps=64, ode_style="jax", device="cpu")
    starts = [dict(A=np.array([[0.5, 0.0], [0.0, 0.1]]) * f, phi=2.4e-8,
                   beta=24.0) for f in (1.0, 1.1)]
    post = fw.MCMC(chain_inits=starts, iterations_per_chain=4,
                   print_report=False, profile=True)
    assert "chains[xla]" in fw.last_profile
    A = np.stack(post["A"].to_numpy())
    assert A.shape == (2, 2, 2) and (A[:, 0, 1] == 0).all()
    assert np.isfinite(post["chi"]).all()


def test_survey_twin_matches_pallas_interpret(kernel_setup):
    jspec, tspec, obs_t, obs, tf, y0 = kernel_setup
    rng = np.random.default_rng(0)
    th = (np.array([0.6, 0.1, 2.4e-8, 24.0])
          * np.exp(rng.normal(0, 0.2, (16, 4)))).astype(np.float32)
    ref = np.asarray(J.survey_fused(jspec, obs, tf, y0, th, substeps=1,
                                    tile_chains=128, interpret=True))
    got = T.survey_fused(tspec, obs_t, tf, y0, torch.as_tensor(th),
                         substeps=1).numpy()
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(got, ref, rtol=5e-5)


def _theta0(pinned, seed=3):
    rng = np.random.default_rng(seed)
    th = np.tile([0.6, 0.0 if pinned else 0.1, 2.4e-8, 24.0], (128, 1))
    return (th * np.exp(rng.normal(0, 0.03, th.shape))).astype(np.float32)


@pytest.mark.parametrize("pinned", [False, True], ids=["walked", "pinned"])
def test_mh_twin_matches_pallas_interpret(kernel_setup, pinned):
    """Equal accept sequences; with mu = [mu0, 0] and the walk mask of the
    zero-template entry 0, that entry stays exactly 0."""
    jspec, tspec, obs_t, obs, tf, y0 = kernel_setup
    th0 = _theta0(pinned)
    kw = dict(nits=14, burnin=4, substeps=1,
              walk_mask=[1.0, 0.0 if pinned else 1.0, 1.0, 1.0])
    ref = J.metropolis_hastings_fused(jspec, obs, tf, y0, th0, seed=0,
                                      tile_chains=128, interpret=True, **kw)
    got = T.metropolis_hastings_fused(tspec, obs_t, tf, y0,
                                      torch.as_tensor(th0), 0, **kw)
    assert_same_chains(got, ref)
    if pinned:
        assert (got.theta.numpy()[:, :, 1] == 0.0).all()
    else:
        assert (np.std(got.theta.numpy(), axis=(0, 1)) > 0).all()


def _fw(template, use_dist=True, **kw):
    mk = odelib_tpu_torch.parameter
    prior = (scipy.stats.lognorm, {"s": 0.5, "scale": 0.4}) if use_dist \
        else (None, None)
    return odelib_tpu_torch.ModelFramework(
        ODE=vec_model, parameter_names=PN, state_names=SN,
        dataframe=vec_df(),
        mu=mk(*prior, init_value=np.array(template), random_seed=1),
        phi=mk(scipy.stats.lognorm, {"s": 0.5, "scale": 2e-8},
               random_seed=2),
        beta=mk(scipy.stats.lognorm, {"s": 0.5, "scale": 25},
                random_seed=3),
        t_steps=288, random_seed=0, ode_style="jax", device="cpu", **kw)


def test_slot_priors_in_the_mh_twin_match_pallas_interpret(kernel_setup):
    """use_priors=True: the framework's per-slot priors (the parameter's
    on each non-zero entry, none on a zero-template one, as
    ``odelib_tpu``'s ``MCMC`` expands them) in the MH twin and in the JAX
    kernel: equal accept sequences."""
    jspec, tspec, obs_t, obs, tf, y0 = kernel_setup
    fw = _fw([0.5, 0.0])
    slots = fw._slot_priors()
    assert slots[1] is None and slots[0] == D.LogNormal(s=0.5, scale=0.4)
    assert [type(d).__name__ for d in slots] == ["LogNormal", "NoneType",
                                                 "LogNormal", "LogNormal"]
    jpri = tuple(None if d is None else JLogNormal(s=d.s, loc=d.loc,
                                                   scale=d.scale)
                 for d in slots)
    th0 = _theta0(True)
    kw = dict(nits=14, burnin=4, substeps=1, walk_mask=fw._walk_mask())
    ref = J.metropolis_hastings_fused(jspec, obs, tf, y0, th0, seed=2,
                                      tile_chains=128, interpret=True,
                                      priors=jpri, **kw)
    got = T.metropolis_hastings_fused(tspec, obs_t, tf, y0,
                                      torch.as_tensor(th0), 2, priors=slots,
                                      **kw)
    assert_same_chains(got, ref)
    assert (got.theta.numpy()[:, :, 1] == 0.0).all()
    post = fw.MCMC(chain_inits=[{"mu": np.array([0.5, 0.0]), "phi": 2.4e-8,
                                 "beta": 24.0}] * 4,
                   iterations_per_chain=12, use_priors=True, substeps=1,
                   print_report=False)
    assert (np.stack(post["mu"].to_numpy())[:, 1] == 0.0).all()


def test_array_hyperparameters_run_on_the_host_only():
    """An array hyperparameter gives each entry its own prior in the LHS;
    with use_priors=True the fit runs on the scan MH (the reference runs
    vector hyperparameters on its XLA sampler), each entry under its own
    prior."""
    d = D.from_scipy(scipy.stats.lognorm,
                     {"s": 0.5, "scale": np.array([0.6, 0.1])})
    assert isinstance(d, D.ArrayHyper) and d.shape == (2,)
    np.testing.assert_allclose(
        d.logpdf(np.array([0.5, 0.2])).numpy(),
        scipy.stats.lognorm.logpdf([0.5, 0.2], 0.5, scale=[0.6, 0.1]),
        rtol=1e-12)
    fw = odelib_tpu_torch.ModelFramework(
        ODE=vec_model, parameter_names=PN, state_names=SN,
        dataframe=vec_df(),
        mu=odelib_tpu_torch.parameter(
            scipy.stats.lognorm, {"s": 0.5, "scale": np.array([0.6, 0.1])},
            init_value=np.array([0.5, 0.12])),
        phi=2.4e-8, beta=24.0, t_steps=288, ode_style="jax", device="cpu")
    mu = np.stack(fw._lhs_samples(256)["mu"].to_numpy())
    np.testing.assert_allclose(np.median(mu, axis=0), [0.6, 0.1], rtol=0.05)
    post = fw.MCMC(chain_inits=2, iterations_per_chain=4, use_priors=True,
                   fitsurvey_samples=64, sd_fitdistance=20.0,
                   print_report=False, profile=True)
    assert "chains[xla]" in fw.last_profile
    assert np.isfinite(post["chi"]).all()


def test_lhs_draws_only_non_zero_entries():
    fw = _fw([0.5, 0.0])
    mu = np.stack(fw._lhs_samples(64)["mu"].to_numpy())
    assert mu.shape == (64, 2)
    assert (mu[:, 1] == 0.0).all() and np.std(mu[:, 0]) > 0
    # one LHS dimension per non-zero entry: mu's entry, phi, beta
    seen = []
    orig = odelib_tpu_torch.api.sample_lhs
    try:
        odelib_tpu_torch.api.sample_lhs = \
            lambda g, dists, n: seen.append(len(dists)) or orig(g, dists, n)
        fw._lhs_samples(8)
        _fw([0.5, 0.12])._lhs_samples(8)
    finally:
        odelib_tpu_torch.api.sample_lhs = orig
    assert seen == [3, 4]


def test_fit_survey_posterior_and_best_params_round_trip():
    """tests/test_array_params.py's contract: the reference's columns, a
    (2,) cell per row, both entries walked, and set_best_params pushes
    the array back."""
    fw = _fw([0.5, 0.12])
    df = fw.fit_survey(samples=64)
    assert list(df.columns) == ["mu", "phi", "beta", "chi"]
    m0 = np.stack(df["mu"].to_numpy())
    assert m0.shape == (64, 2) and (np.std(m0, axis=0) > 0).all()
    assert np.isfinite(df["chi"]).sum() > 32
    post = fw.MCMC(chain_inits=4, iterations_per_chain=30,
                   fitsurvey_samples=128, sd_fitdistance=6.0, substeps=1,
                   print_report=False)
    assert list(post.columns) == ["mu", "phi", "beta", "chi", "rsquared",
                                  "aic", "iteration", "acceptance_ratio",
                                  "chain#", "all_rejected"]
    mu = np.stack(post["mu"].to_numpy())
    assert mu.shape == (4 * 14, 2) and np.isfinite(mu).all()
    assert (np.std(mu, axis=0) > 0).all()
    fw.set_best_params(post)
    best = post.loc[post["chi"].astype(float).idxmin(), "mu"]
    np.testing.assert_array_equal(np.asarray(fw.parameters["mu"].val), best)
    assert fw._spec.pshapes == SHAPES
    med = np.median(mu, axis=0)
    assert np.all(med / TRUE_MU > 0.1) and np.all(med / TRUE_MU < 10.0)
