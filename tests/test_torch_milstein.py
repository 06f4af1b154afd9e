"""PMMH's Milstein step in the port: the diffusion's diagonal derivative
from the RHS front end (``RhsProgram.diagonal``) against ``jax.jvp``'s
one-hot columns of the reference diffusion in float64; ``pmmh_plain`` with
Milstein against ``odelib_tpu``'s Pallas kernel in interpret mode (the
GBM, a two-state SDE and one whose diffusion couples the states); the
draws it shares with Euler; its chunked runs; and
``MCMC(sampler='pmmh', sde_method='milstein')``. The Milstein ``pf_kernel``
against its twin on the card: tests/test_torch_cuda.py::
test_pf_kernel_milstein_matches_twin."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odelib_tpu
import odelib_tpu_torch
from odelib_tpu import distributions as JD
from odelib_tpu.model import make_spec
from odelib_tpu_torch import distributions as TD
from odelib_tpu_torch import dispatch as t_dispatch
from odelib_tpu_torch.model import make_spec as t_make_spec
from odelib_tpu_torch.model import obsdata_from_arrays
from odelib_tpu_torch.ops import build
from odelib_tpu_torch.ops import cuda_mh as T
from odelib_tpu_torch.ops import cuda_pf as TP
from odelib_tpu_torch.rhs import adapt_rhs, trace_rhs

from test_torch_pf import (MU, SIG, _case, _gbm_framework, _gbm_noise,
                           _pair, jax_pmmh_fused)


def _coupled_noise(t, y, ps):
    """A diffusion whose every entry reads both states."""
    return jnp.stack([SIG * y[0] * jnp.sqrt(y[1]),
                      0.2 * y[1] + 0.05 * y[0] * y[1] / (1.0 + y[0])])


def _additive_noise(t, y, ps):
    """Additive noise: d g_s / d y_s = 0, so Milstein's term vanishes."""
    return jnp.stack([0.0 * y[0] + 0.1])


def _milstein_case(name):
    """``test_torch_pf._case``'s inputs; 'coupled' is its two-state SDE
    with :func:`_coupled_noise`."""
    if name != "coupled":
        return _case(name)
    _, _, obs, times, y0, th0 = _case("pair")
    pn, sn = ("mu", "B0"), ("A", "B")
    return (make_spec(_pair, pn, sn, diffusion=_coupled_noise),
            t_make_spec(adapt_rhs(_pair), pn, sn,
                        diffusion=adapt_rhs(_coupled_noise)),
            obs, times, y0, th0)


@pytest.mark.parametrize("noise,S,P", [(_gbm_noise, 1, 1),
                                       (_coupled_noise, 2, 2)],
                         ids=["gbm", "coupled"])
def test_diffusion_diag_matches_jax_jvp(noise, S, P):
    """d g_s / d y_s from the traced program's forward-mode sweep, in
    float64, against the s-th entry of jax.jvp along the one-hot tangent
    of state s (the JAX kernel's columns): within 1e-12 relative."""
    rng = np.random.default_rng(4)
    y = np.exp(rng.normal(0.0, 0.5, (S, 64)))
    ps = np.exp(rng.normal(np.log(MU), 0.2, (P, 64)))
    want = []
    for s in range(S):
        tang = jnp.asarray(np.eye(S)[:, s:s + 1] * np.ones((S, 64)))
        _, jv = jax.jvp(lambda yy: noise(0.0, yy, list(jnp.asarray(ps))),
                        (jnp.asarray(y),), (tang,))
        want.append(np.asarray(jv)[s])
    prog = trace_rhs(adapt_rhs(noise), S, P)
    got = prog.diagonal().evaluate(
        0.0, [torch.as_tensor(v) for v in y],
        [torch.as_tensor(v) for v in ps])
    for s in range(S):
        np.testing.assert_allclose(got[s].numpy(), want[s], rtol=1e-12,
                                   atol=1e-300)
    assert prog.diagonal() is prog.diagonal()   # cached


def test_milstein_header_only_in_its_library():
    """diffusion_diag() and ODE_MILSTEIN enter only the Milstein library's
    header; the Euler library's header is the one it was."""
    _, tspec, *_ = _milstein_case("coupled")
    prog, g = (trace_rhs(f, 2, 2) for f in (tspec.rhs, tspec.diffusion))
    sc = [("lognormal", None, False, False)]
    euler = build.generated_header(prog, g, (), sc)
    mil = build.generated_header(prog, g, (), sc, milstein=True)
    assert "diffusion_diag" not in euler and "ODE_MILSTEIN" not in euler
    assert mil.startswith(euler)
    assert "#define ODE_MILSTEIN 1" in mil
    assert "void diffusion_diag(float t" in mil
    assert mil.count("dy[") == euler.count("dy[") + 2


_CASES = [("gbm", 8, True), ("pair", 16, False), ("coupled", 8, False),
          ("gbm", 128, False)]


@pytest.mark.parametrize("name,K,prior", _CASES,
                         ids=[f"{n}-K{k}-{'prior' if p else 'flat'}"
                              for n, k, p in _CASES])
def test_milstein_twin_matches_pallas_interpret(name, K, prior):
    """tests/test_torch_pf.py's parity runs (128 chains, 40 steps, 6
    proposals) with sde_method='milstein' in both packages: accept
    sequences exact, chi within 5e-6 relative; and a different filter
    from Euler's."""
    spec, tspec, obs, times, y0, th0 = _milstein_case(name)
    pri = tpri = None
    if prior:
        pri = (JD.LogNormal(s=0.5, loc=0.0, scale=MU),)
        tpri = (TD.LogNormal(s=0.5, loc=0.0, scale=MU),)
    kw = dict(nits=7, burnin=3, rwalk_std=0.3, n_particles=K, substeps=1,
              adapt_proposal=prior, adapt_rate=0.15, target_accept=0.3,
              sde_method="milstein")
    ref = jax_pmmh_fused(spec, obs, times, y0.astype(np.float32), th0,
                         seed=3, priors=pri, interpret=True, **kw)
    args = (tspec, obsdata_from_arrays(obs), times, y0, torch.as_tensor(th0),
            3)
    got = TP.pmmh_fused(*args, priors=tpri, **kw)
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    assert 0 < float(got.acceptance_ratio[:, -1].mean()) < 1
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               rtol=1e-6)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(ref.chi),
                               rtol=5e-6)
    euler = TP.pmmh_fused(*args, priors=tpri,
                          **{**kw, "sde_method": "euler"})
    assert (euler.chi != got.chi).any()


def test_euler_and_milstein_consume_the_same_slots():
    """The Milstein step adds no draw: both filters end at the same slot
    of the iteration's counter (the stride stays Euler's), and under
    additive noise (d g / d y = 0, the correction exactly 0) the Milstein
    run is bitwise the Euler run."""
    _, tspec, obs, times, y0, th0 = _milstein_case("coupled")
    plan = T._build_plan(tspec, obsdata_from_arrays(obs), times, 1)
    key0, keys = TP.pf_keys(3, 8, torch.arange(16))
    theta = list(torch.as_tensor(th0[:16]).t())
    ends = [TP._Filter(tspec, plan, y0, 8, keys, key0, m).run(theta, 64, 3)
            for m in (False, True)]
    assert ends[0][1] == ends[1][1]
    assert (ends[0][0] != ends[1][0]).any()
    _, gspec, gobs, gtimes, gy0, gth0 = _case("gbm")
    add = t_make_spec(gspec.rhs, ("mu",), ("N",),
                      diffusion=adapt_rhs(_additive_noise))
    args = (add, obsdata_from_arrays(gobs), gtimes, gy0,
            torch.as_tensor(gth0[:32]), 5)
    kw = dict(nits=6, burnin=2, rwalk_std=0.3, n_particles=8, substeps=2)
    a, b = (TP.pmmh_fused(*args, sde_method=m, **kw)
            for m in ("euler", "milstein"))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.fixture(scope="module")
def milstein_run():
    _, tspec, obs, times, y0, th0 = _milstein_case("coupled")
    args = (tspec, obsdata_from_arrays(obs), times, y0,
            torch.as_tensor(th0[:16]), 3)
    kw = dict(nits=13, burnin=6, rwalk_std=0.3, n_particles=8, substeps=1,
              adapt_proposal=True, adapt_rate=0.15, sde_method="milstein")
    return args, kw, TP.pmmh_fused(*args, **kw)


@pytest.mark.parametrize("every", [1, 5])
def test_chunked_milstein_twin_equals_whole(milstein_run, every, tmp_path):
    """Chunks of 1 and of 5 (5, 5 and 2; the scale adapting across the
    first boundary), and a run killed after its first chunk and resumed:
    bitwise the whole Milstein run."""
    args, kw, whole = milstein_run
    got = TP.pmmh_fused(*args, checkpoint_every=every, **kw)
    path = str(tmp_path / "m.progress")
    assert TP.pmmh_fused(*args, checkpoint_every=every, checkpoint_path=path,
                         _stop_after_chunks=1, **kw) is None
    res = TP.pmmh_fused(*args, checkpoint_every=every, checkpoint_path=path,
                        resume_from=path, **kw)
    for x, y, z in zip(whole, got, res):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
        np.testing.assert_array_equal(x.numpy(), z.numpy())


def test_resume_refuses_the_other_sde_method(milstein_run, tmp_path):
    """sde_method is in the chunk signature (pallas_pf.py:609): an Euler
    run does not resume a Milstein file."""
    args, kw, _ = milstein_run
    path = str(tmp_path / "m.progress")
    TP.pmmh_fused(*args, checkpoint_every=5, checkpoint_path=path,
                  _stop_after_chunks=1, **kw)
    with pytest.raises(ValueError, match="different PMMH configuration"):
        TP.pmmh_fused(*args, checkpoint_every=5, resume_from=path,
                      **{**kw, "sde_method": "euler"})


def test_mcmc_pmmh_milstein(monkeypatch):
    """MCMC(sampler='pmmh', sde_method='milstein') runs the Milstein
    filter (the dispatched run equals pmmh_fused with Milstein on the
    same chains) and returns the reference's posterior columns and
    dtypes, odelib_tpu's MCMC with the same arguments in interpret mode
    giving the frame it is held to."""
    fw = _gbm_framework(odelib_tpu_torch, device="cpu")
    ref_fw = _gbm_framework(odelib_tpu)
    draws = fw._lhs_samples(32)
    monkeypatch.setattr(ref_fw, "_lhs_samples", lambda samples: draws)
    kw = dict(chain_inits=4, iterations_per_chain=9, burnin=3,
              fitsurvey_samples=32, sampler="pmmh", n_particles=8,
              sde_substeps=5, rwalk_std=0.3, use_priors=True,
              adapt_rate=0.15, print_report=False, sde_method="milstein")
    seen = {}

    def capture(fw_, theta0, cfg):
        seen["theta0"], seen["cfg"] = np.asarray(theta0), cfg
        return t_dispatch.run_pmmh(fw_, theta0, cfg)
    monkeypatch.setitem(t_dispatch._ARMS, "cpu:pmmh", capture)
    got = fw.MCMC(**kw)
    assert seen["cfg"].sde_method == "milstein"
    direct = TP.pmmh_fused(
        fw._spec, fw._obsdata_fit_host, fw._times_fit, fw.get_inits(),
        torch.as_tensor(seen["theta0"]), int(fw.random_seed), nits=9,
        burnin=3, walk_mask=seen["cfg"].mask, rwalk_std=0.3, n_particles=8,
        substeps=5, priors=seen["cfg"].priors, adapt_proposal=True,
        adapt_rate=0.15, sde_method="milstein")
    np.testing.assert_array_equal(got["chi"].to_numpy(),
                                  direct.chi.numpy().ravel())
    euler = fw.MCMC(**{**kw, "sde_method": "euler"})
    assert (euler["chi"].to_numpy() != got["chi"].to_numpy()).any()
    ref = ref_fw.MCMC(backend="pallas", pallas_interpret=True, **kw)
    assert list(got.columns) == list(ref.columns)
    assert len(got) == len(ref) == 4 * 5
    for col in ref.columns:
        assert got[col].dtype == ref[col].dtype, col
    assert got["rsquared"].isna().all()
    assert np.isfinite(got["chi"]).all()
    np.testing.assert_array_equal(got["iteration"].to_numpy(),
                                  ref["iteration"].to_numpy())
