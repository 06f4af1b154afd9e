"""Chunked checkpointing, bit-exact resume and run-length extension in the
port: the chunked twins of the MH, ensemble, PT and PMMH kernels against
their whole runs (bitwise) and against ``odelib_tpu``'s chunked kernels
in interpret mode (the parity tests' tolerances), kill and resume through
the public wrappers and through ``ModelFramework.MCMC``, the refused
resumes, and ``until_rhat``/``until_min_ess`` (the reference's test on a
CPU framework). Chunk mode of the CUDA kernels on the card:
tests/test_torch_cuda.py::test_chunked_kernel_equals_whole."""
import numpy as np
import pandas as pd
import pytest
import scipy.stats
import torch

import odelib_tpu_torch
from odelib_tpu.ops import pallas_mh as J
from odelib_tpu.ops import pallas_pt as JPT
from odelib_tpu.ops.pallas_pf import pmmh_fused as jax_pmmh_fused
from odelib_tpu_torch.ops import cuda_mh as T
from odelib_tpu_torch.ops import cuda_pf as TPF
from odelib_tpu_torch.ops import cuda_pt as TPT
from odelib_tpu_torch.ops.chunked import PACKAGE

import test_torch_pf as PF
from test_torch_api import _INITS, _framework
from test_torch_survey import setup  # noqa: F401  (module fixture)

SAMPLERS = ("mh", "ensemble", "pt", "pmmh")
_NITS, _BURNIN = 13, 4          # 12 proposals, 4 of them burn-in


def _theta0(C, seed=3):
    rng = np.random.default_rng(seed)
    return (np.array([0.6, 2.4e-8, 24.0])
            * np.exp(rng.normal(0, 0.05, (C, 3)))).astype(np.float32)


@pytest.fixture(scope="module")
def runs(setup):  # noqa: F811
    """Per sampler: its public wrapper, the positional arguments and the
    keywords of a small CPU run (MH and PT on 8 chains, the ensemble's 200
    walkers padded to 256, PMMH on 16 chains x 8 particles adapting for
    its 6 burn-in proposals), and its uninterrupted result."""
    _, tspec, obs_fit, times_fit, y0 = setup
    obs = T.obsdata_from_arrays(obs_fit)
    base = (tspec, obs, times_fit, y0)
    th8 = torch.as_tensor(_theta0(8))
    kw = dict(nits=_NITS, burnin=_BURNIN, substeps=1)
    _, psp, pobs, ptm, py0, pth = PF._case("gbm")
    cases = {
        "mh": (T.metropolis_hastings_fused, base + (th8, 5), kw),
        "ensemble": (T.ensemble_fused,
                     base + (torch.as_tensor(_theta0(200)), 5),
                     dict(kw, tile_chains=256)),
        "pt": (TPT.parallel_tempering_fused, base + (th8, 5),
               dict(kw, temperatures=(1.0, 2.0, 4.0), swap_every=2)),
        "pmmh": (TPF.pmmh_fused,
                 (psp, T.obsdata_from_arrays(pobs), ptm, py0,
                  torch.as_tensor(pth[:16]), 3),
                 dict(nits=_NITS, burnin=6, rwalk_std=0.3, n_particles=8,
                      substeps=1, adapt_proposal=True, adapt_rate=0.15))}
    return {s: (fn, args, kw, fn(*args, **kw))
            for s, (fn, args, kw) in cases.items()}


def _arrays(res):
    """Every array of a wrapper's result (PT: the records, the swap rate)."""
    parts = (res,) if hasattr(res, "_fields") else res
    return [np.asarray(v) for p in parts
            for v in (p if hasattr(p, "_fields") else (p,))]


def _assert_bitwise(a, b):
    for x, y in zip(_arrays(a), _arrays(b), strict=True):
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(
            np.ascontiguousarray(x).view(np.uint8),
            np.ascontiguousarray(y).view(np.uint8))


@pytest.mark.parametrize("every", [5, 1, 12, 20],
                         ids=["not-dividing", "one", "whole", "beyond"])
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_chunked_twin_equals_whole(runs, sampler, every):
    """checkpoint_every 5 (chunks of 5, 5 and 2, PMMH's burn-in across a
    boundary), 1, 12 (one chunk) and 20 (beyond the run): bitwise."""
    fn, args, kw, whole = runs[sampler]
    _assert_bitwise(fn(*args, checkpoint_every=every, **kw), whole)


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_kill_and_resume_equals_whole(runs, sampler, tmp_path):
    """A run killed after its first chunk (``_stop_after_chunks``) and
    resumed from its progress file, and a resume from the finished file:
    both bitwise the uninterrupted run."""
    fn, args, kw, whole = runs[sampler]
    path = str(tmp_path / "run.progress")
    assert fn(*args, checkpoint_every=5, checkpoint_path=path,
              _stop_after_chunks=1, **kw) is None
    with np.load(path) as z:
        assert int(z["next_chunk"]) == 1
        assert bytes(z["sig"]).decode().startswith(f"('{PACKAGE}'")
    res = fn(*args, checkpoint_every=5, checkpoint_path=path,
             resume_from=path, **kw)
    _assert_bitwise(res, whole)
    with np.load(path) as z:
        assert int(z["next_chunk"]) == 3
    _assert_bitwise(fn(*args, checkpoint_every=5, resume_from=path, **kw),
                    whole)


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_resume_refuses_another_configuration(runs, sampler, tmp_path):
    """A changed seed or checkpoint_every fails the resume with the
    reference's ValueError; checkpoint_every 0 is refused."""
    fn, args, kw, _ = runs[sampler]
    path = str(tmp_path / "run.progress")
    fn(*args, checkpoint_every=5, checkpoint_path=path,
       _stop_after_chunks=1, **kw)
    what = "PMMH" if sampler == "pmmh" else "MCMC"
    changed = args[:-1] + (args[-1] + 1,)
    for a, every in ((changed, 5), (args, 4)):
        with pytest.raises(ValueError,
                           match=f"different {what} configuration"):
            fn(*a, checkpoint_every=every, resume_from=path, **kw)
    with pytest.raises(ValueError, match=">= 1"):
        fn(*args, checkpoint_every=0, **kw)


def test_resume_refuses_a_file_of_odelib_tpu(setup, tmp_path):  # noqa: F811
    """A progress file written by the JAX package names no port in its
    signature: the resume fails with the same ValueError."""
    spec, tspec, obs_fit, times_fit, y0 = setup
    path = str(tmp_path / "jax.progress")
    th0 = _theta0(4)
    kw = dict(nits=_NITS, burnin=_BURNIN, substeps=1)
    J.metropolis_hastings_fused(spec, obs_fit, times_fit, y0, th0, seed=5,
                                tile_chains=128, interpret=True,
                                checkpoint_every=12, checkpoint_path=path,
                                **kw)
    with pytest.raises(ValueError, match="different MCMC configuration"):
        T.metropolis_hastings_fused(tspec, T.obsdata_from_arrays(obs_fit),
                                    times_fit, y0, torch.as_tensor(th0), 5,
                                    checkpoint_every=12, resume_from=path,
                                    **kw)


# -- against odelib_tpu's chunked kernels in interpret mode ---------------

def test_chunked_mh_matches_pallas_interpret(setup, tmp_path):  # noqa: F811
    """tests/test_pallas_mh.py's chunked case: 4 chains, nits 25, burn-in
    6, substeps 1, chunks of 7; both packages chunked, each bitwise its
    own whole run. Accept sequences exact, theta rtol 1e-5, chi 5e-5 (the
    MH parity test's, tests/test_torch_mh.py)."""
    spec, tspec, obs_fit, times_fit, y0 = setup
    th0 = np.tile([0.6, 2.4e-8, 24.0], (4, 1)).astype(np.float32)
    kw = dict(nits=25, burnin=6, substeps=1)
    ref = J.metropolis_hastings_fused(
        spec, obs_fit, times_fit, y0, th0, seed=3, tile_chains=128,
        interpret=True, checkpoint_every=7,
        checkpoint_path=str(tmp_path / "jax.npz"), **kw)
    obs_t, th_t, seed, y0_t = T.inputs_from_reference(obs_fit, th0, 3, y0)
    got = T.metropolis_hastings_fused(
        tspec, obs_t, times_fit, y0_t, th_t, seed, checkpoint_every=7,
        checkpoint_path=str(tmp_path / "port.progress"), **kw)
    _assert_bitwise(got, T.metropolis_hastings_fused(
        tspec, obs_t, times_fit, y0_t, th_t, seed, **kw))
    np.testing.assert_array_equal(got.iteration.numpy(),
                                  np.asarray(ref.iteration))
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    assert 0 < float(got.acceptance_ratio[:, -1].mean()) < 1
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               rtol=1e-5)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(ref.chi),
                               rtol=5e-5)


def test_chunked_ensemble_matches_pallas_interpret(setup):  # noqa: F811
    """tests/test_torch_ensemble.py's one-ensemble case (256 walkers,
    nits 24, burn-in 12, substeps 2, seed 7) in chunks of 12 and 11:
    accept sequences exact, the grown ulps' theta and R^2 5e-5, chi and
    AIC 1e-3."""
    spec, tspec, obs_fit, times_fit, y0 = setup
    th0 = _theta0(256)
    kw = dict(nits=24, burnin=12, substeps=2, tile_chains=256,
              checkpoint_every=12)
    ref = J.ensemble_fused(spec, obs_fit, times_fit, y0, th0, seed=7,
                           interpret=True, **kw)
    obs_t, th_t, seed, y0_t = T.inputs_from_reference(obs_fit, th0, 7, y0)
    got = T.ensemble_fused(tspec, obs_t, times_fit, y0_t, th_t, seed, **kw)
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    for name, rtol in (("theta", 5e-5), ("rsquared", 5e-5), ("chi", 1e-3),
                       ("aic", 1e-3)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=rtol, err_msg=name)


def test_chunked_pt_matches_pallas_interpret(setup):  # noqa: F811
    """tests/test_torch_pt.py's swap-every-2 case with a static slot (128
    chains, temperatures 1, 2, 4, nits 24, burn-in 12, substeps 2) in
    chunks of 12 and 11: the swap parity follows the global iteration.
    Accept sequences and swap rates exact, theta 1e-5, chi 5e-5."""
    spec, tspec, obs_fit, times_fit, y0 = setup
    th0 = _theta0(128)
    kw = dict(temperatures=(1.0, 2.0, 4.0), swap_every=2, nits=24,
              burnin=12, walk_mask=[1, 0, 1], substeps=2,
              checkpoint_every=12)
    ref, ref_rate = JPT.parallel_tempering_fused(
        spec, obs_fit, times_fit, y0, th0, seed=7, tile_chains=128,
        interpret=True, **kw)
    obs_t, th_t, seed, y0_t = T.inputs_from_reference(obs_fit, th0, 7, y0)
    got, rate = TPT.parallel_tempering_fused(tspec, obs_t, times_fit, y0_t,
                                             th_t, seed, **kw)
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    np.testing.assert_array_equal(rate.numpy(), np.asarray(ref_rate))
    assert 0 < float(rate.mean()) <= 1
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               rtol=1e-5)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(ref.chi),
                               rtol=5e-5)


def test_chunked_pmmh_matches_pallas_interpret():
    """tests/test_torch_pf.py's GBM case with a prior and adaptation (128
    chains, 16 particles, nits 7, burn-in 3) in chunks of 4 and 2: the
    scale adapts across the boundary. Accept sequences exact, theta 1e-6,
    chi 5e-6."""
    from odelib_tpu import distributions as JD
    from odelib_tpu_torch import distributions as TD
    spec, tspec, obs, times, y0, th0 = PF._case("gbm")
    kw = dict(nits=7, burnin=3, rwalk_std=0.3, n_particles=16, substeps=1,
              adapt_proposal=True, adapt_rate=0.15, target_accept=0.3,
              checkpoint_every=4)
    ref = jax_pmmh_fused(spec, obs, times, y0.astype(np.float32), th0,
                         seed=3, priors=(JD.LogNormal(s=0.5, loc=0.0,
                                                      scale=PF.MU),),
                         interpret=True, **kw)
    got = TPF.pmmh_fused(tspec, T.obsdata_from_arrays(obs), times, y0,
                         torch.as_tensor(th0), 3,
                         priors=(TD.LogNormal(s=0.5, loc=0.0, scale=PF.MU),),
                         **kw)
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    assert 0 < float(got.acceptance_ratio[:, -1].mean()) < 1
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               rtol=1e-6)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(ref.chi),
                               rtol=5e-6)


# -- through ModelFramework.MCMC ------------------------------------------

_WRAPPERS = {"mh": (T, "metropolis_hastings_fused"),
             "ensemble": (T, "ensemble_fused"),
             "pt": (TPT, "parallel_tempering_fused"),
             "pmmh": (TPF, "pmmh_fused")}


class _Killed(Exception):
    pass


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_mcmc_resume_equals_uninterrupted(sampler, tmp_path, monkeypatch):
    """MCMC(checkpoint_every=5, checkpoint_path=...) equals the plain run;
    a run killed after its first chunk, resumed with resume_from=
    '<checkpoint_path>.progress', equals it too (assert_frame_equal), and
    the posterior file loads back to it."""
    from odelib_tpu_torch.utils.checkpoint import load_posterior
    if sampler == "pmmh":
        fw = PF._gbm_framework(odelib_tpu_torch, device="cpu")
        kw = dict(chain_inits=[{"mu": 0.3}, {"mu": 0.4}, {"mu": 0.5}],
                  n_particles=8, sde_substeps=4)
    else:
        fw = _framework(odelib_tpu_torch, device="cpu")
        kw = dict(chain_inits=_INITS)
        if sampler == "ensemble":
            kw.update(backend="pallas", pallas_tile_chains=256)
    kw.update(sampler=sampler, iterations_per_chain=13, burnin=4,
              print_report=False)
    ref = fw.MCMC(**kw)
    ckpt = str(tmp_path / "post.npz")
    pd.testing.assert_frame_equal(
        fw.MCMC(checkpoint_every=5, checkpoint_path=ckpt, **kw), ref)
    pd.testing.assert_frame_equal(load_posterior(ckpt), ref)

    mod, name = _WRAPPERS[sampler]
    real = getattr(mod, name)

    def killed(*a, **k):
        if real(*a, _stop_after_chunks=1, **k) is None:
            raise _Killed
    monkeypatch.setattr(mod, name, killed)
    other = str(tmp_path / "killed.npz")
    with pytest.raises(_Killed):
        fw.MCMC(checkpoint_every=5, checkpoint_path=other, **kw)
    monkeypatch.setattr(mod, name, real)
    res = fw.MCMC(checkpoint_every=5, checkpoint_path=other,
                  resume_from=other + ".progress", **kw)
    pd.testing.assert_frame_equal(res, ref)


def test_mcmc_checkpoint_rules():
    """The reference's ValueErrors: resume_from without checkpoint_every,
    checkpoint_every without checkpoint_path."""
    fw = _framework(odelib_tpu_torch, device="cpu")
    kw = dict(chain_inits=_INITS, iterations_per_chain=6,
              print_report=False)
    with pytest.raises(ValueError, match="resume_from requires"):
        fw.MCMC(resume_from="run.progress", **kw)
    with pytest.raises(ValueError, match="requires checkpoint_path"):
        fw.MCMC(checkpoint_every=2, **kw)


def test_mcmc_resume_refuses_edited_data(tmp_path):
    """The config token: a resume against a framework whose observations
    changed fails the resume."""
    fw = _framework(odelib_tpu_torch, device="cpu")
    kw = dict(chain_inits=_INITS, iterations_per_chain=9,
              print_report=False, checkpoint_every=4)
    ckpt = str(tmp_path / "post.npz")
    fw.MCMC(checkpoint_path=ckpt, **kw)
    fw._obsdata_fit_host = fw._obsdata_fit_host._replace(
        log_abundance=fw._obsdata_fit_host.log_abundance + 1e-3)
    with pytest.raises(ValueError, match="different MCMC configuration"):
        fw.MCMC(checkpoint_path=ckpt, resume_from=ckpt + ".progress", **kw)


# -- until_rhat / until_min_ess -------------------------------------------

def _decay_framework():
    """tests/test_api.py's one-parameter decay model and data."""
    rng = np.random.default_rng(0)
    sig = 0.15
    df = pd.DataFrame(
        [{"organism": "y", "time": t,
          "abundance": 1e6 * np.exp(-t) * np.exp(rng.normal(0, sig)),
          "log_sigma": sig} for t in np.linspace(0.0, 3.0, 12)])

    def rhs(t, y, ps):
        (k,) = ps
        return [-k * y[0]]

    return odelib_tpu_torch.ModelFramework(
        ODE=rhs, parameter_names=["k"], state_names=["y"], dataframe=df,
        t_steps=32, random_seed=0, device="cpu",
        k=odelib_tpu_torch.parameter(
            stats_gen=scipy.stats.lognorm, hyperparameters={"s": 0.3,
                                                            "scale": 1.0},
            random_seed=0))


def test_mcmc_until_converged_extends_run(caplog):
    """tests/test_api.py's test on a CPU framework: a min-ESS target that
    one 100-iteration run of 4 chains misses extends the run; the
    iteration column keeps counting, the acceptance ratio stays an exact
    global running ratio, and the target is met."""
    from odelib_tpu_torch.utils.diagnostics import effective_sample_size
    fw = _decay_framework()
    inits = pd.DataFrame([{"k": v} for v in (0.7, 0.9, 1.1, 1.3)])
    with caplog.at_level("INFO", logger="odelib_tpu_torch"):
        post = fw.MCMC(chain_inits=inits, iterations_per_chain=100,
                       rwalk_std=0.05, print_report=False,
                       until_min_ess=150.0, max_extensions=10)
    assert "extending run" in caplog.text
    per_chain = post[post["chain#"] == 0]
    assert len(per_chain) > 49          # extended beyond records 51..99
    its = per_chain["iteration"].to_numpy()
    assert (np.diff(its) > 0).all()
    assert its.max() > 99
    ar = per_chain["acceptance_ratio"].to_numpy(float)
    assert np.isfinite(ar).all() and (ar <= 1.0).all()
    counts = ar * its
    np.testing.assert_allclose(counts, np.round(counts), atol=1e-5)
    z = np.log(np.stack([post[post["chain#"] == c]["k"].to_numpy(float)
                         for c in range(4)]))
    assert effective_sample_size(z) >= 150.0


def test_mcmc_until_warns_at_the_cap():
    """A target no run meets: the run extends max_extensions times and
    warns; the posterior holds every record."""
    fw = _decay_framework()
    inits = pd.DataFrame([{"k": v} for v in (0.7, 0.9)])
    with pytest.warns(UserWarning, match="extension cap reached"):
        post = fw.MCMC(chain_inits=inits, iterations_per_chain=20,
                       print_report=False, until_rhat=0.5, max_extensions=2)
    assert len(post) == 2 * (9 + 2 * 19)
    assert post["iteration"].max() == 19 + 2 * 19


def test_mcmc_until_rejects_bad_combinations():
    """tests/test_api.py's rejection cases: another sampler, and
    checkpointing."""
    fw = _framework(odelib_tpu_torch, device="cpu")
    inits = pd.DataFrame([{"mu": 0.6, "phi": 2.4e-8, "beta": 24.0}] * 2)
    for sampler in ("hmc", "pt"):
        with pytest.raises(ValueError, match="until_rhat/until_min_ess"):
            fw.MCMC(chain_inits=inits, iterations_per_chain=20,
                    sampler=sampler, until_rhat=1.01, print_report=False)
    with pytest.raises(ValueError, match="checkpoint"):
        fw.MCMC(chain_inits=inits, iterations_per_chain=20,
                until_rhat=1.01, checkpoint_every=5,
                checkpoint_path="x.npz", print_report=False)
