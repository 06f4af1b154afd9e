"""The joint kernel's chunk mode in the port: the chunked joint twin
against its whole run (bitwise, with and without priors), killed and
resumed through the public wrapper, the refused resumes (another
configuration, a file of ``odelib_tpu``), the chunked twin against
``odelib_tpu``'s chunked joint kernel in interpret mode (the joint parity
test's tolerances), and ``JointFit.MCMC``'s checkpointing and
``until_rhat``/``until_min_ess``. Chunk mode of the CUDA joint kernel on
the card: tests/test_torch_cuda.py::test_chunked_kernel_equals_whole and
test_joint_chunk_kernel_matches_chunked_twin."""
import numpy as np
import pandas as pd
import pytest
import torch

import odelib_tpu_torch
from odelib_tpu.ops.pallas_joint import \
    joint_metropolis_hastings_fused as jax_joint_fused
from odelib_tpu_torch import JointFit
from odelib_tpu_torch.distributions import LogNormal
from odelib_tpu_torch.ops import cuda_joint as TJ
from odelib_tpu_torch.ops.chunked import PACKAGE

from test_torch_joint import (_CENTRES, _JOINT_PRIORS, _fits, _host_args,
                              _zero_i_pair)
from test_torch_priors import jax_priors

_NITS, _BURNIN = 15, 4          # 14 proposals, 4 of them burn-in


def _theta0(dim, C=16, seed=5):
    rng = np.random.default_rng(seed)
    return (np.array(_CENTRES["zero_i-pair"])
            * np.exp(rng.normal(0, 0.05, (C, dim)))).astype(np.float32)


@pytest.fixture(scope="module")
def joint_runs():
    """The zero_i pair's wrapper arguments (16 chains, substeps 1) and the
    uninterrupted result, without and with in-kernel priors."""
    _, jf = _fits("zero_i-pair")
    args = (*_host_args(jf), torch.as_tensor(_theta0(jf.dim)), 4)
    out = {}
    for name, pri in (("flat", None), ("priors", _JOINT_PRIORS)):
        kw = dict(nits=_NITS, burnin=_BURNIN, rwalk_std=0.1,
                  substeps_list=[1, 1], priors=pri)
        out[name] = (args, kw, TJ.joint_metropolis_hastings_fused(*args,
                                                                   **kw))
    return out


def _assert_bitwise(a, b):
    for x, y in zip(a, b, strict=True):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(
            np.ascontiguousarray(x).view(np.uint8),
            np.ascontiguousarray(y).view(np.uint8))


@pytest.mark.parametrize("every", [1, 7, 5],
                         ids=["one", "dividing", "not-dividing"])
@pytest.mark.parametrize("prior", ["flat", "priors"])
def test_chunked_joint_twin_equals_whole(joint_runs, prior, every):
    """checkpoint_every 1, 7 (two chunks of 7) and 5 (5, 5 and 4, the
    burn-in ending inside the first): bitwise the whole run, the parts
    and the log prior carried across each boundary."""
    args, kw, whole = joint_runs[prior]
    assert 0 < float(whole.acceptance_ratio[:, -1].mean()) < 1
    _assert_bitwise(TJ.joint_metropolis_hastings_fused(
        *args, checkpoint_every=every, **kw), whole)


@pytest.mark.parametrize("prior", ["flat", "priors"])
def test_joint_kill_and_resume_equals_whole(joint_runs, prior, tmp_path):
    """A joint run killed after its first chunk (``_stop_after_chunks``)
    and resumed from its progress file, and a resume from the finished
    file: both bitwise the uninterrupted run."""
    args, kw, whole = joint_runs[prior]
    fn = TJ.joint_metropolis_hastings_fused
    path = str(tmp_path / "joint.progress")
    assert fn(*args, checkpoint_every=5, checkpoint_path=path,
              _stop_after_chunks=1, **kw) is None
    with np.load(path) as z:
        assert int(z["next_chunk"]) == 1
        assert bytes(z["sig"]).decode().startswith(f"('{PACKAGE}', 'joint'")
        # the state: D log-thetas, chi, K parts, accept count, log prior
        assert z["state"].shape == (4 + 2 + 3, 16)
    res = fn(*args, checkpoint_every=5, checkpoint_path=path,
             resume_from=path, **kw)
    _assert_bitwise(res, whole)
    with np.load(path) as z:
        assert int(z["next_chunk"]) == 3
    _assert_bitwise(fn(*args, checkpoint_every=5, resume_from=path, **kw),
                    whole)


def test_joint_resume_refuses_another_configuration(joint_runs, tmp_path):
    """A changed seed, checkpoint_every or prior fails the resume with the
    reference's ValueError; checkpoint_every 0 is refused."""
    args, kw, _ = joint_runs["flat"]
    fn = TJ.joint_metropolis_hastings_fused
    path = str(tmp_path / "joint.progress")
    fn(*args, checkpoint_every=5, checkpoint_path=path,
       _stop_after_chunks=1, **kw)
    changed = args[:-1] + (args[-1] + 1,)
    for a, every, extra in ((changed, 5, {}), (args, 4, {}),
                            (args, 5, dict(priors=_JOINT_PRIORS))):
        with pytest.raises(ValueError,
                           match="different joint MCMC configuration"):
            fn(*a, checkpoint_every=every, resume_from=path,
               **{**kw, **extra})
    with pytest.raises(ValueError, match=">= 1"):
        fn(*args, checkpoint_every=0, **kw)


def test_joint_resume_refuses_a_file_of_odelib_tpu(tmp_path):
    """A progress file written by the JAX package's chunked joint kernel
    names no port in its signature: the resume fails with the same
    ValueError."""
    ref_jf, jf = _fits("zero_i-pair")
    th0 = _theta0(jf.dim, C=4)
    kw = dict(nits=_NITS, burnin=_BURNIN, rwalk_std=0.1,
              substeps_list=[1, 1], checkpoint_every=14)
    path = str(tmp_path / "jax.progress")
    jax_joint_fused(*_host_args(ref_jf), th0, seed=4, tile_chains=128,
                    interpret=True, checkpoint_path=path, **kw)
    with np.load(path) as z:
        assert PACKAGE not in bytes(z["sig"]).decode()
    with pytest.raises(ValueError, match="different joint MCMC configuration"):
        TJ.joint_metropolis_hastings_fused(
            *_host_args(jf), torch.as_tensor(th0), 4, resume_from=path, **kw)


@pytest.mark.parametrize("prior", ["flat", "priors"])
def test_chunked_joint_matches_pallas_interpret(prior):
    """Both packages chunked (64 chains, nits 25, burn-in 6, chunks of 7,
    7, 7 and 3), two experiments, the joint parity test's walk scale 0.05:
    the accept sequences exact; theta 1e-5, chi 5e-5 where theta is
    bitwise, 1e-4 elsewhere, and the parts as tests/test_torch_joint.py
    checks them: 5e-5 where theta is bitwise without priors (its flat
    parity test), 1e-4 with them (its prior parity test; one part here
    lands 5.04e-5 off). The gap is the interpret-mode reference's XLA:CPU
    arithmetic, the same between the two packages' whole runs. The
    port's chunked run is bitwise its whole run."""
    ref_jf, jf = _fits("zero_i-pair")
    th0 = _theta0(jf.dim, C=64, seed=6)
    pri = _JOINT_PRIORS if prior == "priors" else None
    kw = dict(nits=25, burnin=6, rwalk_std=0.05, substeps_list=[1, 1])
    ref = jax_joint_fused(*_host_args(ref_jf), th0, seed=4, tile_chains=128,
                          interpret=True, checkpoint_every=7,
                          priors=None if pri is None else jax_priors(pri),
                          **kw)
    args = (*_host_args(jf), torch.as_tensor(th0), 4)
    got = TJ.joint_metropolis_hastings_fused(*args, checkpoint_every=7,
                                             priors=pri, **kw)
    _assert_bitwise(got, TJ.joint_metropolis_hastings_fused(
        *args, priors=pri, **kw))
    np.testing.assert_array_equal(got.iteration.numpy(),
                                  np.asarray(ref.iteration))
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    assert 0 < float(got.acceptance_ratio[:, -1].mean()) < 1
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               rtol=1e-5)
    same = (got.theta.numpy() == np.asarray(ref.theta)).all(-1)
    assert same.mean() > 0.4
    parts, ref_parts = got.chi_parts.numpy(), np.asarray(ref.chi_parts)
    np.testing.assert_allclose(got.chi.numpy()[same],
                               np.asarray(ref.chi)[same], rtol=5e-5)
    if pri is None:
        np.testing.assert_allclose(parts[same], ref_parts[same], rtol=5e-5)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(ref.chi),
                               rtol=1e-4)
    np.testing.assert_allclose(parts, ref_parts, rtol=1e-4)


# -- through JointFit.MCMC -------------------------------------------------

def _joint_fit():
    return JointFit(_zero_i_pair(odelib_tpu_torch, LogNormal, device="cpu"),
                    shared=["phi", "beta"], random_seed=3)


_MCMC_KW = dict(chain_inits=6, iterations_per_chain=13, burnin=4,
                fitsurvey_samples=32, substeps=1, print_report=False)


class _Killed(Exception):
    pass


@pytest.mark.parametrize("use_priors", [False, True])
def test_joint_mcmc_resume_equals_uninterrupted(use_priors, tmp_path,
                                                monkeypatch):
    """JointFit.MCMC(checkpoint_every=5, checkpoint_path=...) equals the
    plain run and writes '<checkpoint_path>.progress'; a run killed after
    its first chunk, resumed with resume_from=that file, equals it too."""
    kw = dict(_MCMC_KW, use_priors=use_priors)
    ref = _joint_fit().MCMC(**kw)
    ckpt = str(tmp_path / "joint.npz")
    pd.testing.assert_frame_equal(
        _joint_fit().MCMC(checkpoint_every=5, checkpoint_path=ckpt, **kw),
        ref)
    with np.load(ckpt + ".progress") as z:
        assert int(z["next_chunk"]) == 3
    real = TJ.joint_metropolis_hastings_fused

    def killed(*a, **k):
        if real(*a, _stop_after_chunks=1, **k) is None:
            raise _Killed
    monkeypatch.setattr(TJ, "joint_metropolis_hastings_fused", killed)
    other = str(tmp_path / "killed.npz")
    with pytest.raises(_Killed):
        _joint_fit().MCMC(checkpoint_every=5, checkpoint_path=other, **kw)
    monkeypatch.setattr(TJ, "joint_metropolis_hastings_fused", real)
    res = _joint_fit().MCMC(checkpoint_every=5, checkpoint_path=other,
                            resume_from=other + ".progress", **kw)
    pd.testing.assert_frame_equal(res, ref)


def test_joint_mcmc_resume_refuses_edited_data(tmp_path):
    """The config token (``_stable_config_token``): a resume against an
    experiment whose observations changed fails, and so does one whose
    priors changed when the run used them."""
    ckpt = str(tmp_path / "joint.npz")
    kw = dict(_MCMC_KW, checkpoint_every=5, checkpoint_path=ckpt)
    _joint_fit().MCMC(use_priors=True, **kw)
    jf = _joint_fit()
    fw = jf.frameworks["b"]
    fw._obsdata_fit_host = fw._obsdata_fit_host._replace(
        log_abundance=fw._obsdata_fit_host.log_abundance + 1e-3)
    with pytest.raises(ValueError, match="different joint MCMC"):
        jf.MCMC(resume_from=ckpt + ".progress", use_priors=True, **kw)
    jf = _joint_fit()
    assert jf._stable_config_token("fixed_dopri5", (1, 1), True) \
        == _joint_fit()._stable_config_token("fixed_dopri5", (1, 1), True)
    jf.frameworks["a"].set_parameters(mu=odelib_tpu_torch.parameter(
        stats_gen=LogNormal(s=2.0, scale=1e-8), hyperparameters={}))
    with pytest.raises(ValueError, match="different joint MCMC"):
        jf.MCMC(resume_from=ckpt + ".progress", use_priors=True, **kw)


def test_joint_mcmc_checkpoint_and_until_rules():
    """The reference's ValueErrors (odelib_tpu/joint.py:935-945,
    :1064-1071): checkpoint_every without checkpoint_path, resume_from
    without checkpoint_every, until_* with checkpointing."""
    jf = _joint_fit()
    for extra, match in (
            (dict(checkpoint_every=5), "requires checkpoint_path"),
            (dict(resume_from="x.progress"), "resume_from requires"),
            (dict(until_min_ess=10.0, checkpoint_every=5,
                  checkpoint_path="x.npz"), "cannot be combined"),
            (dict(until_rhat=1.1, resume_from="x.progress"),
             "cannot be combined")):
        with pytest.raises(ValueError, match=match):
            jf.MCMC(**_MCMC_KW, **extra)


def test_joint_mcmc_until_min_ess_extends(caplog):
    """A min-ESS target that one run misses extends it: every chain
    continues from its last state (seed + 104729 x the extension, no
    burn-in), the iteration column keeps counting, the acceptance ratio
    stays an exact global running ratio, chi stays the sum of its parts,
    and the records before the first extension are the single run's (the
    ratios widened to float64 by the stitching, as in ``odelib_tpu``).
    The target is met, or the cap's warning is given."""
    import warnings
    from odelib_tpu_torch.utils.diagnostics import effective_sample_size
    kw = dict(_MCMC_KW, iterations_per_chain=21, burnin=10)
    single = _joint_fit().MCMC(**kw)

    def min_ess(post):
        return min(effective_sample_size(np.log(np.stack(
            [g[c].to_numpy(float) for _, g in post.groupby("chain#")])))
            for c in ("phi", "beta", "a:mu", "b:mu"))
    target = 1.5 * min_ess(single)
    with caplog.at_level("INFO", logger="odelib_tpu_torch"), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        post = _joint_fit().MCMC(until_min_ess=target, max_extensions=4,
                                 **kw)
    capped = any("extension cap reached" in str(w.message) for w in caught)
    assert "extending joint run" in caplog.text
    per_chain = post[post["chain#"] == 0]
    its = per_chain["iteration"].to_numpy()
    assert len(its) > 10 and (np.diff(its) > 0).all() and its[-1] > 20
    assert (its[-1] - 20) % 20 == 0
    counts = (post["acceptance_ratio"].to_numpy(float)
              * post["iteration"].to_numpy(float))
    np.testing.assert_allclose(counts, np.round(counts), atol=1e-4)
    np.testing.assert_array_equal(
        post["chi"].to_numpy(),
        (post["chi:a"].to_numpy() + post["chi:b"].to_numpy()))
    first = post[post["iteration"] <= 20].reset_index(drop=True)
    pd.testing.assert_frame_equal(first.drop(columns="all_rejected"),
                                  single.drop(columns="all_rejected"),
                                  check_dtype=False)
    assert min_ess(post) >= target or (capped and len(its) == 10 + 4 * 20)


def test_joint_mcmc_until_warns_at_the_cap():
    """A target no run meets: the run extends max_extensions times and
    warns; the posterior holds every record."""
    with pytest.warns(UserWarning, match="extension cap reached"):
        post = _joint_fit().MCMC(until_rhat=0.5, max_extensions=2,
                                 **_MCMC_KW)
    assert len(post) == 6 * (8 + 2 * 12)
    assert post["iteration"].max() == 12 + 2 * 12
