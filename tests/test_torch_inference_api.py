"""The inference methods through the user API against odelib_tpu's on the
CPU (x64): ``fit_map``, ``laplace_approximation``, ``fit_advi`` and
``model_evidence`` of ``ModelFramework``, and ``JointFit.fit_map`` and
``fit_advi`` with and without hierarchical pooling. The two packages'
LHS draws differ on purpose, so the port's framework is handed the
reference's LHS frame (``_lhs_samples``, or ``sample_lhs`` for the joint
fits): from the same starts the frames agree value for value (1e-8
relative; ``converged`` equal), Laplace's covariance within 1e-7 of
``jax.hessian``'s, ADVI's ``khat`` within 1e-6, SMC's schedule within
1e-12 and its acceptances equal. On a ``diffusion=`` model every method
refuses with the reference's message and, with ``drift_only=True``, warns
with it; the other refusals are the reference's too."""
import warnings

import numpy as np
import pandas as pd
import pytest
import scipy.stats

import odelib_tpu
import odelib_tpu_torch

from helpers import demo_df, zero_i
from test_torch_hmc_api import both, framework

RTOL = 1e-8


def pin_lhs(ref_fw, fw):
    """The port's framework draws the reference's LHS frames."""
    fw._lhs_samples = ref_fw._lhs_samples


def assert_same_frame(got, ref, exact=("converged",)):
    assert list(got.columns) == list(ref.columns)
    assert len(got) == len(ref)
    for c in ref.columns:
        a, b = got[c].to_numpy(), ref[c].to_numpy()
        if c in exact:
            np.testing.assert_array_equal(a, b, err_msg=c)
        else:
            a, b = a.astype(float), b.astype(float)
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                          err_msg=c)
            np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=c)


def assert_same_params(got_fw, ref_fw):
    for p in ref_fw.get_pnames():
        np.testing.assert_allclose(got_fw.parameters[p].val,
                                   ref_fw.parameters[p].val, rtol=RTOL,
                                   err_msg=p)


def test_fit_map_matches_reference():
    """MAP with a static parameter under rk4 (the unpinned, maximum
    likelihood and fixed-Dopri5 forms are tests/test_torch_optimize.py's)."""
    kw = dict(starts=4, steps=10, use_priors=True, static_parameters=["mu"],
              method="rk4")
    ref_fw, fw = both()
    pin_lhs(ref_fw, fw)
    ref = ref_fw.fit_map(**kw)
    got = fw.fit_map(**kw)
    assert list(got.columns) == ["mu", "phi", "beta", "chi", "loss",
                                 "converged"]
    assert_same_frame(got, ref)
    assert_same_params(fw, ref_fw)          # set_best pushed the winner
    assert np.isfinite(got.chi.iloc[0])


def test_laplace_matches_jax_hessian():
    """Near the fit, with the priors (an rk4 framework: Laplace still
    solves fixed Dopri5)."""
    use_priors = True
    ref_fw = framework(odelib_tpu, method="rk4")
    fw = framework(odelib_tpu_torch, device="cpu", method="rk4")
    pt = [0.62, 2.3e-8, 25.0]
    ref = ref_fw.laplace_approximation(parameters=pt, use_priors=use_priors)
    got = fw.laplace_approximation(parameters=pt, use_priors=use_priors)
    assert got["hessian_pd"] == ref["hessian_pd"]
    assert list(got["cov"].columns) == ["mu", "phi", "beta"]
    np.testing.assert_allclose(got["cov"].to_numpy(), ref["cov"].to_numpy(),
                               rtol=1e-7)
    np.testing.assert_allclose(got["corr"].to_numpy(),
                               ref["corr"].to_numpy(), rtol=1e-7)
    for k in ("median", "log_std"):
        assert list(got[k]) == list(ref[k])
        np.testing.assert_allclose(list(got[k].values()),
                                   list(ref[k].values()), rtol=1e-7)


def test_fit_advi_matches_reference(capsys):
    """Full rank with the priors, rows importance-resampled (mean field
    is tests/test_torch_advi.py's)."""
    ref_fw, fw = both()
    run = dict(steps=10, n_mc=4, draws=120, rank="full", resample=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # unconverged at 10 steps
        ref = ref_fw.fit_advi(**run)
        ref_out = capsys.readouterr().out
        got = fw.fit_advi(**run)
    got_out = capsys.readouterr().out
    assert got_out == ref_out               # the printed report
    assert list(got.columns) == ["mu", "phi", "beta", "chi", "rsquared",
                                 "aic"]
    assert_same_frame(got, ref)
    a, b = got.attrs["advi"], ref.attrs["advi"]
    assert a["converged"] == b["converged"]
    np.testing.assert_allclose(a["khat"], b["khat"], rtol=1e-6)
    for k in ("elbo", "mu", "L", "psis_logw"):
        np.testing.assert_allclose(a[k], b[k], rtol=RTOL, err_msg=k)
    np.testing.assert_array_equal(a["free_idx"], b["free_idx"])


def narrow(pkg, **kw):
    """zero_i on the demo with priors around the fit (SMC keeps a finite
    population from a few particles)."""
    fw = pkg.ModelFramework(
        ODE=zero_i, parameter_names=["mu", "phi", "beta"],
        state_names=["S", "V"], dataframe=demo_df(), t_steps=64,
        mu=pkg.parameter(scipy.stats.lognorm, {"s": 0.2, "scale": 0.6}),
        phi=pkg.parameter(scipy.stats.lognorm, {"s": 0.2, "scale": 2.4e-8}),
        beta=pkg.parameter(scipy.stats.lognorm, {"s": 0.2, "scale": 24.0}),
        **kw)
    fw.set_parameters(mu=0.62, phi=2.3e-8, beta=25.0)
    return fw


def test_model_evidence_matches_reference(capsys):
    """beta static: pinned at its current value and left out of the
    prior; 24 particles, so the acceptances are float32 means that a
    float64 mean would miss."""
    kw = dict(n_moves=2, static_parameters=["beta"])
    ref_fw, fw = narrow(odelib_tpu), narrow(odelib_tpu_torch, device="cpu")
    pin_lhs(ref_fw, fw)
    ref = ref_fw.model_evidence(particles=24, **kw)
    ref_out = capsys.readouterr().out
    got = fw.model_evidence(particles=24, **kw)
    assert capsys.readouterr().out == ref_out
    np.testing.assert_allclose(got["betas"], ref["betas"], rtol=1e-12)
    assert got["acceptance"] == ref["acceptance"]
    np.testing.assert_allclose(got["log_evidence"], ref["log_evidence"],
                               rtol=1e-8)
    assert_same_frame(got["posterior"], ref["posterior"])
    assert len(got["betas"]) > 2 and got["betas"][-1] == 1.0


def joint_pair(pkg, **kw):
    """zero_i on the demo (a) and on it with y0 x 1.13 (b)."""
    a = framework(pkg, **kw)
    b = framework(pkg, **kw)
    b.set_inits(**{s: 1.13 * float(v)
                   for s, v in a.get_inits(as_dict=True).items()})
    for fw in (a, b):
        fw.set_parameters(mu=0.6, phi=2.4e-8, beta=24.0)
    return {"a": a, "b": b}


def joint_both(hierarchical):
    h = ["mu"] if hierarchical else []
    ref = odelib_tpu.JointFit(joint_pair(odelib_tpu), shared=["phi", "beta"],
                              hierarchical=h)
    got = odelib_tpu_torch.JointFit(
        joint_pair(odelib_tpu_torch, device="cpu"), shared=["phi", "beta"],
        hierarchical=h)
    return ref, got


def pin_joint_lhs(monkeypatch):
    """The port's JointFit draws the reference's LHS columns."""
    import odelib_tpu.samplers as jsamplers
    from odelib_tpu_torch import joint as tjoint

    real = jsamplers.sample_lhs
    drawn = {}

    def ref_lhs(key, dists, n):
        drawn["x"] = np.asarray(real(key, dists, n))
        return drawn["x"]

    monkeypatch.setattr(jsamplers, "sample_lhs", ref_lhs)
    monkeypatch.setattr(tjoint, "sample_lhs",
                        lambda gen, dists, n: __import__("torch").as_tensor(
                            drawn["x"]))


@pytest.mark.parametrize("hierarchical", [False, True],
                         ids=["plain", "hierarchical"])
def test_joint_fit_map_and_advi_match_reference(hierarchical, monkeypatch,
                                                capsys):
    pin_joint_lhs(monkeypatch)
    ref_j, got_j = joint_both(hierarchical)
    kw = dict(starts=3, steps=5, learning_rate=0.1)
    ref = ref_j.fit_map(**kw)
    got = got_j.fit_map(**kw)
    assert_same_frame(got, ref)
    for nm in ref_j.frameworks:
        assert_same_params(got_j.frameworks[nm], ref_j.frameworks[nm])
    run = dict(steps=4, n_mc=4, draws=40, use_priors=not hierarchical)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = ref_j.fit_advi(**run)
        ref_out = capsys.readouterr().out
        got = got_j.fit_advi(**run)
    assert capsys.readouterr().out == ref_out
    assert_same_frame(got, ref)
    np.testing.assert_allclose(got.attrs["advi"]["elbo"],
                               ref.attrs["advi"]["elbo"], rtol=RTOL)
    np.testing.assert_allclose(got.attrs["advi"]["khat"],
                               ref.attrs["advi"]["khat"], rtol=1e-6)


def _gbm(y, t, ps):
    return np.array([ps[0] * y[0]])


def _noise(y, t, ps):
    return np.array([0.3 * y[0]])


def sde(pkg, **kw):
    t = np.linspace(0.0, 2.0, 5)
    df = pd.DataFrame({"organism": "N", "time": t,
                       "abundance": 2.0 * np.exp(0.4 * t),
                       "log_sigma": 0.15})
    return pkg.ModelFramework(
        ODE=_gbm, diffusion=_noise, parameter_names=["mu"],
        state_names=["N"], dataframe=df, t_steps=9, N=2.0,
        mu=pkg.parameter(scipy.stats.lognorm, {"s": 0.5, "scale": 0.4}),
        **kw)


METHODS = ("fit_map", "laplace_approximation", "fit_advi",
           "profile_likelihood", "model_evidence")


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def _warning(fn):
    """The drift-only warnings of ``fn``, which then raises: it is called
    with ``substeps=0``, refused as the solver arguments are read, after
    the guard and before any solve."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert "substeps must be >= 1" in _error(fn)
    return [str(w.message) for w in rec if "drift_only" in str(w.message)]


@pytest.mark.parametrize("method", METHODS)
def test_stochastic_model_refusals_and_warnings(method):
    ref_fw, fw = sde(odelib_tpu), sde(odelib_tpu_torch, device="cpu")
    args = ("mu",) if method == "profile_likelihood" else ()
    msg = _error(lambda: getattr(fw, method)(*args))
    assert "process noise" in msg and "drift_only=True" in msg
    assert msg == _error(lambda: getattr(ref_fw, method)(*args))
    got = _warning(lambda: getattr(fw, method)(*args, drift_only=True,
                                               substeps=0))
    assert len(got) == 1 and got == _warning(
        lambda: getattr(ref_fw, method)(*args, drift_only=True, substeps=0))


def test_joint_stochastic_refusals():
    def pair(pkg, **kw):
        return {"a": sde(pkg, **kw), "b": sde(pkg, **kw)}
    ref_j = odelib_tpu.JointFit(pair(odelib_tpu), shared=["mu"])
    got_j = odelib_tpu_torch.JointFit(pair(odelib_tpu_torch, device="cpu"),
                                      shared=["mu"])
    for method in ("fit_map", "fit_advi"):
        msg = _error(lambda: getattr(got_j, method)())
        assert "process noise" in msg
        assert msg == _error(lambda: getattr(ref_j, method)())
        got = _warning(lambda: getattr(got_j, method)(drift_only=True,
                                                      substeps=0))
        assert len(got) == 1 and got == _warning(
            lambda: getattr(ref_j, method)(drift_only=True, substeps=0))


def test_inference_refusals():
    """rank, an all-static mask, non-positive ADVI starts, ess_target,
    missing priors: each raises as the reference does."""
    ref_fw, fw = both()
    for f in (ref_fw, fw):
        f.parameters["phi"].dist = None      # phi has no prior now
    cases = [
        ("fit_advi", dict(rank="low")),
        ("fit_advi", dict(static_parameters=["mu", "phi", "beta"])),
        ("model_evidence", dict(particles=8)),
        ("model_evidence", dict(particles=8, ess_target=1.5,
                                static_parameters=["phi"])),
    ]
    for method, kw in cases:
        assert _error(lambda: getattr(fw, method)(**kw)) == \
            _error(lambda: getattr(ref_fw, method)(**kw)), (method, kw)
    for f in (ref_fw, fw):
        f.set_parameters(mu=0.0)
    assert _error(lambda: fw.fit_advi()) == _error(lambda: ref_fw.fit_advi())
