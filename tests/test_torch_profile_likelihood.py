"""``profile_likelihood`` through the user API against odelib_tpu's on the
CPU (x64), from the same starts (the port's framework is handed the
reference's LHS frame): the profile within 1e-8, the interval ``ci``
within 1e-8, the threshold within 1e-12, ``identifiable`` equal and the
printed line equal. tests/test_profile_likelihood.py's problems: the
constant model's Gaussian oracle on the grid derived from the prior, the
unidentifiable ridge k1 * k2 and the identifiable decay with a second
observed state; the refusals of an unknown parameter, a short grid, a
parameter without a prior and array-valued parameters."""
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.stats

import odelib_tpu
import odelib_tpu_torch

from test_torch_inference_api import pin_lhs


def _lognorm(pkg, s, scale):
    return pkg.parameter(scipy.stats.lognorm, {"s": s, "scale": scale})


def constant(pkg, **kw):
    """tests/test_profile_likelihood.py's y = S0 on 10 noisy points."""
    def rhs(t, y, ps):
        return jnp.stack([0.0 * y[0]])

    rng = np.random.default_rng(12)
    d = np.log(1e6) + rng.normal(0, 0.3, 10)
    df = pd.DataFrame([{"organism": "S", "time": t, "abundance": np.exp(la),
                        "log_sigma": 0.3}
                       for t, la in zip(np.linspace(0, 3, 10), d)])
    fw = pkg.ModelFramework(
        ODE=rhs, parameter_names=["S0"], state_names=["S"], dataframe=df,
        t_steps=16, ode_style="jax", S0=_lognorm(pkg, 0.15, 1e6), **kw)
    fw.set_parameters(S0=1.1e6)
    return fw


def ridge(pkg, **kw):
    def rhs(t, y, ps):
        k1, k2 = ps
        return jnp.stack([-(k1 * k2) * y[0]])

    tobs = np.linspace(0.0, 3.0, 10)
    df = pd.DataFrame([{"organism": "y", "time": t,
                        "abundance": 1e6 * np.exp(-t), "log_sigma": 0.2}
                       for t in tobs])
    fw = pkg.ModelFramework(
        ODE=rhs, parameter_names=["k1", "k2"], state_names=["y"],
        dataframe=df, t_steps=32, ode_style="jax",
        k1=_lognorm(pkg, 1.0, 1.0), k2=_lognorm(pkg, 1.0, 1.0), **kw)
    fw.set_parameters(k1=1.2, k2=0.9)
    return fw


def decay(pkg, **kw):
    def rhs(t, y, ps):
        (k,) = ps
        return jnp.stack([-k * y[0], 0.0 * y[1]])

    tobs = np.linspace(0.0, 3.0, 10)
    rows = [{"organism": "y", "time": t, "abundance": 1e6 * np.exp(-t),
             "log_sigma": 0.2} for t in tobs]
    rows += [{"organism": "w", "time": t, "abundance": 1e3,
              "log_sigma": 0.2} for t in tobs]
    fw = pkg.ModelFramework(
        ODE=rhs, parameter_names=["k"], state_names=["y", "w"],
        dataframe=pd.DataFrame(rows), t_steps=32, ode_style="jax",
        k=_lognorm(pkg, 0.7, 1.0), **kw)
    fw.set_parameters(k=0.8)
    return fw


CASES = {
    "gaussian-prior-grid": (constant, "S0", dict(points=15, starts=2,
                                                 steps=20)),
    "ridge": (ridge, "k1", dict(p_range=np.geomspace(0.3, 3.0, 7), starts=3,
                                steps=25, learning_rate=0.1)),
    "decay-rk4-priors": (decay, "k", dict(
        p_range=np.geomspace(0.5, 2.0, 9), starts=2, steps=15,
        use_priors=True, method="rk4", confidence=0.9)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_profile_matches_reference(case, capsys):
    make, name, kw = CASES[case]
    ref_fw, fw = make(odelib_tpu), make(odelib_tpu_torch, device="cpu")
    pin_lhs(ref_fw, fw)
    ref = ref_fw.profile_likelihood(name, **kw)
    ref_out = capsys.readouterr().out
    got = fw.profile_likelihood(name, **kw)
    assert capsys.readouterr().out == ref_out
    assert got["identifiable"] == ref["identifiable"]
    np.testing.assert_allclose(got["threshold"], ref["threshold"],
                               rtol=1e-12)
    np.testing.assert_allclose(got["ci"], ref["ci"], rtol=1e-8)
    assert list(got["profile"].columns) == ["value", "chi"]
    for c in ("value", "chi"):
        np.testing.assert_allclose(got["profile"][c], ref["profile"][c],
                                   rtol=1e-8, err_msg=c)
    if case == "ridge":
        assert not got["identifiable"] and np.isnan(got["ci"]).all()
    else:
        assert got["identifiable"] and np.isfinite(got["ci"]).all()


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_profile_refusals():
    ref_fw, fw = ridge(odelib_tpu), ridge(odelib_tpu_torch, device="cpu")
    for args, kw in ((("nope",), {}), (("k1",), dict(p_range=[1.0, 2.0]))):
        msg = _error(lambda: fw.profile_likelihood(*args, **kw))
        assert msg == _error(lambda: ref_fw.profile_likelihood(*args, **kw))
    for f in (ref_fw, fw):
        f.parameters["k2"].dist = None
    assert _error(lambda: fw.profile_likelihood("k2")) == \
        _error(lambda: ref_fw.profile_likelihood("k2"))
    for f in (ref_fw, fw):
        f.set_parameters(k2=np.array([0.9, 0.0]))
    assert "scalar parameters only" in _error(
        lambda: fw.profile_likelihood("k1"))
    assert _error(lambda: fw.profile_likelihood("k1")) == \
        _error(lambda: ref_fw.profile_likelihood("k1"))
