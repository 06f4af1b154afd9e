"""``MCMC``'s routing between the fused kernels and the scan samplers,
against the decision odelib_tpu takes on a TPU (its ``backend='auto'``
test with ``jax.default_backend`` patched to 'tpu' and
``mosaic_supported`` to True, as tests/test_routing.py patches it): every
condition of that test (a fixed-step method, in-kernel priors, censored
lognormal/Student-t data only, an RHS that traces, an ensemble filling a
tile) and ``backend='xla'``/``temperatures='auto'`` send the port to the
same arm. Both packages stop at their dispatch; the runs themselves are
in tests/test_torch_scan_*.py and the rewritten API tests. Then the
package with jax blocked: the scan samplers and tune_ladder on the CPU."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import scipy.stats

import odelib_tpu
import odelib_tpu.dispatch as JD
import odelib_tpu.ops.pallas_mh as JPM
import odelib_tpu_torch
import odelib_tpu_torch.dispatch as TD
from odelib_tpu_torch.distributions import DiscreteNormal

from helpers import demo_df, zero_i
from scoring_cases import demo_frame
from test_torch_scan_mh import INITS, _lin_model
from test_array_params import vec_df


class _Routed(Exception):
    pass


LADDER = ((1.0, 1.5, 2.25, 3.375), 0.3)


def _framework(pkg, df=None, obs_model="lognormal", **kw):
    return pkg.ModelFramework(
        ODE=zero_i, parameter_names=["mu", "phi", "beta"],
        state_names=["S", "V"], dataframe=demo_df() if df is None else df,
        mu=pkg.parameter(scipy.stats.lognorm, {"s": 3, "scale": 1e-8}),
        phi=pkg.parameter(scipy.stats.lognorm, {"s": 3, "scale": 1e-8}),
        beta=pkg.parameter(scipy.stats.lognorm, {"s": 1, "scale": 25}),
        t_steps=64, obs_model=obs_model, **kw)


def _lin(pkg, **kw):
    return pkg.ModelFramework(
        _lin_model, ["A", "phi", "beta"], ["S", "V"], dataframe=vec_df(),
        A=np.array([[0.6, 0.0], [0.0, 0.1]]), phi=2.4e-8, beta=24.0,
        t_steps=64, ode_style="jax", **kw)


def _discrete(pkg, **kw):
    fw = _framework(pkg, **kw)
    dn = DiscreteNormal if pkg is odelib_tpu_torch \
        else odelib_tpu.distributions.DiscreteNormal
    fw.set_parameters(mu=pkg.parameter(dn(mu=1.0, sigma=0.2)))
    return fw


def _censored(model):
    def make(pkg, **kw):
        return _framework(pkg, df=demo_frame(model, ("left",), scale=1e5),
                          obs_model=model, **kw)
    return make


CASES = {
    "default": (_framework, {}, "pallas"),
    "kvaerno3": (_framework, dict(method="kvaerno3"), "pallas"),
    "kvaerno5": (_framework, dict(method="kvaerno5"), "xla"),
    "method-auto": (_framework, dict(method="auto"), "xla"),
    "pt-kvaerno5": (_framework, dict(sampler="pt", method="kvaerno5"), "pt"),
    "backend-xla": (_framework, dict(backend="xla"), "xla"),
    "pt-backend-xla": (_framework, dict(sampler="pt", backend="xla"), "pt"),
    "ensemble-backend-xla": (_framework, dict(sampler="ensemble",
                                              backend="xla"), "ensemble"),
    "lognormal-priors": (_framework, dict(use_priors=True), "pallas"),
    "discrete-normal": (_discrete, dict(use_priors=True), "xla"),
    "pt-discrete-normal": (_discrete, dict(sampler="pt", use_priors=True),
                           "pt"),
    "ensemble-discrete-normal": (_discrete, dict(
        sampler="ensemble", use_priors=True, pallas_tile_chains=4),
        "ensemble"),
    "censored-poisson": (_censored("poisson"), {}, "xla"),
    "censored-lognormal": (_censored("lognormal"), {}, "pallas"),
    "linear-algebra-rhs": (_lin, {}, "xla"),
    "ensemble-under-a-tile": (_framework, dict(sampler="ensemble"),
                              "ensemble"),
    "ensemble-filling-a-tile": (_framework, dict(
        sampler="ensemble", pallas_tile_chains=4), "pallas"),
    "pt-auto-ladder": (_framework, dict(sampler="pt", temperatures="auto"),
                       "pallas"),
}


def _starts(fw):
    if "A" in fw.get_pnames():
        return [dict(A=np.array([[0.6, 0.0], [0.0, 0.1]]) * f, phi=2.4e-8,
                     beta=24.0) for f in (1.0, 1.05, 0.95, 1.1)]
    return INITS


def reference_arm(make, kw, monkeypatch):
    """The arm odelib_tpu's MCMC picks on a Mosaic-capable TPU."""
    seen = {}

    def capture(fw_, backend, sampler, theta0, n_chains, cfg):
        seen["arm"] = backend
        seen["temperatures"] = tuple(cfg.temperatures)
        raise _Routed
    with monkeypatch.context() as m:
        m.setattr(jax, "default_backend", lambda: "tpu")
        m.setattr(JPM, "mosaic_supported", lambda: True)
        m.setattr(JD, "dispatch", capture)
        m.setattr("odelib_tpu.samplers.pt.tune_ladder",
                  lambda *a, **k: LADDER)
        fw = make(odelib_tpu)
        with pytest.raises(_Routed):
            fw.MCMC(chain_inits=_starts(fw), iterations_per_chain=6,
                    route="device", print_report=False, **kw)
    return seen


def port_arm(make, kw, monkeypatch):
    seen = {}

    def capture(fw_, sampler, theta0, cfg, arm="pallas", n_chains=None):
        seen["arm"] = arm
        seen["temperatures"] = tuple(cfg.temperatures)
        raise _Routed
    with monkeypatch.context() as m:
        m.setattr(TD, "dispatch", capture)
        m.setattr("odelib_tpu_torch.samplers.pt.tune_ladder",
                  lambda *a, **k: LADDER)
        fw = make(odelib_tpu_torch, device="cpu")
        with pytest.raises(_Routed):
            fw.MCMC(chain_inits=_starts(fw), iterations_per_chain=6,
                    print_report=False, **kw)
    return seen


@pytest.mark.parametrize("case", list(CASES))
def test_port_takes_the_reference_tpu_route(case, monkeypatch):
    make, kw, arm = CASES[case]
    ref = reference_arm(make, kw, monkeypatch)
    got = port_arm(make, kw, monkeypatch)
    assert ref["arm"] == arm
    assert got == ref
    if kw.get("temperatures") == "auto":   # the tuned ladder runs on
        assert got["temperatures"] == LADDER[0]


def test_pmmh_and_joint_xla_still_raise():
    """The XLA particle filter and joint sampler are the next slice."""
    fw = _framework(odelib_tpu_torch, device="cpu",
                    diffusion=lambda t, y, ps: [0.1 * y[0], 0.1 * y[1]])
    with pytest.raises(NotImplementedError,
                       match="item 15.*only PF and joint remain"):
        fw.MCMC(chain_inits=INITS, iterations_per_chain=6, sampler="pmmh",
                backend="xla", print_report=False)
    jf = odelib_tpu_torch.JointFit([_framework(odelib_tpu_torch,
                                               device="cpu"),
                                    _framework(odelib_tpu_torch,
                                               device="cpu")],
                                   shared=["phi"])
    with pytest.raises(NotImplementedError, match="item 15"):
        jf.MCMC(chain_inits=4, iterations_per_chain=6, backend="xla",
                print_report=False)


def test_control_flow_rhs_raises_on_the_scan_route():
    """Python control flow on t has no batched form (ROADMAP queue 3)."""
    def branchy(t, y, ps):
        mu, phi, beta = ps
        S, V = y
        if t < 10.0:
            mu = mu * 1.0
        return [mu * S - phi * S * V, beta * phi * S * V - phi * S * V]
    fw = odelib_tpu_torch.ModelFramework(
        branchy, ["mu", "phi", "beta"], ["S", "V"], dataframe=demo_df(),
        mu=0.6, phi=2.4e-8, beta=24.0, t_steps=64, ode_style="jax",
        device="cpu")
    with pytest.raises(NotImplementedError, match="queue 3"):
        fw.MCMC(chain_inits=INITS, iterations_per_chain=6,
                print_report=False)
    with pytest.raises(ValueError, match="backend='pallas' runs the fused"):
        fw.MCMC(chain_inits=INITS, iterations_per_chain=6, backend="pallas",
                print_report=False)


_NO_JAX = """
import sys
sys.modules["jax"] = None
import numpy as np, torch
import odelib_tpu_torch
from odelib_tpu_torch import random as R
from odelib_tpu_torch.models import zero_i
from odelib_tpu_torch.data import (build_obsdata_host,
    compact_observation_grid, format_dataframe, load_demo_dataframe)
from odelib_tpu_torch.samplers.mh import metropolis_hastings
from odelib_tpu_torch.samplers.ensemble import ensemble_mh
from odelib_tpu_torch.samplers.pt import parallel_tempering, tune_ladder
df = format_dataframe(load_demo_dataframe(host="S", virus="V"), ("S", "V"))
times = np.linspace(0, df["time"].max(), 64)
spec = zero_i.spec()
obs, _ = build_obsdata_host(df, times, spec.post_snames)
tf, obs = compact_observation_grid(obs, times)
y0 = np.array([df.loc["S"].iloc[0]["abundance"],
               df.loc["V"].iloc[0]["abundance"]])
th0 = np.array([0.6, 2.4e-8, 24.0]) * np.exp(
    np.random.default_rng(0).normal(0, 0.05, (4, 3)))
keys = R.fold_in(R.PRNGKey(0), torch.arange(4))
a = (spec, obs, tf, y0, th0)
out = metropolis_hastings(*a, keys, nits=4, device="cpu")
ens = ensemble_mh(*a, R.PRNGKey(1), nits=4, device="cpu")
pt, rate = parallel_tempering(*a, keys, nits=4, device="cpu")
lad = tune_ladder(*a, keys, pilot_iters=4, max_rounds=1, device="cpu")
assert "jax" not in [m for m in sys.modules if sys.modules[m] is not None]
print("ok", out.chi.shape, ens.chi.shape, pt.chi.shape, len(lad[0]))
"""


def test_scan_samplers_run_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith("ok")


def test_only_vmaps_refusal_turns_an_rhs_eager():
    """An RHS the tracer refuses: control flow on t (vmap's refusal) runs
    eagerly on the whole batch, the RHS's own error propagates from the
    solver and from the scan route's check."""
    import torch
    from odelib_tpu_torch.model import state_func
    boom = []

    def rhs(t, y, ps):
        mu, phi, beta = ps
        S, V = y
        if boom and S.ndim == 0:         # a lane's call under vmap
            raise RuntimeError("the RHS's own error")
        if t < 10.0:                     # control flow on t
            mu = mu * 1.0
        return [mu * S - phi * S * V, beta * phi * S * V - phi * S * V]
    fw = odelib_tpu_torch.ModelFramework(
        rhs, ["mu", "phi", "beta"], ["S", "V"], dataframe=demo_df(),
        mu=0.6, phi=2.4e-8, beta=24.0, t_steps=64, ode_style="jax",
        device="cpu")
    y = torch.tensor([[1e6, 2e6], [1e3, 3e3]], dtype=torch.float64)
    ps = [torch.tensor([0.6, 0.5], dtype=torch.float64),
          torch.tensor([2.4e-8, 2e-8], dtype=torch.float64),
          torch.tensor([24.0, 20.0], dtype=torch.float64)]
    got = state_func(fw._spec)(0.0, y, ps)
    S, V = y
    want = torch.stack([ps[0] * S - ps[1] * S * V,
                        ps[2] * ps[1] * S * V - ps[1] * S * V])
    torch.testing.assert_close(got, want, rtol=1e-15, atol=0.0)
    boom.append(1)
    with pytest.raises(RuntimeError, match="the RHS's own error"):
        state_func(fw._spec)(0.0, y, ps)
    with pytest.raises(RuntimeError, match="the RHS's own error"):
        TD.require_batched(fw._spec, np.array([[0.6, 2.4e-8, 24.0]]),
                           np.array([1e6, 1e3]), 0.0)
