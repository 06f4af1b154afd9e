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
    # no kernel for HMC and adaptive Metropolis in either package: their
    # scan samplers; HMC's fixed Dopri5 for any method but rk4
    "hmc": (_framework, dict(sampler="hmc"), "hmc"),
    "hmc-kvaerno3": (_framework, dict(sampler="hmc", method="kvaerno3"),
                     "hmc"),
    "hmc-dense-chees-priors": (_framework, dict(
        sampler="hmc", dense_mass=True, path_adapt=True, use_priors=True),
        "hmc"),
    "amh": (_framework, dict(sampler="amh"), "amh"),
    "amh-backend-xla": (_framework, dict(sampler="amh", backend="xla"),
                        "amh"),
}


def _sde(pkg, **kw):
    return _framework(pkg, diffusion=lambda t, y, ps: [0.1 * y[0],
                                                       0.1 * y[1]], **kw)


def _sde_discrete(pkg, **kw):
    fw = _sde(pkg, **kw)
    dn = DiscreteNormal if pkg is odelib_tpu_torch \
        else odelib_tpu.distributions.DiscreteNormal
    fw.set_parameters(mu=pkg.parameter(dn(mu=1.0, sigma=0.2)))
    return fw


def _joint(make_a, make_b=_framework, **jkw):
    """A JointFit of two frameworks sharing phi (and ``jkw``), its survey
    one row of the current values repeated (so that neither package
    compiles it)."""
    def make(pkg, **kw):
        jf = pkg.JointFit({"a": make_a(pkg, **kw), "b": make_b(pkg, **kw)},
                          shared=["phi"], **jkw)
        jf.fit_survey = lambda samples, **skw: jf._df_from_thetas(
            np.tile(jf._current_joint_theta(), (8, 1)),
            {"chi": np.arange(8.0)})
        return jf
    make.joint = True
    return make


# PMMH: the arm run_pmmh takes (the fused kernel, 'pallas', or the XLA
# particle filter, 'xla'), or the ValueError both raise
PMMH_CASES = {
    "pmmh-128-particles": (_sde, dict(sampler="pmmh"), "pallas"),
    "pmmh-100-particles": (_sde, dict(sampler="pmmh", n_particles=100),
                           "xla"),
    "pmmh-1024-particles": (_sde, dict(sampler="pmmh", n_particles=1024),
                            "xla"),
    "pmmh-float-sde-substeps": (_sde, dict(sampler="pmmh",
                                           sde_substeps=4.0), "xla"),
    "pmmh-non-kernel-prior": (_sde_discrete, dict(sampler="pmmh",
                                                  use_priors=True), "xla"),
    "pmmh-backend-xla": (_sde, dict(sampler="pmmh", backend="xla"), "xla"),
    "pmmh-pallas-not-eligible": (_sde, dict(
        sampler="pmmh", backend="pallas", n_particles=100), "ValueError"),
}
# JointFit: the fused joint kernel ('pallas'), the XLA joint MH ('xla'),
# joint PMMH ('pmmh'), or the ValueError both raise
JOINT_CASES = {
    "joint-default": (_joint(_framework), {}, "pallas"),
    "joint-stochastic-member": (_joint(_sde), {}, "pmmh"),
    "joint-censored-counts": (_joint(_censored("poisson")), {}, "xla"),
    "joint-non-kernel-priors": (_joint(_discrete), dict(use_priors=True),
                                "xla"),
    "joint-backend-xla": (_joint(_framework), dict(backend="xla"), "xla"),
    "joint-pallas-stochastic": (_joint(_sde), dict(backend="pallas"),
                                "ValueError"),
    "joint-checkpoint-stochastic": (_joint(_sde), dict(
        checkpoint_every=2, checkpoint_path="unused.npz"), "ValueError"),
    "joint-hmc": (_joint(_framework), dict(sampler="hmc"), "hmc"),
    "joint-hierarchical": (_joint(_framework, hierarchical=["beta"]), {},
                           "xla"),
    "joint-hierarchical-hmc": (_joint(_framework, hierarchical=["beta"]),
                               dict(sampler="hmc"), "hmc"),
    "joint-hierarchical-pallas": (_joint(_framework, hierarchical=["beta"]),
                                  dict(backend="pallas"), "ValueError"),
    "joint-hmc-pallas": (_joint(_framework), dict(sampler="hmc",
                                                  backend="pallas"),
                         "ValueError"),
    "joint-hmc-stochastic": (_joint(_sde), dict(sampler="hmc"),
                             "ValueError"),
}
# the ValueErrors both raise before dispatching
RAISE_CASES = {
    "hmc-pallas": (_framework, dict(sampler="hmc", backend="pallas"),
                   "ValueError"),
    "amh-pallas": (_framework, dict(sampler="amh", backend="pallas"),
                   "ValueError"),
}
CASES.update(PMMH_CASES)
CASES.update(JOINT_CASES)
CASES.update(RAISE_CASES)


def _deep_capture(m, pkg):
    """Patch the samplers behind a PMMH or joint dispatch to raise
    _Routed naming their arm."""
    def arm(name):
        def raise_(*a, **k):
            raise _Routed(name)
        return raise_
    if pkg is odelib_tpu:
        m.setattr("odelib_tpu.ops.pallas_pf.pmmh_fused", arm("pallas"))
        m.setattr("odelib_tpu.ops.pallas_joint."
                  "joint_metropolis_hastings_fused", arm("pallas"))
        m.setattr("odelib_tpu.joint.joint_metropolis_hastings", arm("xla"))
    else:
        m.setattr("odelib_tpu_torch.ops.cuda_pf.pmmh_fused", arm("pallas"))
        m.setattr("odelib_tpu_torch.ops.cuda_joint."
                  "joint_metropolis_hastings_fused", arm("pallas"))
        m.setattr("odelib_tpu_torch.samplers.joint."
                  "joint_metropolis_hastings", arm("xla"))
    pre = pkg.__name__
    m.setattr(f"{pre}.samplers.pf.pmmh", arm("xla"))
    m.setattr(f"{pre}.samplers.pf.pmmh_checkpointed", arm("xla"))
    m.setattr(f"{pre}.samplers.joint.joint_metropolis_hastings_checkpointed",
              arm("xla"))
    m.setattr(f"{pre}.samplers.joint.joint_pmmh", arm("pmmh"))
    m.setattr(f"{pre}.samplers.hamiltonian_mc_custom", arm("hmc"))


def deep_arm(pkg, make, kw):
    """The arm of a PMMH or joint run, or the ValueError it raises."""
    m = pytest.MonkeyPatch()
    try:
        if pkg is odelib_tpu:
            m.setattr(jax, "default_backend", lambda: "tpu")
            m.setattr(JPM, "mosaic_supported", lambda: True)
        _deep_capture(m, pkg)
        fw = make(pkg) if pkg is odelib_tpu else make(pkg, device="cpu")
        run = dict(iterations_per_chain=6, print_report=False)
        try:
            if getattr(make, "joint", False):
                fw.MCMC(chain_inits=4, **run, **kw)
            else:
                fw.MCMC(chain_inits=_starts(fw), route="device", **run,
                        **kw)
        except _Routed as e:
            return {"arm": e.args[0]}
        except ValueError as e:
            return {"arm": "ValueError", "message": str(e)}
        raise AssertionError("the run was not routed")
    finally:
        m.undo()


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
    if case in PMMH_CASES or case in JOINT_CASES or case in RAISE_CASES:
        ref, got = deep_arm(odelib_tpu, make, kw), \
            deep_arm(odelib_tpu_torch, make, kw)
        assert ref["arm"] == arm, ref
        assert got == ref
        return
    ref = reference_arm(make, kw, monkeypatch)
    got = port_arm(make, kw, monkeypatch)
    assert ref["arm"] == arm
    assert got == ref
    if kw.get("temperatures") == "auto":   # the tuned ladder runs on
        assert got["temperatures"] == LADDER[0]


def test_pmmh_and_joint_xla_still_raise(caplog):
    """backend='xla' runs the XLA particle filter for PMMH and the XLA
    joint sampler for JointFit (the arms they log; the name is the one
    this test had when both raised, before they were ported)."""
    import logging
    fw = _framework(odelib_tpu_torch, device="cpu",
                    diffusion=lambda t, y, ps: [0.1 * y[0], 0.1 * y[1]])
    with caplog.at_level(logging.INFO, logger="odelib_tpu_torch"):
        post = fw.MCMC(chain_inits=INITS, iterations_per_chain=6,
                       sampler="pmmh", backend="xla", n_particles=8,
                       print_report=False)
    assert "the XLA particle filter (samplers/pf.py), 8 particles " \
        "(backend='xla')" in caplog.text
    assert len(post) == len(INITS) * 2
    jf = odelib_tpu_torch.JointFit([_framework(odelib_tpu_torch,
                                               device="cpu"),
                                    _framework(odelib_tpu_torch,
                                               device="cpu")],
                                   shared=["phi"])
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="odelib_tpu_torch"):
        post = jf.MCMC(chain_inits=4, iterations_per_chain=6, backend="xla",
                       fitsurvey_samples=16, print_report=False)
    assert "the XLA joint sampler (samplers/joint.py, joint MH)" \
        in caplog.text
    assert len(post) == 4 * 2


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
from odelib_tpu_torch.model import make_spec
from odelib_tpu_torch.ops.sde import sdeint_fixed
from odelib_tpu_torch.samplers.pf import obs_blocks, pmmh, tune_particles
from odelib_tpu_torch.samplers.joint import (joint_metropolis_hastings,
                                             joint_pmmh)
sde = sdeint_fixed(lambda t, y, a: 0.4 * y, lambda t, y, a: 0.3 * y,
                   np.ones(1), np.linspace(0, 1, 5), R.PRNGKey(2),
                   method="milstein", device="cpu")
gbm = make_spec(lambda t, y, ps: [ps[0] * y[0]], ("mu",), ("S",),
                diffusion=lambda t, y, ps: [0.3 * y[0]])
keep = np.asarray(obs.state_index) == 0
obs1 = obs._replace(**{f: np.asarray(getattr(obs, f))[keep] for f in (
    "log_abundance", "log_sigma", "abundance", "t_index", "state_index")})
g = (gbm, obs1, tf, y0[:1])
pf = pmmh(*g, th0[:, :1], keys, nits=4, n_particles=8, device="cpu")
k, v = tune_particles(*g, th0[0, :1], R.PRNGKey(3), pilot_particles=8,
                      n_reps=4, device="cpu")
j = ((spec, spec), ((0, 1, 2), (0, 1, 2)), (obs, obs), (tf, tf), (y0, y0))
jm = joint_metropolis_hastings(*j, th0, keys, nits=4, device="cpu")
jp = joint_pmmh((spec, gbm), ((0, 1, 2), (0,)), (obs, obs1), (tf, tf),
                (y0, y0[:1]), th0, keys, stoch_blocks=(None, obs_blocks(obs1)),
                nits=4, n_particles=8, device="cpu")
assert "jax" not in [m for m in sys.modules if sys.modules[m] is not None]
print("ok", out.chi.shape, ens.chi.shape, pt.chi.shape, len(lad[0]),
      sde.ys.shape, pf.chi.shape, k, jm.chi.shape, jp.chi.shape)
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
