"""Sensitivity analysis (odelib_tpu_torch/utils/sensitivity.py and the
``ModelFramework``/``JointFit`` methods) against odelib_tpu's on the CPU
(x64): the Saltelli design's Latin hypercubes bitwise on the reference's
key stream and the design within 1e-14 relative (the priors' ``ppf`` of
two libraries), Sobol indices within 1e-8, ``local_sensitivity`` against
``jax.jacfwd`` within 1e-8 (reverse mode through the fixed-step solve,
an array parameter's non-zero entries too), and
``power_scale_sensitivity`` within 1e-8 with khat within 1e-6 on a single
and on a joint fit."""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import odelib_tpu
import odelib_tpu_torch
from odelib_tpu.samplers.lhs import lhs_unit as ref_lhs_unit
from odelib_tpu.utils import sensitivity as rs
from odelib_tpu_torch import random as R
from odelib_tpu_torch.utils import sensitivity as ts

from helpers import demo_df
from test_torch_hmc_api import both, framework
from test_torch_joint import _fits

RTOL = 1e-8
PN = ["mu", "phi", "beta"]


def posterior_frame(n=400, seed=0, sd=0.05):
    """Draws around zero_i's fit with a chi column, six chains."""
    rng = np.random.default_rng(seed)
    post = pd.DataFrame({p: c * np.exp(sd * rng.normal(size=n))
                         for p, c in zip(PN, (0.6, 2.4e-8, 24.0))})
    post["chi"] = rng.uniform(10.0, 20.0, n)
    post["chain#"] = np.repeat(np.arange(6), -(-n // 6))[:n]
    return post


def assert_frame_close(got, ref, rtol=RTOL):
    assert list(got.columns) == list(ref.columns)
    assert list(got.index) == list(ref.index)
    for c in ref.columns:
        a, b = got[c].to_numpy(), ref[c].to_numpy()
        if b.dtype == object:
            np.testing.assert_array_equal(a, b, err_msg=c)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, err_msg=c,
                                       atol=rtol * np.max(np.abs(b)))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 33 + 1])
def test_saltelli_design_on_the_reference_stream(seed):
    k, t = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    for dims, n in ((3, 64), (1, 5), (4, 512)):
        np.testing.assert_array_equal(ts.lhs_unit(t, dims, n).numpy(),
                                      np.asarray(ref_lhs_unit(k, dims, n)))
    ref_fw, fw = both()
    rd = [ref_fw.parameters[p].jdist for p in PN]
    td = [fw.parameters[p].tdist for p in PN]
    d_ref, n_ref, p_ref = rs.saltelli_design(k, rd, 64)
    d, n, p = ts.saltelli_design(t, td, 64)
    assert (n, p) == (n_ref, p_ref) == (64, 3)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=1e-14)


@pytest.mark.parametrize("target", ["chi", "V", ("log", "S")],
                         ids=["chi", "state", "log-state"])
def test_sobol_sensitivity_matches_reference(target, capsys):
    """rk4 at substeps 2 (LHS prior draws make the adaptive solve run to
    max_steps); the printed table too."""
    ref_fw, fw = both()
    kw = dict(samples=48, target=target, n_boot=30, method="rk4",
              substeps=2)
    ref = ref_fw.sobol_sensitivity(**kw)
    ref_out = capsys.readouterr().out
    got = fw.sobol_sensitivity(**kw)
    assert capsys.readouterr().out == ref_out
    assert_frame_close(got, ref)


def test_eval_target_matches_reference():
    """The design's outputs themselves, adaptive Dopri5 on draws near the
    fit."""
    ref_fw, fw = both()
    th = posterior_frame(16)[PN].to_numpy()
    for tgt in (("chi",), ("state", 1), ("log_state", 0)):
        ref = rs._eval_target(
            ref_fw._spec, ref_fw._obsdata_fit,
            jnp.asarray(ref_fw._times_fit), jnp.asarray(ref_fw.get_inits()),
            jnp.asarray(th), target=tgt, num_params=3, method="dopri5",
            rtol=1e-6, atol=1e-4, max_steps=4096, substeps=4)
        got = ts._eval_target(
            fw._spec, fw._obsdata_fit_host, fw._times_fit, fw.get_inits(),
            torch.as_tensor(th), target=tgt, num_params=3, method="dopri5",
            rtol=1e-6, atol=1e-4, max_steps=4096, substeps=4)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)


@pytest.mark.parametrize("kw", [dict(), dict(log_scale=False, method="rk4"),
                                dict(parameters=[0.5, 3e-8, 20.0],
                                     substeps=2)],
                         ids=["log-dopri5", "linear-rk4", "given"])
def test_local_sensitivity_matches_jacfwd(kw):
    ref_fw, fw = both()
    ref = ref_fw.local_sensitivity(**kw)
    got = fw.local_sensitivity(**kw)
    assert list(got) == list(ref) == ["S", "V"]
    for s in ref:
        assert list(got[s].columns) == PN
        np.testing.assert_array_equal(got[s].index, ref[s].index)
        assert_frame_close(got[s], ref[s])


def _vec(t, y, ps):
    """zero_i with mu a 2-vector summed."""
    mu, phi, beta = ps
    S, V = y
    m = mu[0] + mu[1]
    return jnp.stack([m * S - phi * S * V, beta * phi * S * V - phi * S * V])


def test_local_sensitivity_with_an_array_parameter():
    """mu a 2-vector whose second entry is 0: one column per non-zero
    entry, labeled mu[0]; the masks are the reference's."""
    ref_fw, fw = (pkg.ModelFramework(
        ODE=_vec, parameter_names=PN, state_names=["S", "V"],
        dataframe=demo_df(), t_steps=32, ode_style="jax",
        mu=np.array([0.6, 0.0]), phi=2.4e-8, beta=24.0, **kw)
        for pkg, kw in ((odelib_tpu, {}),
                        (odelib_tpu_torch, {"device": "cpu"})))
    got = fw.local_sensitivity(substeps=2)
    ref = ref_fw.local_sensitivity(substeps=2)
    for s in ref:
        assert list(got[s].columns) == list(ref[s].columns) == \
            ["mu[0]", "phi", "beta"]
        assert_frame_close(got[s], ref[s])
    assert fw._prior_nonzero_masks() == ref_fw._prior_nonzero_masks() == \
        ((1, 0), None, None)


def test_power_scale_sensitivity_matches_reference(capsys):
    ref_fw, fw = both()
    post = posterior_frame()
    ref = ref_fw.power_scale_sensitivity(post)
    ref_out = capsys.readouterr().out
    got = fw.power_scale_sensitivity(post)
    assert capsys.readouterr().out == ref_out
    assert "Power-scaling sensitivity" in ref_out
    assert list(got.columns) == ["parameter", "prior_sens", "lik_sens",
                                 "khat", "diagnosis"]
    assert_frame_close(got.drop(columns="khat"), ref.drop(columns="khat"))
    np.testing.assert_allclose(got["khat"], ref["khat"], rtol=1e-6)


def test_power_scale_core_matches_reference():
    """The numpy core with per-dimension and joint prior columns, and its
    refusal of too few finite draws."""
    rng = np.random.default_rng(2)
    z = rng.normal(size=(300, 3))
    ll = -0.5 * (z ** 2).sum(1) + rng.normal(0, 0.1, 300)
    lp = -0.5 * (z / 2.0) ** 2
    for prior in (lp, lp.sum(1)):
        got = ts.power_scale_sensitivity(z, ll, prior, alphas=(0.5, 2.0),
                                         threshold=0.02)
        ref = rs.power_scale_sensitivity(z, ll, prior, alphas=(0.5, 2.0),
                                         threshold=0.02)
        pd.testing.assert_frame_equal(got, ref)
    with pytest.raises(ValueError, match="too few"):
        ts.power_scale_sensitivity(z[:10], ll[:10], lp[:10])


def test_joint_power_scale_sensitivity_matches_reference(capsys):
    """The zero_i pair sharing phi and beta (tests/test_torch_joint.py), a
    posterior frame of its joint columns."""
    ref_j, got_j = _fits("zero_i-pair")
    rng = np.random.default_rng(5)
    n = 300
    post = pd.DataFrame({c: v * np.exp(0.05 * rng.normal(size=n))
                         for c, v in zip(ref_j.columns,
                                         (2.4e-8, 24.0, 0.6, 0.6))})
    post["chi"] = rng.uniform(20.0, 40.0, n)
    ref = ref_j.power_scale_sensitivity(post)
    ref_out = capsys.readouterr().out
    got = got_j.power_scale_sensitivity(post)
    assert capsys.readouterr().out == ref_out
    assert "Joint power-scaling" in ref_out
    assert list(got.parameter) == list(ref_j.columns)
    assert_frame_close(got.drop(columns="khat"), ref.drop(columns="khat"))
    np.testing.assert_allclose(got["khat"], ref["khat"], rtol=1e-6)


def test_refusals_as_reference():
    fw = framework(odelib_tpu_torch, device="cpu")
    with pytest.raises(ValueError, match="unknown state"):
        fw.sobol_sensitivity(samples=16, target="X")
    fw.set_parameters(mu=odelib_tpu_torch.parameter(init_value=0.6),
                      phi=odelib_tpu_torch.parameter(init_value=2.4e-8))
    with pytest.raises(ValueError, match=">= 2 parameters"):
        fw.sobol_sensitivity(samples=16)
    fw.set_parameters(beta=odelib_tpu_torch.parameter(init_value=24.0))
    with pytest.raises(ValueError, match="at least one parameter"):
        fw.power_scale_sensitivity(posterior_frame(40))
