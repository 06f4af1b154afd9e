"""The scan MH (odelib_tpu_torch/samplers/mh.py) against odelib_tpu's XLA
scan sampler on the CPU, both in float64 (x64) from the same theta0 and
keys: accept sequences exact, theta and chi within 1e-8 relative (two
solver codes in one precision; measured ~1e-14). Adaptive Dopri5 and
Kvaerno5; through ``MCMC(backend='xla')`` end to end (the posterior frame
column by column), with a DiscreteNormal prior (no in-kernel form), with
a linear-algebra RHS (``A @ y`` on an array parameter, run per lane
through torch.func.vmap) and with run-length extension; checkpointed in
3 chunks and killed and resumed, bitwise the whole run (port only)."""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.stats
import torch

import odelib_tpu
import odelib_tpu_torch
from odelib_tpu.data import obsdata_to_device
from odelib_tpu.samplers import metropolis_hastings as jax_mh
from odelib_tpu_torch import random as R
from odelib_tpu_torch.distributions import DiscreteNormal
from odelib_tpu_torch.model import obsdata_from_arrays
from odelib_tpu_torch.samplers import mh as T

from helpers import demo_df, zero_i
from test_array_params import vec_df
from test_torch_survey import setup  # noqa: F401  (module fixture)

RTOL = 1e-8
INITS = [dict(mu=0.62, phi=2.3e-8, beta=25.0),
         dict(mu=0.55, phi=2.6e-8, beta=22.0),
         dict(mu=0.7, phi=2.0e-8, beta=30.0),
         dict(mu=0.6, phi=2.4e-8, beta=24.0)]


def chains(C, seed=3, sd=0.05):
    rng = np.random.default_rng(seed)
    return np.array([0.6, 2.4e-8, 24.0]) * np.exp(rng.normal(0, sd, (C, 3)))


def keys(C, seed=0):
    """The reference's chain keys (dispatch._xla_setup) and the port's."""
    base = jax.random.PRNGKey(seed)
    jk = jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(C))
    tk = R.fold_in(R.PRNGKey(seed), torch.arange(C))
    np.testing.assert_array_equal(tk.numpy(),
                                  np.asarray(jk).astype(np.int64))
    return jk, tk


def assert_same(got, ref, rtol=RTOL):
    np.testing.assert_array_equal(got.iteration.numpy(),
                                  np.asarray(ref.iteration))
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    for f in ("theta", "chi", "rsquared", "aic"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=rtol,
                                   err_msg=f)


def run_both(setup, th0, C, **kw):
    spec, tspec, obs, tf, y0 = setup
    jk, tk = keys(C)
    jkw = dict(kw)
    if kw.get("walk_mask") is not None:
        jkw["walk_mask"] = jnp.asarray(kw["walk_mask"])
    ref = jax_mh(spec, obsdata_to_device(obs), jnp.asarray(tf),
                 jnp.asarray(y0), jnp.asarray(th0), jk, **jkw)
    got = T.metropolis_hastings(tspec, obsdata_from_arrays(obs), tf, y0, th0,
                                tk, device="cpu", **kw)
    return got, ref


@pytest.mark.parametrize("walk_mask", [None, [1.0, 0.0, 1.0]],
                         ids=["all-walked", "walk-101"])
def test_scan_mh_dopri5_matches_reference(setup, walk_mask):  # noqa: F811
    th0 = chains(16)
    got, ref = run_both(setup, th0, 16, nits=30, walk_mask=walk_mask)
    assert got.theta.shape == (16, 14, 3)
    assert_same(got, ref)
    assert 0 < float(got.acceptance_ratio[:, -1].mean()) < 1
    if walk_mask is not None:     # the static slot: exp(log(theta0))
        fixed = got.theta[:, :, 1].numpy()
        assert (fixed == fixed[:, :1]).all()
        np.testing.assert_allclose(fixed[:, 0], th0[:, 1], rtol=4e-15)


def test_scan_mh_kvaerno5_matches_reference(setup):  # noqa: F811
    got, ref = run_both(setup, chains(8, seed=5), 8, nits=10, burnin=4,
                        method="kvaerno5")
    assert_same(got, ref)


def test_scan_mh_checkpointed_bitwise(setup, tmp_path):  # noqa: F811
    """3 chunks (one straddling the burn-in), a kill after the first chunk
    and a resume, against the whole run, bitwise; a changed configuration
    is refused."""
    spec, tspec, obs, tf, y0 = setup
    obs = obsdata_from_arrays(obs)
    _, tk = keys(6)
    th0 = chains(6, seed=9)
    kw = dict(nits=22, burnin=8)
    whole = T.metropolis_hastings(tspec, obs, tf, y0, th0, tk, device="cpu",
                                  **kw)
    path = str(tmp_path / "mh.progress")
    ck = dict(checkpoint_every=7, checkpoint_path=path, device="cpu", **kw)
    chunked = T.metropolis_hastings_checkpointed(tspec, obs, tf, y0, th0, tk,
                                                 **ck)
    assert T.metropolis_hastings_checkpointed(
        tspec, obs, tf, y0, th0, tk, _stop_after_chunks=1, **ck) is None
    resumed = T.metropolis_hastings_checkpointed(
        tspec, obs, tf, y0, th0, tk, resume_from=path, **ck)
    for out in (chunked, resumed):
        for a, b in zip(out, whole):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="different MCMC configuration"):
        T.metropolis_hastings_checkpointed(
            tspec, obs, tf, y0, th0, tk, resume_from=path,
            **dict(ck, nits=23))


def _framework(pkg, **kw):
    return pkg.ModelFramework(
        ODE=zero_i, parameter_names=["mu", "phi", "beta"],
        state_names=["S", "V"], dataframe=demo_df(),
        mu=pkg.parameter(scipy.stats.lognorm, {"s": 3, "scale": 1e-8}),
        phi=pkg.parameter(scipy.stats.lognorm, {"s": 3, "scale": 1e-8}),
        beta=pkg.parameter(scipy.stats.lognorm, {"s": 1, "scale": 25}),
        t_steps=64, **kw)


def assert_same_frame(got, ref, rtol=RTOL):
    assert list(got.columns) == list(ref.columns)
    assert len(got) == len(ref)
    for col in ref.columns:
        a, b = got[col].to_numpy(), ref[col].to_numpy()
        if a.dtype == object:
            a, b = np.stack(a).astype(float), np.stack(b).astype(float)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=rtol, err_msg=col)
        else:
            np.testing.assert_array_equal(a, b, err_msg=col)
        assert got[col].dtype == ref[col].dtype, col


def test_mcmc_backend_xla_end_to_end():
    """MCMC(backend='xla') with explicit starts: the reference's posterior
    frame, column for column, in the same order."""
    ref = _framework(odelib_tpu).MCMC(chain_inits=INITS,
                                      iterations_per_chain=16,
                                      backend="xla", print_report=False)
    fw = _framework(odelib_tpu_torch, device="cpu")
    got = fw.MCMC(chain_inits=INITS, iterations_per_chain=16,
                  backend="xla", print_report=False, profile=True)
    assert "chains[xla]" in fw.last_profile
    assert_same_frame(got, ref)


def test_mcmc_discrete_normal_prior_end_to_end():
    """use_priors=True with a DiscreteNormal prior (no in-kernel form):
    the scan MH under backend='auto', the reference's posterior."""
    rfw = _framework(odelib_tpu)
    rfw.set_parameters(mu=odelib_tpu.parameter(
        odelib_tpu.distributions.DiscreteNormal(mu=1.0, sigma=0.2)))
    ref = rfw.MCMC(chain_inits=INITS, iterations_per_chain=14,
                   use_priors=True, backend="xla", print_report=False)
    fw = _framework(odelib_tpu_torch, device="cpu")
    fw.set_parameters(mu=odelib_tpu_torch.parameter(
        DiscreteNormal(mu=1.0, sigma=0.2)))
    got = fw.MCMC(chain_inits=INITS, iterations_per_chain=14,
                  use_priors=True, print_report=False, profile=True)
    assert "chains[xla]" in fw.last_profile
    assert_same_frame(got, ref)
    plain = fw.MCMC(chain_inits=INITS, iterations_per_chain=14,
                    print_report=False)
    assert (plain.acceptance_ratio != got.acceptance_ratio).any()


def _lin_model(t, y, ps):
    """zero_i's growth and clearance as a matrix product on the states."""
    A, phi, beta = ps
    S, V = y
    g = A @ y
    return jnp.stack([g[0] - phi * S * V,
                      beta * phi * S * V - phi * S * V - g[1]])


def test_linear_algebra_rhs_end_to_end():
    """An RHS the tracer refuses (``A @ y``; A's zero entries pinned): the
    scan MH calls it per lane through torch.func.vmap, as the reference
    vmaps it; the reference's posterior."""
    A = np.array([[0.6, 0.0], [0.0, 0.1]])
    starts = [dict(A=A * f, phi=2.4e-8 * g, beta=24.0)
              for f, g in ((1.0, 1.0), (1.05, 0.95), (0.9, 1.1))]

    def fw(pkg, **kw):
        return pkg.ModelFramework(
            _lin_model, ["A", "phi", "beta"], ["S", "V"],
            dataframe=vec_df(), A=A, phi=2.4e-8, beta=24.0, t_steps=64,
            ode_style="jax", **kw)
    ref = fw(odelib_tpu).MCMC(chain_inits=starts, iterations_per_chain=12,
                              print_report=False)
    tfw = fw(odelib_tpu_torch, device="cpu")
    got = tfw.MCMC(chain_inits=starts, iterations_per_chain=12,
                   print_report=False, profile=True)
    assert "chains[xla]" in tfw.last_profile
    assert_same_frame(got, ref)
    cells = np.stack(got["A"].to_numpy())
    assert (cells[:, 0, 1] == 0).all() and (cells[:, 1, 0] == 0).all()


def test_mcmc_scan_extension_matches_reference():
    """until_rhat on the scan MH: one extension (the target cannot be met),
    its stream salted as the reference's (key_salt), the iteration column
    continuing; the reference's frame."""
    kw = dict(chain_inits=INITS, iterations_per_chain=10, backend="xla",
              until_rhat=1.0, max_extensions=1, print_report=False)
    with pytest.warns(UserWarning, match="extension cap"):
        ref = _framework(odelib_tpu).MCMC(**kw)
    with pytest.warns(UserWarning, match="extension cap"):
        got = _framework(odelib_tpu_torch, device="cpu").MCMC(**kw)
    assert got["iteration"].max() == 18
    assert_same_frame(got, ref)
    assert isinstance(got, pd.DataFrame)
