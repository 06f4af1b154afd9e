"""Fixed-grid SDE paths (odelib_tpu_torch/ops/sde.py, model.sdeint_theta,
ModelFramework.simulate) against odelib_tpu's on the CPU, in float64 from
the same keys: the random stream is bitwise (the increment of substep j
is normal(fold_in(key, j))), so paths agree within 1e-12 relative (two
implementations of one arithmetic; measured ~1e-15). Euler-Maruyama and
Milstein on GBM and on a two-state model whose noise depends on both
states, a dose, the NaN tail of a blow-up, the argument checks, and the
framework's simulate and tune_particles against the reference's methods
at the same seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.stats
import torch

import odelib_tpu
import odelib_tpu_torch
from odelib_tpu.model import make_spec as j_make_spec
from odelib_tpu.model import sdeint_theta as j_sdeint_theta
from odelib_tpu.ops.sde import sdeint_fixed as j_sdeint
from odelib_tpu_torch import random as R
from odelib_tpu_torch.model import make_spec, sdeint_theta
from odelib_tpu_torch.ops.sde import sdeint_fixed
from odelib_tpu_torch.rhs import adapt_rhs

from helpers import synthetic_df, zero_i

RTOL = 1e-12
MU, SIG = 0.4, 0.3
TS = np.linspace(0.0, 2.0, 21)


def _gbm(pkg):
    if pkg == "jax":
        return (lambda t, y, a: a[0] * y,
                lambda t, y, a: SIG * y * jnp.sqrt(1.0 + 0.5 * y[::-1]))
    return (lambda t, y, a: a[0] * y,
            lambda t, y, a: SIG * y * torch.sqrt(1.0 + 0.5 * y.flip(-1)))


def _args(pkg):
    v = [MU, 0.2]
    return (jnp.asarray(v),) if pkg == "jax" \
        else (torch.tensor(v, dtype=torch.float64),)


@pytest.mark.parametrize("method", ["euler", "milstein"])
@pytest.mark.parametrize("substeps", [1, 4])
def test_sdeint_fixed_matches_reference(method, substeps):
    """A two-state path whose diffusion reads the other state too (the
    Milstein term takes d g_s / d y_s only), one key."""
    ref = j_sdeint(*_gbm("jax"), jnp.array([1.0, 2.0]), jnp.asarray(TS),
                   jax.random.PRNGKey(5), _args("jax"), substeps=substeps,
                   method=method)
    got = sdeint_fixed(*_gbm("torch"), torch.tensor([1.0, 2.0],
                                                    dtype=torch.float64),
                       TS, R.PRNGKey(5), _args("torch"), substeps=substeps,
                       method=method)
    assert got.ys.shape == (21, 2) and bool(got.ok) == bool(ref.ok)
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(ref.ys),
                               rtol=RTOL)


def test_sdeint_fixed_batch_of_keys_is_the_vmapped_reference():
    keys = jax.random.split(jax.random.PRNGKey(0), 5)
    ref = jax.vmap(lambda k: j_sdeint(
        lambda t, y, a: 0.5 * y, lambda t, y, a: 0.3 * y, jnp.ones(1),
        jnp.asarray(TS), k, substeps=2).ys)(keys)
    got = sdeint_fixed(lambda t, y, a: 0.5 * y, lambda t, y, a: 0.3 * y,
                       torch.ones(1, dtype=torch.float64), TS,
                       torch.as_tensor(np.asarray(keys).astype(np.int64)),
                       substeps=2)
    assert got.ys.shape == (5, 21, 1) and bool(got.ok.all())
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(ref), rtol=RTOL)


def test_sdeint_dose_and_blowup():
    """A dose joins after its grid point (pre-dose rows); a blow-up turns
    to NaN with ok False, never raising (the reference's tests)."""
    ts = np.linspace(0.0, 1.0, 11)
    dose = np.zeros((11, 1))
    dose[5, 0] = 3.0
    zero = lambda t, y, a: 0.0 * y   # noqa: E731
    got = sdeint_fixed(zero, zero, np.array([1.0]), ts, R.PRNGKey(0),
                       substeps=2, dose=dose, device="cpu")
    ref = j_sdeint(zero, zero, jnp.array([1.0]), jnp.asarray(ts),
                   jax.random.PRNGKey(0), substeps=2, dose=jnp.asarray(dose))
    np.testing.assert_array_equal(got.ys.numpy(), np.asarray(ref.ys))
    np.testing.assert_allclose(got.ys[:6, 0].numpy(), 1.0)
    np.testing.assert_allclose(got.ys[6:, 0].numpy(), 4.0)
    sq = lambda t, y, a: y * y   # noqa: E731
    got = sdeint_fixed(sq, zero, np.array([5.0]), np.linspace(0, 10, 11),
                       R.PRNGKey(0), substeps=4, device="cpu")
    ref = j_sdeint(sq, zero, jnp.array([5.0]), jnp.linspace(0, 10, 11),
                   jax.random.PRNGKey(0), substeps=4)
    assert not bool(got.ok) and not bool(ref.ok)
    assert np.isnan(got.ys[-1, 0].item())
    np.testing.assert_array_equal(np.isnan(got.ys.numpy()),
                                  np.isnan(np.asarray(ref.ys)))


def test_sdeint_validation():
    f = lambda t, y, a: y   # noqa: E731
    with pytest.raises(ValueError, match="method"):
        sdeint_fixed(f, f, np.ones(1), TS, R.PRNGKey(0), method="srk",
                     device="cpu")
    with pytest.raises(ValueError, match="substeps"):
        sdeint_fixed(f, f, np.ones(1), TS, R.PRNGKey(0), substeps=0,
                     device="cpu")
    spec = make_spec(lambda t, y, ps: [ps[0] * y[0]], ("mu",), ("N",))
    with pytest.raises(ValueError, match="diffusion"):
        sdeint_theta(spec, np.array([MU]), np.ones(1), TS, R.PRNGKey(0),
                     device="cpu")


@pytest.mark.parametrize("method", ["euler", "milstein"])
def test_sdeint_theta_matches_reference(method):
    """zero_i with demographic noise sqrt-scaled on both states and a
    dose, through the spec (traced drift and diffusion; Milstein's
    derivative from the traced diagonal)."""
    def noise(t, y, ps):
        return [0.05 * y[0] ** 0.5 * 30.0, 0.1 * y[1]]

    def jnoise(t, y, ps):
        return jnp.stack([0.05 * y[0] ** 0.5 * 30.0, 0.1 * y[1]])

    doses = ((3.0, "V", 1e5),)
    tspec = make_spec(adapt_rhs(zero_i, "jax"), ("mu", "phi", "beta"),
                      ("S", "V"),
                      diffusion=noise, dose_events=doses)
    jspec = j_make_spec(zero_i, ("mu", "phi", "beta"), ("S", "V"),
                        diffusion=jnoise, dose_events=doses)
    theta = np.array([0.6, 2.4e-8, 24.0])
    y0 = np.array([1e6, 1e4])
    ts = np.linspace(0.0, 8.0, 17)
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    ref = jax.vmap(lambda k: j_sdeint_theta(
        jspec, jnp.asarray(theta), jnp.asarray(y0), jnp.asarray(ts), k,
        substeps=3, method=method))(keys)
    got = sdeint_theta(tspec, torch.as_tensor(theta).expand(3, -1), y0, ts,
                       torch.as_tensor(np.asarray(keys).astype(np.int64)),
                       substeps=3, method=method)
    assert got.shape == (3, 17, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)
    one = sdeint_theta(tspec, theta, y0, ts, R.PRNGKey(9), substeps=3,
                       method=method, device="cpu")
    assert one.shape == (17, 2)


def _sde_framework(pkg, **kw):
    def gbm(y, t, ps):
        return np.array([ps[0] * y[0]])

    def gnoise(y, t, ps):
        return np.array([ps[1] * y[0]])

    rng = np.random.default_rng(0)
    ts = np.linspace(0.0, 2.0, 9)[1:]
    ab = 10.0 * np.exp((0.5 - 0.5 * 0.3 ** 2) * ts
                       + 0.3 * np.sqrt(ts) * rng.normal(size=ts.size))
    df = pd.DataFrame({"organism": "X", "time": ts, "abundance": ab,
                       "log_sigma": 0.2})
    return pkg.ModelFramework(
        ODE=gbm, diffusion=gnoise, parameter_names=["r", "s"],
        state_names=["X"], dataframe=df, t_steps=48, random_seed=1,
        r=pkg.parameter(scipy.stats.lognorm, {"s": 0.5, "scale": 0.5}),
        s=pkg.parameter(scipy.stats.lognorm, {"s": 0.5, "scale": 0.3}),
        X=10.0, **kw)


@pytest.mark.parametrize("sde_method", ["euler", "milstein"])
def test_simulate_matches_reference(sde_method):
    """ModelFramework.simulate: the reference's frame for the same seed
    (path i keyed fold_in(PRNGKey(seed), i)), the array form, and paths
    that do not depend on n_paths."""
    fw, ref_fw = _sde_framework(odelib_tpu_torch, device="cpu"), \
        _sde_framework(odelib_tpu)
    for m in (fw, ref_fw):
        m.set_parameters(r=0.5, s=0.3)
    kw = dict(n_paths=5, seed=3, sde_method=sde_method, sde_substeps=2)
    got, ref = fw.simulate(**kw), ref_fw.simulate(**kw)
    assert list(got.columns) == list(ref.columns) == ["X", "time", "path#"]
    pd.testing.assert_index_equal(got.index, ref.index)
    for col in ("time", "path#"):
        np.testing.assert_array_equal(got[col].to_numpy(),
                                      ref[col].to_numpy())
        assert got[col].dtype == ref[col].dtype
    np.testing.assert_allclose(got["X"], ref["X"], rtol=RTOL)
    a3 = fw.simulate(n_paths=3, seed=3, sde_method=sde_method,
                     sde_substeps=2, as_dataframe=False)
    np.testing.assert_array_equal(a3, got["X"].to_numpy().reshape(5, 48, 1)
                                  [:3])
    det = odelib_tpu_torch.ModelFramework(
        ODE=zero_i, parameter_names=["mu", "phi", "beta"],
        state_names=["S", "V"], dataframe=synthetic_df(), mu=0.6,
        phi=2.4e-8, beta=24.0, device="cpu")
    with pytest.raises(ValueError, match="diffusion"):
        det.simulate()
    with pytest.raises(ValueError, match="diffusion"):
        det.tune_particles()


def test_framework_tune_particles_matches_reference(capsys):
    """ModelFramework.tune_particles: the reference's (K*, var) at the
    same seed and its report line."""
    fw, ref_fw = _sde_framework(odelib_tpu_torch, device="cpu"), \
        _sde_framework(odelib_tpu)
    for m in (fw, ref_fw):
        m.set_parameters(r=0.5, s=0.3)
    kw = dict(pilot_particles=16, n_reps=16, sde_substeps=2)
    k, v = fw.tune_particles(**kw)
    line = capsys.readouterr().out
    rk, rv = ref_fw.tune_particles(**kw)
    assert line == capsys.readouterr().out
    assert isinstance(k, int) and k % 8 == 0 and k == rk
    np.testing.assert_allclose(v, rv, rtol=1e-9)
