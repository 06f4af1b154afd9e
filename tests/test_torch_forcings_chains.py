"""The chain kernels' twins on forced models (MH, ensemble, PT, joint and
PMMH, Euler and Milstein) against ``odelib_tpu``'s Pallas kernels in
interpret mode over short runs: accept sequences and swap counts exact,
values at the tolerances their unforced tests state. The setups are
tests/test_torch_forcings.py's (the reference's ``forced_zero_i`` on its
144-point grid) and tests/test_torch_pf.py's GBM with its drift scaled by
a linear forcing. Kernel against twin on the card is in
tests/test_torch_cuda.py and chip_smoke.py's forcing phases."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odelib_tpu
import odelib_tpu.model as JM
import odelib_tpu_torch
import odelib_tpu_torch.model as TM
from odelib_tpu import JointFit as JJointFit
from odelib_tpu.distributions import LogNormal as JLogNormal
from odelib_tpu.ops import pallas_mh as J
from odelib_tpu.ops import pallas_pt as JP
from odelib_tpu.ops.pallas_joint import \
    joint_metropolis_hastings_fused as jax_joint_fused
from odelib_tpu.ops.pallas_pf import pmmh_fused as jax_pmmh_fused
from odelib_tpu_torch import JointFit
from odelib_tpu_torch.distributions import LogNormal
from odelib_tpu_torch.ops import cuda_joint as TJ
from odelib_tpu_torch.ops import cuda_mh as T
from odelib_tpu_torch.ops import cuda_pf as TF
from odelib_tpu_torch.ops import cuda_pt as TP
from odelib_tpu_torch.rhs import adapt_rhs

from helpers import synthetic_df, zero_i
from test_forcings import forced_zero_i
from test_torch_forcings import PN, SN, _draws, _specs, forced_data  # noqa
from test_torch_obs_models import assert_same_chains


def test_mh_twin_matches_pallas_interpret(forced_data):
    obs, tf, y0 = forced_data
    jspec, tspec = _specs("linear")
    th0 = _draws(128, 0.03, seed=3)
    kw = dict(nits=14, burnin=4, substeps=1)
    ref = J.metropolis_hastings_fused(jspec, obs, tf, y0, th0, seed=7,
                                      tile_chains=128, interpret=True, **kw)
    got = T.metropolis_hastings_fused(tspec, TM.obsdata_from_arrays(obs), tf,
                                      y0, torch.as_tensor(th0), 7, **kw)
    assert_same_chains(got, ref)


def test_ensemble_twin_matches_pallas_interpret(forced_data):
    obs, tf, y0 = forced_data
    jspec, tspec = _specs("cubic")
    th0 = _draws(256, 0.03, seed=4)
    kw = dict(nits=6, burnin=2, tile_chains=256, substeps=1)
    ref = J.ensemble_fused(jspec, obs, tf, y0, th0, seed=5, interpret=True,
                           **kw)
    got = T.ensemble_fused(tspec, TM.obsdata_from_arrays(obs), tf, y0,
                           torch.as_tensor(th0), 5, **kw)
    # the unforced ensemble's bounds (tests/test_torch_ensemble.py: the
    # stretch moves grow the math libraries' ulps)
    assert_same_chains(got, ref, theta_rtol=5e-5, chi_rtol=1e-3)


def test_pt_twin_matches_pallas_interpret(forced_data):
    obs, tf, y0 = forced_data
    jspec, tspec = _specs("hold")
    th0 = _draws(128, 0.03, seed=5)
    kw = dict(nits=6, burnin=2, temperatures=(1.0, 2.0, 4.0), substeps=1)
    ref, ref_rate = JP.parallel_tempering_fused(
        jspec, obs, tf, y0, th0, seed=7, tile_chains=128, interpret=True,
        **kw)
    got, rate = TP.parallel_tempering_fused(tspec, TM.obsdata_from_arrays(obs),
                                            tf, y0, torch.as_tensor(th0), 7,
                                            **kw)
    np.testing.assert_array_equal(rate.numpy(), np.asarray(ref_rate))
    assert_same_chains(got, ref)


def _thin(df):
    """Every other sampling time (an 8-point grid: the interpret-mode
    joint kernel compiles in seconds)."""
    return df[np.isclose(np.mod(np.round(df["time"] / 0.2), 2), 0)]


def _joint_fws(pkg, dist, **kw):
    """tests/test_forcings.py's test_jointfit_with_forced_experiment fits:
    zero_i on one synthetic frame and forced zero_i on another (every
    other sampling time)."""
    def mk(df, forcings=None):
        return pkg.ModelFramework(
            forced_zero_i if forcings else zero_i, list(PN), list(SN),
            dataframe=df, ode_style="jax", forcings=forcings,
            mu=pkg.parameter(dist(s=0.5, scale=0.6), {}, random_seed=1),
            phi=pkg.parameter(dist(s=0.5, scale=2.4e-8), {}, random_seed=2),
            beta=pkg.parameter(dist(s=0.5, scale=24.0), {}, random_seed=3),
            t_end=3.1, t_steps=32, **kw)
    return {"plain": mk(_thin(synthetic_df(0))),
            "forced": mk(_thin(synthetic_df(1)),
                         {"g": ([0.0, 1.5, 3.2], [0.8, 1.3, 0.9])})}


def _host(jf):
    fws = list(jf.frameworks.values())
    return ([fw._spec for fw in fws], [jf._idx_maps[n] for n in jf.frameworks],
            [fw._obsdata_fit_host for fw in fws],
            [np.asarray(fw._times_fit) for fw in fws],
            [np.asarray(fw.get_inits()) for fw in fws])


def test_joint_twin_matches_pallas_interpret():
    """The joint kernel on a plain and a forced experiment sharing beta:
    each experiment reads its own forcing table."""
    ref_jf = JJointFit(_joint_fws(odelib_tpu, JLogNormal), shared=("beta",))
    jf = JointFit(_joint_fws(odelib_tpu_torch, LogNormal, device="cpu"),
                  shared=("beta",))
    assert jf.columns == ref_jf.columns and jf._idx_maps == ref_jf._idx_maps
    rng = np.random.default_rng(5)
    th0 = (np.array([24.0, 0.6, 2.4e-8, 0.6, 2.4e-8])
           * np.exp(rng.normal(0, 0.05, (128, jf.dim)))).astype(np.float32)
    kw = dict(nits=11, burnin=2, walk_mask=jf._walk_mask(), rwalk_std=0.05,
              substeps_list=[1, 1])
    ref = jax_joint_fused(*_host(ref_jf), th0, seed=4, tile_chains=128,
                          interpret=True, **kw)
    got = TJ.joint_metropolis_hastings_fused(*_host(jf), torch.as_tensor(th0),
                                             4, **kw)
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    assert 0 < float(got.acceptance_ratio[:, -1].mean()) < 1
    same = (got.theta.numpy() == np.asarray(ref.theta)).all(-1)
    assert same.mean() > 0.4
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               rtol=1e-5)
    np.testing.assert_allclose(got.chi.numpy()[same],
                               np.asarray(ref.chi)[same], rtol=5e-5)
    np.testing.assert_allclose(got.chi_parts.numpy()[same],
                               np.asarray(ref.chi_parts)[same], rtol=5e-5)


def _forced_gbm(t, y, ps, u):
    return jnp.stack([ps[0] * u["a"] * y[0]])


def _gbm_noise(t, y, ps):
    return jnp.stack([0.3 * y[0]])


@pytest.mark.parametrize("method", ["euler", "milstein"])
def test_pmmh_twin_matches_pallas_interpret(method):
    """A GBM whose drift a linear forcing scales (tests/test_torch_pf.py's
    data), 16 particles: the drift, the diffusion and (Milstein) its
    derivative read the forcings at each Euler step's start. Accept
    sequences equal, chi within 5e-6 (the unforced PMMH bound)."""
    from test_torch_pf import _gbm_obs
    from odelib_tpu.model import ObsData
    t_obs, log_o = _gbm_obs()
    obs = ObsData(log_abundance=log_o, log_sigma=np.full(8, 0.15),
                  abundance=np.exp(log_o),
                  t_index=np.round(t_obs / 0.1).astype(np.int64),
                  state_index=np.zeros(8, np.int64),
                  sstot=float(np.var(np.exp(log_o)) * 8))
    forc = {"a": ((0.0, 2.0, 4.0), (1.2, 0.6, 1.0))}
    jspec = JM.make_spec(_forced_gbm, ("mu",), ("N",), forcings=forc,
                         diffusion=_gbm_noise)
    tspec = TM.make_spec(adapt_rhs(_forced_gbm), ("mu",), ("N",),
                         forcings=jspec.forcings,
                         diffusion=adapt_rhs(_gbm_noise))
    times = np.linspace(0, 4.0, 41)
    th0 = np.exp(np.random.default_rng(1).normal(np.log(0.4), 0.3,
                                                 (128, 1))).astype(np.float32)
    kw = dict(nits=7, burnin=3, rwalk_std=0.3, n_particles=16, substeps=1,
              sde_method=method, adapt_proposal=True, adapt_rate=0.15,
              target_accept=0.3)
    ref = jax_pmmh_fused(jspec, obs, times, np.float32([2.0]), th0, seed=3,
                         interpret=True, **kw)
    got = TF.pmmh_fused(tspec, TM.obsdata_from_arrays(obs), times,
                        np.array([2.0]), torch.as_tensor(th0), 3, **kw)
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    assert 0 < float(got.acceptance_ratio[:, -1].mean()) < 1
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               rtol=1e-6)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(ref.chi),
                               rtol=5e-6)
