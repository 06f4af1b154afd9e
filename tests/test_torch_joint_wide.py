"""Joint fits above the joint kernel's one-experiment-a-warp shapes (more
than 8 experiments or 64 joint slots, ``joint_kernel``'s ``WIDE``
instantiations on the card): the port's twin against ``odelib_tpu``'s
Pallas kernel in interpret mode.
Tolerances are tests/test_torch_joint.py's: accept sequences equal, theta
within 1e-5, chi and its parts within 5e-5 where theta is bitwise (1e-4
elsewhere), the total the parts' float32 sum in experiment order."""
import numpy as np
import pytest
import torch

import odelib_tpu
import odelib_tpu_torch
from odelib_tpu import JointFit as JJointFit
from odelib_tpu.distributions import LogNormal as JLogNormal
from odelib_tpu.ops.pallas_joint import \
    joint_metropolis_hastings_fused as jax_joint_fused
from odelib_tpu_torch import JointFit
from odelib_tpu_torch.distributions import LogNormal
from odelib_tpu_torch.ops import cuda_joint as TJ

from test_torch_joint import _host_args, _zero_i_pair


def _fits(K):
    """K zero_i experiments (the pair's first on the synthetic data, the
    others its perturbed copy), mu shared, phi and beta per experiment:
    D = 1 + 2 K."""
    def make(pkg, dist, **kw):
        pair = _zero_i_pair(pkg, dist, **kw)
        return {f"e{k}": pair["a"] if k == 0 else
                _zero_i_pair(pkg, dist, **kw)["b"] for k in range(K)}
    return (JJointFit(make(odelib_tpu, JLogNormal), shared=["mu"],
                      random_seed=3),
            JointFit(make(odelib_tpu_torch, LogNormal, device="cpu"),
                     shared=["mu"], random_seed=3))


def _check(K, extra, C=32, nits=9, burnin=2, substeps=1):
    """Both packages' joint kernels on K experiments with ``extra`` more
    joint slots that no experiment reads (every other one walked), at
    ``substeps`` a grid interval: the records held as the module docstring
    says."""
    ref_jf, jf = _fits(K)
    assert jf.columns == ref_jf.columns and jf._idx_maps == ref_jf._idx_maps
    D = jf.dim + extra
    centre = np.array([0.6] + [2.4e-8, 24.0] * K + [1.0] * extra)
    rng = np.random.default_rng(5)
    th0 = (centre * np.exp(rng.normal(0, 0.05, (C, D)))).astype(np.float32)
    mask = np.concatenate([np.ones(jf.dim), np.arange(extra) % 2 == 0])
    args = list(_host_args(jf))
    kw = dict(nits=nits, burnin=burnin, walk_mask=mask, rwalk_std=0.05,
              substeps_list=[substeps] * K)
    ref = jax_joint_fused(*_host_args(ref_jf), th0, seed=4, tile_chains=128,
                          interpret=True, **kw)
    got = TJ.joint_metropolis_hastings_fused(*args, torch.as_tensor(th0), 4,
                                             **kw)
    R = nits - 1 - burnin
    assert got.theta.shape == (C, R, D) and got.chi_parts.shape == (C, R, K)
    np.testing.assert_array_equal(got.acceptance_ratio.numpy(),
                                  np.asarray(ref.acceptance_ratio))
    assert 0 < float(got.acceptance_ratio[:, -1].mean()) < 1
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               rtol=1e-5)
    # bitwise theta where a score reads it: experiment k's own slots for
    # part k, every map's for the total (with 19 slots read, few rows
    # have them all bitwise: the walks' Box-Muller ulps of two math
    # libraries; the total is checked exactly against the parts below)
    eq = got.theta.numpy() == np.asarray(ref.theta)
    idx = jf._idx_maps.values()
    same = eq[..., sorted({i for m in idx for i in m})].all(-1)
    parts, ref_parts = got.chi_parts.numpy(), np.asarray(ref.chi_parts)
    np.testing.assert_allclose(got.chi.numpy()[same],
                               np.asarray(ref.chi)[same], rtol=5e-5)
    for k, m in enumerate(idx):
        same_k = eq[..., list(m)].all(-1)
        assert same_k.mean() > 0.4
        np.testing.assert_allclose(parts[..., k][same_k],
                                   ref_parts[..., k][same_k], rtol=5e-5)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(ref.chi),
                               rtol=1e-4)
    np.testing.assert_allclose(parts, ref_parts, rtol=1e-4)
    total = parts[..., 0]
    for k in range(1, K):
        total = total + parts[..., k]
    np.testing.assert_array_equal(got.chi.numpy(), total)
    if extra:                   # an unread static slot never moves
        fixed = got.theta[:, :, -1].numpy()
        assert (fixed == fixed[:, :1]).all()


def test_joint_nine_experiments_67_slots_match_pallas_interpret():
    """K = 9 (one past the 8 warps of a joint block) and D = 19 + 48 =
    67 slots, above the 64 of the one-experiment-a-warp kernel."""
    _check(9, 48)


@pytest.mark.slow
def test_joint_33_experiments_match_pallas_interpret():
    """K = 33, D = 67: zero_i with mu shared and phi and beta per
    experiment, at substeps 2: at 1 the 33 perturbed experiments reach the
    dopri5 stage sums' float32 gap between XLA:CPU and torch (a part 5.4e-5
    apart on bitwise theta; tests/test_torch_survey.py's substeps note).
    The interpret-mode reference compiles 33 experiments' scorers for
    minutes, so this case runs in the full suite."""
    _check(33, 0, substeps=2)
