"""Joint multi-experiment survey.

Counterpart of ``joint_survey`` in ``odelib_tpu/samplers/joint.py``: the
total chi of joint parameter draws, the sum over experiments of
:func:`~odelib_tpu_torch.model.chi_of_theta` on each experiment's gathered
theta, in the draws' dtype and on their device. The XLA joint samplers
(``joint_metropolis_hastings``, ``joint_pmmh``) are not ported (ROADMAP
queue 1, item 15); ``JointFit.MCMC`` runs the fused joint kernel
(:mod:`odelib_tpu_torch.ops.cuda_joint`).
"""
from __future__ import annotations

import torch

from ..model import chi_of_theta


def joint_survey(specs, idx_maps, obs_list, times_list, y0_list, thetas, *,
                 method: str = "fixed_dopri5", substeps=4,
                 substeps_list=None):
    """Batched joint chi for (N, D) joint draws -> (N,) total chi, the
    experiments' chi added to a zero start in experiment order.
    ``substeps`` is shared across experiments; ``substeps_list`` gives one
    entry per experiment (int or per-interval schedule) and wins."""
    specs = tuple(specs)
    thetas = torch.atleast_2d(torch.as_tensor(thetas))
    D = thetas.shape[-1]
    if substeps_list is None:
        substeps_list = [substeps] * len(specs)
    if len(substeps_list) != len(specs):
        raise ValueError(f"substeps_list must have {len(specs)} entries, "
                         f"got {len(substeps_list)}")
    tot = 0.0
    for sp, idx, obs, times, y0, sub in zip(specs, idx_maps, obs_list,
                                            times_list, y0_list,
                                            substeps_list):
        idx = [int(i) for i in idx]
        if len(idx) != sp.theta_size or any(i < 0 or i >= D for i in idx):
            raise ValueError(f"idx map {idx} does not fit a spec of "
                             f"{sp.theta_size} slots in joint size {D}")
        tot = tot + chi_of_theta(sp, obs, thetas[:, idx], y0, times,
                                 method=method, substeps=sub)
    return tot
