"""MH record structure and the eager batched survey.

Counterpart of ``odelib_tpu/samplers/mh.py``: :class:`MHOutput`, the
record layout every MH path returns, and :func:`survey`, the chi of many
parameter draws through the adaptive solver. The XLA scan sampler
``metropolis_hastings`` is not ported yet (ROADMAP queue 1, item 8); the
main path runs the fused kernel (:mod:`odelib_tpu_torch.ops.cuda_mh`).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .. import stats
from ..model import ModelSpec, ObsData
from ..ops.integrate import odeint_grid
from ..rhs import torch_evaluator


class MHOutput(NamedTuple):
    """Post-burnin samples. Leading axes: (chains, records)."""
    theta: Any             # (C, R, P)
    chi: Any               # (C, R)
    rsquared: Any          # (C, R)
    aic: Any               # (C, R)
    acceptance_ratio: Any  # (C, R)
    iteration: Any         # (R,)


def state_func(spec: ModelSpec):
    """``func(t, y (S, N), ps) -> (S, N)`` for the integrators."""
    f = torch_evaluator(spec.rhs, len(spec.snames), spec.theta_size)
    return lambda t, y, ps: torch.stack(f(t, list(y), ps))


def survey(spec: ModelSpec, obs: ObsData, times, y0_base, thetas, *,
           method: str = "dopri5", rtol: float = 1e-6, atol: float = 1e-4,
           max_steps: int = 4096, substeps: int = 4):
    """Chi for every parameter draw: ``thetas`` (N, P) tensor -> (N,),
    one batched adaptive solve (failed lanes give NaN chi)."""
    thetas = torch.as_tensor(thetas)
    dtype, dev = thetas.dtype, thetas.device
    y0 = spec.override_inits(torch.as_tensor(y0_base, dtype=dtype,
                                             device=dev), thetas)
    sol = odeint_grid(state_func(spec), y0, times,
                      spec.unpack_theta(thetas), rtol=rtol, atol=atol,
                      max_steps=max_steps, method=method)
    post = spec.apply_summations(sol.ys.permute(2, 0, 1))  # (N, T, S_post)
    ti = torch.as_tensor(obs.t_index, dtype=torch.int64, device=dev)
    si = torch.as_tensor(obs.state_index, dtype=torch.int64, device=dev)
    pred = post[:, ti, si]
    la = torch.as_tensor(obs.log_abundance, dtype=dtype, device=dev)
    ls = torch.as_tensor(obs.log_sigma, dtype=dtype, device=dev)
    return stats.obs_negloglik(spec.obs_model, spec.obs_param, la,
                               torch.log(pred), ls, censor=obs.censor)
