"""MH record structure and the eager batched survey.

Counterpart of ``odelib_tpu/samplers/mh.py``: :class:`MHOutput`, the
record layout every MH path returns, and :func:`survey`, the chi of many
parameter draws through the adaptive solver. The XLA scan sampler
``metropolis_hastings`` is not ported yet (ROADMAP queue 1, item 8); the
main path runs the fused kernel (:mod:`odelib_tpu_torch.ops.cuda_mh`).
The survey is :func:`odelib_tpu_torch.model.chi_of_theta` over the batch.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..model import ModelSpec, ObsData, chi_of_theta, state_func  # noqa: F401


class MHOutput(NamedTuple):
    """Post-burnin samples. Leading axes: (chains, records)."""
    theta: Any             # (C, R, P)
    chi: Any               # (C, R)
    rsquared: Any          # (C, R)
    aic: Any               # (C, R)
    acceptance_ratio: Any  # (C, R)
    iteration: Any         # (R,)


def survey(spec: ModelSpec, obs: ObsData, times, y0_base, thetas, *,
           method: str = "dopri5", rtol: float = 1e-6, atol: float = 1e-4,
           max_steps: int = 4096, substeps: int = 4):
    """Chi for every parameter draw: ``thetas`` (N, P) tensor -> (N,),
    one batched solve (adaptive 'dopri5', or fixed 'rk4'/'fixed_dopri5';
    failed lanes give NaN chi)."""
    return chi_of_theta(spec, obs, torch.as_tensor(thetas), y0_base, times,
                        method=method, rtol=rtol, atol=atol,
                        max_steps=max_steps, substeps=substeps)
