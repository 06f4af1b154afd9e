"""Per-(device, sampler) MCMC dispatch.

Counterpart of ``odelib_tpu/dispatch.py``. The port has one sampler arm,
the fused MH kernel, keyed by the device the framework runs on:
``cuda:mh`` launches the CUDA kernel and ``cpu:mh`` runs its torch twin.
Both go through :func:`~odelib_tpu_torch.ops.cuda_mh.
metropolis_hastings_fused`, which picks kernel or twin from the tensor's
device. The other samplers are ROADMAP queue 1, items 15-16.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Resolved per-run settings (built once in ``ModelFramework.MCMC``)."""
    nits: int
    burnin: int
    mask: Any                      # per-slot walk mask (flat, host array)
    rwalk_std: float
    method: str
    substeps: Any
    seed_offset: int = 0


def fused_stepper(method: str) -> str:
    """Fixed-step kernel stepper for a configured method name."""
    return "rk4" if method == "rk4" else "dopri5"


def run_fused_mh(fw, theta0, cfg: RunConfig):
    """The fused MH kernel (or, for a CPU framework, its twin)."""
    from .ops.cuda_mh import metropolis_hastings_fused
    th0 = torch.as_tensor(np.asarray(theta0, np.float32), device=fw.device)
    return metropolis_hastings_fused(
        fw._spec, fw._obsdata_fit_host, fw._times_fit, fw.get_inits(), th0,
        seed=int(fw.random_seed) + cfg.seed_offset,
        nits=cfg.nits, burnin=cfg.burnin, walk_mask=cfg.mask,
        rwalk_std=cfg.rwalk_std, stepper=fused_stepper(cfg.method),
        substeps=cfg.substeps)


_ARMS = {"cuda:mh": run_fused_mh, "cpu:mh": run_fused_mh}


def dispatch(fw, sampler: str, theta0, cfg: RunConfig):
    """Route one resolved MCMC run to its (device, sampler) arm."""
    key = f"{fw.device.type}:{sampler}"
    if key not in _ARMS:
        raise NotImplementedError(f"no MCMC arm {key!r} in the port yet")
    return _ARMS[key](fw, theta0, cfg)
