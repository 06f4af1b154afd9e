"""Per-(device, sampler) MCMC dispatch.

Counterpart of ``odelib_tpu/dispatch.py``'s fused arms. Each arm is keyed
by the device the framework runs on and the sampler: ``cuda:mh``,
``cuda:ensemble`` and ``cuda:pt`` launch the CUDA kernels, ``cpu:mh``,
``cpu:ensemble`` and ``cpu:pt`` run their torch twins. Both go through the
public wrappers of :mod:`~odelib_tpu_torch.ops.cuda_mh` and
:mod:`~odelib_tpu_torch.ops.cuda_pt`, which pick kernel or twin from the
tensor's device. The other samplers are ROADMAP queue 1, items 15-16.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger("odelib_tpu_torch")


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
    tile_chains: Optional[int] = None   # the ensemble size (ensemble only)
    temperatures: Tuple[float, ...] = (1.0, 2.0, 4.0, 8.0)
    swap_every: int = 1
    stretch_a: float = 2.0


def fused_stepper(method: str) -> str:
    """Fixed-step kernel stepper for a configured method name."""
    return "rk4" if method == "rk4" else "dopri5"


def _fused_args(fw, theta0, cfg: RunConfig):
    th0 = torch.as_tensor(np.asarray(theta0, np.float32), device=fw.device)
    return ((fw._spec, fw._obsdata_fit_host, fw._times_fit, fw.get_inits(),
             th0),
            dict(seed=int(fw.random_seed) + cfg.seed_offset, nits=cfg.nits,
                 burnin=cfg.burnin, walk_mask=cfg.mask,
                 stepper=fused_stepper(cfg.method), substeps=cfg.substeps))


def run_fused_mh(fw, theta0, cfg: RunConfig):
    """The fused MH kernel (or, for a CPU framework, its twin)."""
    from .ops.cuda_mh import metropolis_hastings_fused
    args, kw = _fused_args(fw, theta0, cfg)
    return metropolis_hastings_fused(*args, rwalk_std=cfg.rwalk_std, **kw)


def run_fused_ensemble(fw, theta0, cfg: RunConfig):
    """The fused Goodman-Weare ensemble kernels (or their twin)."""
    from .ops.cuda_mh import ensemble_fused
    args, kw = _fused_args(fw, theta0, cfg)
    return ensemble_fused(*args, a=float(cfg.stretch_a),
                          tile_chains=cfg.tile_chains, **kw)


def run_fused_pt(fw, theta0, cfg: RunConfig):
    """The fused parallel-tempering kernel (or its twin)."""
    from .ops.cuda_pt import parallel_tempering_fused
    args, kw = _fused_args(fw, theta0, cfg)
    out, swap_rate = parallel_tempering_fused(
        *args, temperatures=tuple(cfg.temperatures),
        swap_every=cfg.swap_every, rwalk_std=cfg.rwalk_std, **kw)
    log.info("parallel tempering (fused): mean cold-pair swap acceptance "
             "%.3f per proposal over %d temperatures",
             float(swap_rate.mean()), len(cfg.temperatures))
    return out


_ARMS = {f"{dev}:{s}": arm for dev in ("cuda", "cpu")
         for s, arm in (("mh", run_fused_mh),
                        ("ensemble", run_fused_ensemble),
                        ("pt", run_fused_pt))}


def dispatch(fw, sampler: str, theta0, cfg: RunConfig):
    """Route one resolved MCMC run to its (device, sampler) arm."""
    key = f"{fw.device.type}:{sampler}"
    if key not in _ARMS:
        raise NotImplementedError(f"no MCMC arm {key!r} in the port yet")
    return _ARMS[key](fw, theta0, cfg)
