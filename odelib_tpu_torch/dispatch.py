"""Per-(device, sampler) MCMC dispatch.

Counterpart of ``odelib_tpu/dispatch.py``'s fused arms. Each arm is keyed
by the device the framework runs on and the sampler: ``cuda:mh``,
``cuda:ensemble``, ``cuda:pt`` and ``cuda:pmmh`` launch the CUDA kernels,
``cpu:mh``, ``cpu:ensemble``, ``cpu:pt`` and ``cpu:pmmh`` run their torch
twins. Both go through the public wrappers of
:mod:`~odelib_tpu_torch.ops.cuda_mh`, :mod:`~odelib_tpu_torch.ops.cuda_pt`
and :mod:`~odelib_tpu_torch.ops.cuda_pf`, which pick kernel or twin from
the tensor's device. The other samplers are ROADMAP queue 1, item 16.
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
    priors: Optional[Tuple[Any, ...]] = None   # per slot (pmmh only)
    n_particles: int = 128
    sde_substeps: int = 4
    adapt_proposal: bool = False
    adapt_rate: float = 0.05
    target_accept: float = 0.3


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


def run_pmmh(fw, theta0, cfg: RunConfig):
    """The fused particle-marginal MH kernel (or its twin), as an
    ``MHOutput`` whose ``rsquared`` is NaN: a noisy likelihood estimate
    has no single trajectory to take R^2 of."""
    from .ops.cuda_pf import pmmh_fused
    from .samplers.mh import MHOutput
    th0 = torch.as_tensor(np.asarray(theta0, np.float32), device=fw.device)
    out = pmmh_fused(
        fw._spec, fw._obsdata_fit_host, fw._times_fit, fw.get_inits(), th0,
        seed=int(fw.random_seed) + cfg.seed_offset, nits=cfg.nits,
        burnin=cfg.burnin, walk_mask=cfg.mask, rwalk_std=cfg.rwalk_std,
        n_particles=cfg.n_particles, substeps=cfg.sde_substeps,
        priors=cfg.priors, adapt_proposal=cfg.adapt_proposal,
        target_accept=cfg.target_accept, adapt_rate=cfg.adapt_rate)
    return MHOutput(theta=out.theta, chi=out.chi,
                    rsquared=torch.full_like(out.chi, float("nan")),
                    aic=out.aic, acceptance_ratio=out.acceptance_ratio,
                    iteration=out.iteration)


_ARMS = {f"{dev}:{s}": arm for dev in ("cuda", "cpu")
         for s, arm in (("mh", run_fused_mh),
                        ("ensemble", run_fused_ensemble),
                        ("pt", run_fused_pt),
                        ("pmmh", run_pmmh))}


def dispatch(fw, sampler: str, theta0, cfg: RunConfig):
    """Route one resolved MCMC run to its (device, sampler) arm."""
    key = f"{fw.device.type}:{sampler}"
    if key not in _ARMS:
        raise NotImplementedError(f"no MCMC arm {key!r} in the port yet")
    return _ARMS[key](fw, theta0, cfg)
