"""Per-(device, sampler) MCMC dispatch.

Counterpart of ``odelib_tpu/dispatch.py``'s fused arms. Each arm is keyed
by the device the framework runs on and the sampler: ``cuda:mh``,
``cuda:ensemble``, ``cuda:pt`` and ``cuda:pmmh`` launch the CUDA kernels,
``cpu:mh``, ``cpu:ensemble``, ``cpu:pt`` and ``cpu:pmmh`` run their torch
twins. Both go through the public wrappers of
:mod:`~odelib_tpu_torch.ops.cuda_mh`, :mod:`~odelib_tpu_torch.ops.cuda_pt`
and :mod:`~odelib_tpu_torch.ops.cuda_pf`, which pick kernel or twin from
the tensor's device. With ``checkpoint_every`` each arm runs its kernel
in chunks and persists the chain state to ``<checkpoint_path>.progress``
(:mod:`~odelib_tpu_torch.ops.chunked`). The other samplers are ROADMAP
queue 1, item 16. A model whose RHS (or, for PMMH, diffusion) does not
trace into the kernels (:func:`require_traced`: linear algebra on an array
parameter, Python control flow on a value) raises ``NotImplementedError``:
the reference runs it on its XLA sampler (``rhs_supports_tiles``).
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
    """Resolved per-run settings (built once in ``ModelFramework.MCMC``;
    ``dataclasses.replace`` derives a run-length extension's: burn-in 0,
    a fresh stream salt)."""
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
    priors: Optional[Tuple[Any, ...]] = None   # per slot, or None
    n_particles: int = 128
    sde_substeps: int = 4
    sde_method: str = "euler"
    adapt_proposal: bool = False
    adapt_rate: float = 0.05
    target_accept: float = 0.3
    checkpoint_every: Optional[int] = None
    checkpoint_path: Optional[str] = None
    resume_from: Optional[str] = None
    config_token: str = ""


def require_traced(spec, sampler: str, item: str):
    """Raise ``NotImplementedError`` naming ``item`` (the ROADMAP item that
    ports the XLA sampler, ``odelib_tpu``'s route for such a model) when
    the spec's RHS, or for ``sampler='pmmh'`` its diffusion, does not
    trace into the kernels; the twins never stand in for the kernels."""
    from .model import diffusion_program, rhs_program
    from .rhs import RhsTraceError
    try:
        rhs_program(spec)
        if sampler == "pmmh" and spec.diffusion is not None:
            diffusion_program(spec)
    except RhsTraceError as e:
        raise NotImplementedError(
            f"the model does not trace into the fused kernels ({e}); the "
            f"reference runs it on its XLA sampler, not ported yet ({item})"
        ) from e


def fused_stepper(method: str) -> str:
    """Fixed-step kernel stepper for a configured method name."""
    return method if method in ("rk4", "kvaerno3") else "dopri5"


def _progress_path(cfg: RunConfig) -> Optional[str]:
    """The chunked run's progress file, ``<checkpoint_path>.progress``."""
    if cfg.checkpoint_every is None:
        return None
    if cfg.checkpoint_path is None:
        raise ValueError(
            "checkpoint_every requires checkpoint_path (chain state is "
            "persisted to <checkpoint_path>.progress)")
    return cfg.checkpoint_path + ".progress"


def _checkpoint_args(cfg: RunConfig):
    return dict(checkpoint_every=cfg.checkpoint_every,
                checkpoint_path=_progress_path(cfg),
                resume_from=cfg.resume_from, config_token=cfg.config_token)


def _fused_args(fw, theta0, cfg: RunConfig):
    th0 = torch.as_tensor(np.asarray(theta0, np.float32), device=fw.device)
    return ((fw._spec, fw._obsdata_fit_host, fw._times_fit, fw.get_inits(),
             th0),
            dict(seed=int(fw.random_seed) + cfg.seed_offset, nits=cfg.nits,
                 burnin=cfg.burnin, walk_mask=cfg.mask,
                 stepper=fused_stepper(cfg.method), substeps=cfg.substeps,
                 **_checkpoint_args(cfg)))


def run_fused_mh(fw, theta0, cfg: RunConfig):
    """The fused MH kernel (or, for a CPU framework, its twin)."""
    from .ops.cuda_mh import metropolis_hastings_fused
    args, kw = _fused_args(fw, theta0, cfg)
    return metropolis_hastings_fused(*args, rwalk_std=cfg.rwalk_std,
                                     priors=cfg.priors, **kw)


def run_fused_ensemble(fw, theta0, cfg: RunConfig):
    """The fused Goodman-Weare ensemble kernel (or its twin)."""
    from .ops.cuda_mh import ensemble_fused
    args, kw = _fused_args(fw, theta0, cfg)
    return ensemble_fused(*args, a=float(cfg.stretch_a),
                          tile_chains=cfg.tile_chains, priors=cfg.priors,
                          **kw)


def run_fused_pt(fw, theta0, cfg: RunConfig):
    """The fused parallel-tempering kernel (or its twin)."""
    from .ops.cuda_pt import parallel_tempering_fused
    args, kw = _fused_args(fw, theta0, cfg)
    out, swap_rate = parallel_tempering_fused(
        *args, temperatures=tuple(cfg.temperatures),
        swap_every=cfg.swap_every, rwalk_std=cfg.rwalk_std,
        priors=cfg.priors, **kw)
    log.info("parallel tempering (fused): mean cold-pair swap acceptance "
             "%.3f per proposal over %d temperatures",
             float(swap_rate.mean()), len(cfg.temperatures))
    return out


def run_pmmh(fw, theta0, cfg: RunConfig):
    """The fused particle-marginal MH kernel (or its twin), Euler-Maruyama
    or Milstein (``cfg.sde_method``: ``odelib_tpu/dispatch.py`` routes both
    to the fused kernel), as an ``MHOutput`` whose ``rsquared`` is NaN: a
    noisy likelihood estimate has no single trajectory to take R^2 of."""
    from .ops.cuda_pf import pmmh_fused
    from .samplers.mh import MHOutput
    th0 = torch.as_tensor(np.asarray(theta0, np.float32), device=fw.device)
    out = pmmh_fused(
        fw._spec, fw._obsdata_fit_host, fw._times_fit, fw.get_inits(), th0,
        seed=int(fw.random_seed) + cfg.seed_offset, nits=cfg.nits,
        burnin=cfg.burnin, walk_mask=cfg.mask, rwalk_std=cfg.rwalk_std,
        n_particles=cfg.n_particles, substeps=cfg.sde_substeps,
        sde_method=cfg.sde_method, priors=cfg.priors, adapt_proposal=cfg.adapt_proposal,
        target_accept=cfg.target_accept, adapt_rate=cfg.adapt_rate,
        **_checkpoint_args(cfg))
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
