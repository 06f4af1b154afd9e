"""Per-(route, sampler) MCMC dispatch.

Counterpart of ``odelib_tpu/dispatch.py``. The fused arms are keyed by the
device the framework runs on and the sampler: ``cuda:mh``,
``cuda:ensemble`` and ``cuda:pt`` launch the CUDA kernels, ``cpu:mh``,
``cpu:ensemble`` and ``cpu:pt`` run their torch twins. Both go through the
public wrappers of :mod:`~odelib_tpu_torch.ops.cuda_mh`,
:mod:`~odelib_tpu_torch.ops.cuda_pt` and :mod:`~odelib_tpu_torch.ops.
cuda_pf`, which pick kernel or twin from the tensor's device. PMMH's arm,
:func:`run_pmmh`, runs the fused kernel (or its twin) where the reference
does and its XLA particle filter elsewhere. With ``checkpoint_every`` each
arm runs its kernel in chunks and persists the chain state to
``<checkpoint_path>.progress`` (:mod:`~odelib_tpu_torch.ops.chunked`).
The scan arms ``run_scan_mh``,
``run_scan_ensemble``, ``run_scan_pt``, ``run_hmc`` and ``run_amh`` run
the reference's XLA samplers (:mod:`~odelib_tpu_torch.samplers.mh`,
``ensemble``, ``pt``, ``hmc``, ``amh``) on the
framework's device in float64, every chain a lane of each iteration's
batched solve, with per-chain keys from ``fold_in(PRNGKey(seed), salt *
1_000_003 + i)`` as ``_xla_setup`` derives them. The kernels refuse a
model whose RHS does not trace (:func:`require_kernel_rhs`; PMMH's
eligibility asks the same of the diffusion); the scan arms call such an
RHS per lane (:func:`require_batched`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .utils.profiling import get_logger


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
    sde_substeps: Any = 4          # as given: the kernel needs an int
    sde_method: str = "euler"
    adapt_proposal: bool = False
    adapt_rate: float = 0.05
    target_accept: float = 0.3
    checkpoint_every: Optional[int] = None
    checkpoint_path: Optional[str] = None
    resume_from: Optional[str] = None
    config_token: str = ""
    # the scan arms: the adaptive solver's settings, the prior as a
    # function (None without priors) and the stream salt of a run-length
    # extension
    rtol: float = 1e-6
    atol: float = 1e-4
    max_steps: int = 4096
    prior_logpdf: Any = None
    key_salt: int = 0
    pmmh_mode: str = "auto"        # 'auto' | 'pallas' | 'xla'
    # HMC and adaptive Metropolis (the names of MCMC's keywords)
    n_leapfrog: int = 4
    step_size: float = 0.02
    mass_adapt: bool = True
    path_adapt: bool = False
    max_leapfrog: int = 256
    dense_mass: bool = False
    adapt_start: int = 50


def require_kernel_rhs(spec):
    """``backend='pallas'``'s check: ``ValueError`` when the model's RHS
    does not trace into the kernels (the twins never stand in for
    them)."""
    from .model import rhs_program
    from .rhs import RhsTraceError
    try:
        rhs_program(spec)
    except RhsTraceError as e:
        raise ValueError(
            f"backend='pallas' runs the fused kernels, and {e}; use "
            "backend='xla' (or 'auto')") from e


def require_batched(spec, theta, y0, t0):
    """The scan arms' check of an RHS the tracer refuses: one call of it
    per lane under ``torch.func.vmap`` at ``theta`` (N, P) and ``y0``
    (S,). Python control flow on a value cannot run there and raises
    ``NotImplementedError`` (ROADMAP queue 3)."""
    from .model import traces
    from .rhs import lane_function, vmap_refused
    if traces(spec):
        return
    th = torch.as_tensor(np.asarray(theta, np.float64))[:2]
    y = spec.override_inits(torch.as_tensor(np.asarray(y0, np.float64)), th)
    try:
        lane_function(spec.rhs, spec.pshapes, spec.forcings)(
            float(t0), y, spec.slots(th))
    except RuntimeError as e:
        if not vmap_refused(e):
            raise
        raise NotImplementedError(
            "the RHS neither traces into the kernels nor runs per lane "
            f"under torch.func.vmap ({type(e).__name__}: {e}); Python "
            "control flow on t, a forcing or a state value has no batched "
            "form in the port (ROADMAP queue 3)") from e


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
    get_logger().info("parallel tempering (fused): mean cold-pair swap "
                      "acceptance %.3f per proposal over %d temperatures",
                      float(swap_rate.mean()), len(cfg.temperatures))
    return out


def pmmh_fused_eligible(fw, cfg: RunConfig) -> Tuple[bool, str]:
    """Whether the fused PMMH kernel runs this run, and why not
    (``odelib_tpu``'s ``_pmmh_fused_eligible`` on a device with the
    kernel): Euler-Maruyama or Milstein, 8 to 512 particles in multiples
    of 8 and a drift and diffusion that trace
    (:func:`~odelib_tpu_torch.ops.cuda_pf.pmmh_supported`), priors (with
    ``use_priors``) of in-kernel families, and an int ``sde_substeps``."""
    from .ops.cuda_pf import pmmh_supported
    if not pmmh_supported(fw._spec, cfg.n_particles, cfg.sde_method):
        return False, ("fused PMMH needs euler or milstein, n_particles "
                       "a multiple of 8 in [8, 512], and a "
                       "tile-traceable drift/diffusion")
    if cfg.prior_logpdf is not None and cfg.priors is None:
        return False, "priors are not a kernel-supported family"
    if not isinstance(cfg.sde_substeps, (int, np.integer)):
        return False, "sde_substeps must be an int for the fused kernel"
    return True, ""


def run_pmmh(fw, theta0, cfg: RunConfig):
    """Particle-marginal MH over the stochastic model, routed as
    ``odelib_tpu/dispatch.py`` routes it: the fused kernel (or its twin)
    when :func:`pmmh_fused_eligible` holds and ``cfg.pmmh_mode`` is not
    'xla', else the XLA particle filter's sampler
    (:func:`~odelib_tpu_torch.samplers.pf.pmmh`, or ``pmmh_checkpointed``
    with ``checkpoint_every``) with the scan arms' keys and float64;
    ``pmmh_mode='pallas'`` on an ineligible run raises ``ValueError``. The
    arm is logged. An ``MHOutput`` whose ``rsquared`` is NaN: a noisy
    likelihood estimate has no single trajectory to take R^2 of."""
    from .samplers.mh import MHOutput
    ok, why = pmmh_fused_eligible(fw, cfg)
    if cfg.pmmh_mode == "pallas" and not ok:
        raise ValueError(f"backend='pallas' for sampler='pmmh' is not "
                         f"available here: {why}")
    if cfg.pmmh_mode != "xla" and ok:
        from .ops.cuda_pf import pmmh_fused
        get_logger().info("particle-marginal MH (fused): pf_kernel, %d "
                          "particles", int(cfg.n_particles))
        th0 = torch.as_tensor(np.asarray(theta0, np.float32),
                              device=fw.device)
        out = pmmh_fused(
            fw._spec, fw._obsdata_fit_host, fw._times_fit, fw.get_inits(),
            th0, seed=int(fw.random_seed) + cfg.seed_offset, nits=cfg.nits,
            burnin=cfg.burnin, walk_mask=cfg.mask, rwalk_std=cfg.rwalk_std,
            n_particles=int(cfg.n_particles),
            substeps=int(cfg.sde_substeps), sde_method=cfg.sde_method,
            priors=cfg.priors, adapt_proposal=cfg.adapt_proposal,
            target_accept=cfg.target_accept, adapt_rate=cfg.adapt_rate,
            **_checkpoint_args(cfg))
    else:
        from .samplers import pf
        get_logger().info("particle-marginal MH: the XLA particle filter "
                          "(samplers/pf.py), %d particles (%s)",
                          int(cfg.n_particles), "backend='xla'"
                          if cfg.pmmh_mode == "xla" else why)
        require_batched(fw._spec, theta0, fw.get_inits(), fw._times_fit[0])
        th0, _, keys = _scan_setup(fw, theta0, cfg, len(theta0))
        args = _scan_args(fw, th0, keys)
        kw = dict(nits=cfg.nits, burnin=cfg.burnin, walk_mask=cfg.mask,
                  rwalk_std=cfg.rwalk_std, prior_logpdf=cfg.prior_logpdf,
                  use_priors=cfg.prior_logpdf is not None,
                  n_particles=int(cfg.n_particles),
                  substeps=int(cfg.sde_substeps), sde_method=cfg.sde_method,
                  adapt_proposal=cfg.adapt_proposal,
                  target_accept=cfg.target_accept, adapt_rate=cfg.adapt_rate)
        if cfg.checkpoint_every is not None:
            out = pf.pmmh_checkpointed(*args, **_checkpoint_args(cfg), **kw)
        else:
            out = pf.pmmh(*args, **kw)
    return MHOutput(theta=out.theta, chi=out.chi,
                    rsquared=torch.full_like(out.chi, float("nan")),
                    aic=out.aic, acceptance_ratio=out.acceptance_ratio,
                    iteration=out.iteration)


def _scan_setup(fw, theta0, cfg: RunConfig, n_chains: int):
    """The scan arms' preamble (``_xla_setup`` on one device): theta0 on
    the framework's device in float64, the base key and the chains' keys
    ``fold_in(PRNGKey(seed), key_salt * 1_000_003 + i)``."""
    from . import random as jr
    dev = fw.device
    th0 = torch.as_tensor(np.asarray(theta0, np.float64), device=dev)
    base = jr.PRNGKey(int(fw.random_seed), device=dev)
    keys = jr.fold_in(base, cfg.key_salt * 1_000_003
                      + torch.arange(n_chains, device=dev))
    return th0, base, keys


def _scan_kw(cfg: RunConfig):
    return dict(nits=cfg.nits, burnin=cfg.burnin, walk_mask=cfg.mask,
                prior_logpdf=cfg.prior_logpdf,
                use_priors=cfg.prior_logpdf is not None,
                method=cfg.method, rtol=cfg.rtol, atol=cfg.atol,
                max_steps=cfg.max_steps, substeps=cfg.substeps)


def _scan_args(fw, th0, keys):
    return (fw._spec, fw._obsdata_fit_host, fw._times_fit, fw.get_inits(),
            th0, keys)


def run_scan_mh(fw, theta0, cfg: RunConfig, n_chains: int):
    """The scan MH (``samplers/mh.py``), optionally checkpointed: the
    route of any method, prior family, observation model and RHS."""
    from .samplers import mh
    th0, _, keys = _scan_setup(fw, theta0, cfg, n_chains)
    kw = dict(_scan_kw(cfg), rwalk_std=cfg.rwalk_std)
    if cfg.checkpoint_every is not None:
        return mh.metropolis_hastings_checkpointed(
            *_scan_args(fw, th0, keys), **_checkpoint_args(cfg), **kw)
    return mh.metropolis_hastings(*_scan_args(fw, th0, keys), **kw)


def run_scan_ensemble(fw, theta0, cfg: RunConfig, n_chains: int):
    """The scan Goodman-Weare ensemble (``samplers/ensemble.py``): one
    ensemble of the walkers, padded to an even count of at least 4 by
    repeating the last (the padding is dropped with the records), keyed
    by ``fold_in(PRNGKey(seed), 0xE75)``."""
    from . import random as jr
    from .samplers.ensemble import ensemble_mh
    th0, base, _ = _scan_setup(fw, theta0, cfg, n_chains)
    target = max(4, n_chains + n_chains % 2)
    if target > n_chains:
        th0 = torch.cat([th0, th0[-1:].expand(target - n_chains, -1)])
    return ensemble_mh(*_scan_args(fw, th0, jr.fold_in(base, 0xE75)),
                       a=cfg.stretch_a, **_scan_kw(cfg))


def run_scan_pt(fw, theta0, cfg: RunConfig, n_chains: int):
    """The scan replica-exchange sampler (``samplers/pt.py``), optionally
    checkpointed; logs the mean swap acceptance."""
    from .samplers import pt
    th0, _, keys = _scan_setup(fw, theta0, cfg, n_chains)
    kw = dict(_scan_kw(cfg), rwalk_std=cfg.rwalk_std,
              temperatures=tuple(cfg.temperatures),
              swap_every=cfg.swap_every)
    if cfg.checkpoint_every is not None:
        out, swap_rate = pt.parallel_tempering_checkpointed(
            *_scan_args(fw, th0, keys), **_checkpoint_args(cfg), **kw)
    else:
        out, swap_rate = pt.parallel_tempering(*_scan_args(fw, th0, keys),
                                               **kw)
    get_logger().info("parallel tempering: mean swap acceptance %.3f per "
                      "proposal over %d temperatures",
                      float(swap_rate.mean()), len(cfg.temperatures))
    return out


def run_hmc(fw, theta0, cfg: RunConfig, n_chains: int):
    """HMC through the differentiable fixed-step solve
    (``samplers/hmc.py``), optionally checkpointed. As in ``odelib_tpu``,
    'rk4' runs rk4 and every other method fixed-step Dopri5."""
    from .samplers import hmc
    th0, _, keys = _scan_setup(fw, theta0, cfg, n_chains)
    kw = dict(nits=cfg.nits, burnin=cfg.burnin, walk_mask=cfg.mask,
              n_leapfrog=cfg.n_leapfrog, step_size=cfg.step_size,
              target_accept=cfg.target_accept, mass_adapt=cfg.mass_adapt,
              path_adapt=cfg.path_adapt, max_leapfrog=cfg.max_leapfrog,
              dense_mass=cfg.dense_mass, prior_logpdf=cfg.prior_logpdf,
              use_priors=cfg.prior_logpdf is not None,
              method="rk4" if cfg.method == "rk4" else "fixed_dopri5",
              substeps=cfg.substeps)
    if cfg.checkpoint_every is not None:
        return hmc.hamiltonian_mc_checkpointed(
            *_scan_args(fw, th0, keys), **_checkpoint_args(cfg), **kw)
    return hmc.hamiltonian_mc(*_scan_args(fw, th0, keys), **kw)


def run_amh(fw, theta0, cfg: RunConfig, n_chains: int):
    """Adaptive Metropolis (``samplers/amh.py``) with the configured
    solver, any method."""
    from .samplers.amh import adaptive_metropolis
    th0, _, keys = _scan_setup(fw, theta0, cfg, n_chains)
    return adaptive_metropolis(*_scan_args(fw, th0, keys),
                               rwalk_std=cfg.rwalk_std,
                               adapt_start=cfg.adapt_start, **_scan_kw(cfg))


_ARMS = {f"{dev}:{s}": arm for dev in ("cuda", "cpu")
         for s, arm in (("mh", run_fused_mh),
                        ("ensemble", run_fused_ensemble),
                        ("pt", run_fused_pt),
                        ("pmmh", run_pmmh))}
_SCAN_ARMS = {"xla": run_scan_mh, "ensemble": run_scan_ensemble,
              "pt": run_scan_pt, "hmc": run_hmc, "amh": run_amh}


def dispatch(fw, sampler: str, theta0, cfg: RunConfig, arm: str = "pallas",
             n_chains: Optional[int] = None):
    """Route one resolved MCMC run to its arm: ``'pallas'`` (the fused
    kernel of the framework's device and the sampler; for PMMH
    :func:`run_pmmh`, which takes the kernel or the XLA filter itself), or
    a scan arm, ``'xla'`` (MH), ``'ensemble'``, ``'pt'``, ``'hmc'`` or
    ``'amh'``, the names ``odelib_tpu``'s ``chains[...]`` profile stage
    uses."""
    if arm != "pallas":
        return _SCAN_ARMS[arm](fw, theta0, cfg,
                               len(theta0) if n_chains is None else n_chains)
    key = f"{fw.device.type}:{sampler}"
    if key not in _ARMS:
        raise NotImplementedError(f"no MCMC arm {key!r} in the port yet")
    return _ARMS[key](fw, theta0, cfg)
