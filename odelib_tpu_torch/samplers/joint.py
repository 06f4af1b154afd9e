"""Joint multi-experiment sampling: the survey and the XLA joint samplers.

Counterpart of ``odelib_tpu/samplers/joint.py``: :func:`joint_survey`,
the total chi of joint parameter draws (the sum over experiments of
:func:`~odelib_tpu_torch.model.chi_of_theta` on each experiment's
gathered theta); :func:`joint_metropolis_hastings` and
:func:`joint_metropolis_hastings_checkpointed`, the reference's XLA joint
MH, every chain a lane of each iteration's K batched fixed-step solves;
and :func:`joint_pmmh`, particle-marginal MH over any mix of deterministic
experiments (exact chi) and stochastic ones (a bootstrap filter's
estimate, :mod:`odelib_tpu_torch.samplers.pf`). Each chain carries its key
and splits it every iteration (``split(key, 3)``; joint PMMH
``split(key, 4)``), so a checkpoint stores the keys; the draws are the
reference's ``jax.random`` stream (:mod:`odelib_tpu_torch.random`) and
the samplers compute in float64. ``JointFit.MCMC`` runs the fused joint
kernel (:mod:`odelib_tpu_torch.ops.cuda_joint`) where ``odelib_tpu`` runs
its Pallas kernel, and these samplers elsewhere.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import random as jr
from ..model import chi_of_theta
from .mh import chain_inputs, check_run

__all__ = ["JointOutput", "joint_survey", "joint_metropolis_hastings",
           "joint_metropolis_hastings_checkpointed", "joint_pmmh"]


class JointOutput(NamedTuple):
    theta: Any             # (C, R, D) joint parameter records
    chi: Any               # (C, R) total chi
    chi_parts: Any         # (C, R, K) per-experiment chi
    acceptance_ratio: Any  # (C, R)
    iteration: Any         # (R,)


def _normalize_idx_maps(specs, idx_maps, D):
    """Range-checked per-experiment gather maps, as tuples."""
    idx_maps = tuple(tuple(int(i) for i in m) for m in idx_maps)
    for s, m in zip(specs, idx_maps):
        if len(m) != s.theta_size:
            raise ValueError(f"idx map length {len(m)} != spec theta size "
                             f"{s.theta_size}")
        if any(i < 0 or i >= D for i in m):
            raise ValueError(f"idx map {m} out of range for joint size {D}")
    return idx_maps


def _normalize_substeps_list(substeps, substeps_list, K):
    """Per-experiment substeps: ``substeps_list`` (length K, one int or
    per-interval schedule per experiment) wins; else the shared
    ``substeps`` is broadcast."""
    if substeps_list is not None:
        if len(substeps_list) != K:
            raise ValueError(f"substeps_list must have {K} entries, got "
                             f"{len(substeps_list)}")
        return tuple(s if isinstance(s, int) else tuple(int(v) for v in s)
                     for s in substeps_list)
    one = substeps if isinstance(substeps, (int, tuple)) \
        else tuple(int(v) for v in substeps)
    return tuple([one] * K)


def _total_chi_fn(specs, idx_maps, obs_list, times_list, y0_list, method,
                  substeps_list):
    """``total_chi(theta (N, D)) -> (chi (N,), parts (N, K))``: each
    experiment's chi on its gathered theta, summed in experiment order."""
    idx = [list(m) for m in idx_maps]

    def total_chi(theta):
        parts = [chi_of_theta(sp, obs, theta[:, ix], y0, times,
                              method=method, substeps=sub)
                 for sp, ix, obs, times, y0, sub in zip(
                     specs, idx, obs_list, times_list, y0_list,
                     substeps_list)]
        return _summed(parts), torch.stack(parts, -1)
    return total_chi


def _summed(parts):
    tot = parts[0]
    for p in parts[1:]:
        tot = tot + p
    return tot


def joint_survey(specs, idx_maps, obs_list, times_list, y0_list, thetas, *,
                 method: str = "fixed_dopri5", substeps=4,
                 substeps_list=None):
    """Batched joint chi for (N, D) joint draws -> (N,) total chi, the
    experiments' chi added in experiment order, in the draws' dtype and on
    their device. ``substeps`` is shared across experiments;
    ``substeps_list`` gives one entry per experiment (int or per-interval
    schedule) and wins."""
    specs = tuple(specs)
    thetas = torch.atleast_2d(torch.as_tensor(thetas))
    idx_maps = _normalize_idx_maps(specs, idx_maps, thetas.shape[-1])
    subs = _normalize_substeps_list(substeps, substeps_list, len(specs))
    return _total_chi_fn(specs, idx_maps, obs_list, times_list, y0_list,
                         method, subs)(thetas)[0]


def _inputs(specs, idx_maps, theta0, keys, walk_mask, nits, burnin,
            use_priors, prior_logpdf, substeps, substeps_list, device):
    burnin = check_run(nits, burnin, use_priors, prior_logpdf)
    theta0, keys, mask = chain_inputs(theta0, keys, walk_mask, device)
    specs = tuple(specs)
    idx_maps = _normalize_idx_maps(specs, idx_maps, theta0.shape[-1])
    subs = _normalize_substeps_list(substeps, substeps_list, len(specs))
    return burnin, specs, idx_maps, subs, theta0, keys, mask


def _joint_launcher(total_chi, theta0, keys, mask, *, nits, burnin,
                    rwalk_std, prior_logpdf, use_priors):
    """``make(R_chunk=None) -> launch(it_base=0, state=None)`` for
    :func:`~odelib_tpu_torch.ops.chunked.run`: the whole run's
    post-burn-in records (theta, chi, the (R, C, K) parts, the acceptance
    ratio), or a chunk's records and the state after it, a (D + K + 4, C)
    float64 tensor (log-theta, chi, the K parts, the accept count, the
    carried key's two words)."""
    C, D = theta0.shape
    dt, dev = theta0.dtype, theta0.device

    def init():
        chi, parts = total_chi(theta0)
        return torch.cat([torch.log(theta0).t(), chi[None], parts.t(),
                          torch.zeros((1, C), dtype=dt, device=dev),
                          keys.t().to(dt)])

    def make(R_chunk=None):
        def launch(it_base=0, state=None):
            st = init() if state is None else state
            K = st.shape[0] - D - 4
            lt, chi = st[:D].t(), st[D]
            parts, acc = st[D + 1:D + 1 + K].t(), st[D + 1 + K]
            key = st[D + 2 + K:].t().to(torch.int64)
            if R_chunk is None:
                lo, hi, first = 1, nits, burnin + 1
            else:
                lo, hi = it_base + 1, it_base + 1 + R_chunk
                first = lo
            R = hi - first
            recs = (torch.empty((R, C, D), dtype=dt, device=dev),
                    torch.empty((R, C), dtype=dt, device=dev),
                    torch.empty((R, C, K), dtype=dt, device=dev),
                    torch.empty((R, C), dtype=dt, device=dev))
            for it in range(lo, hi):
                key, k_eps, k_u = jr.split(key, 3).unbind(-2)
                eps = rwalk_std * jr.normal(k_eps, (D,), dt)
                prop = lt + eps * mask
                chi_n, parts_n = total_chi(torch.exp(prop))
                log_ratio = chi - chi_n
                if use_priors:
                    log_ratio = log_ratio + (prior_logpdf(torch.exp(prop))
                                             - prior_logpdf(torch.exp(lt)))
                u = jr.uniform(k_u, (), dt)
                accept = torch.exp(log_ratio) > u     # NaN: rejected
                lt = torch.where(accept[:, None], prop, lt)
                chi = torch.where(accept, chi_n, chi)
                parts = torch.where(accept[:, None], parts_n, parts)
                acc = acc + accept.to(dt)
                r = it - first
                if r >= 0 and it > burnin:
                    recs[0][r] = torch.exp(lt)
                    recs[1][r], recs[2][r] = chi, parts
                    recs[3][r] = acc / torch.full_like(acc, float(it))
            if R_chunk is None:
                return recs
            return recs, torch.cat([lt.t(), chi[None], parts.t(),
                                    acc[None], key.t().to(dt)])
        return launch
    return make


def _joint_output(recs, nits, burnin, device):
    th, chi, parts, ar = recs
    return JointOutput(theta=th.permute(1, 0, 2), chi=chi.t(),
                       chi_parts=parts.permute(1, 0, 2),
                       acceptance_ratio=ar.t(),
                       iteration=torch.arange(1, nits, device=device)
                       [burnin:])


def joint_metropolis_hastings(
        specs: Tuple, idx_maps, obs_list, times_list, y0_list, theta0,
        keys, *, nits: int = 1000, burnin: Optional[int] = None,
        walk_mask=None, rwalk_std: float = 0.05, prior_logpdf=None,
        use_priors: bool = False, method: str = "fixed_dopri5", substeps=4,
        substeps_list=None, device="cuda") -> JointOutput:
    """Run C joint chains over K experiments (``odelib_tpu``'s XLA
    ``joint_metropolis_hastings``).

    ``idx_maps[k]``: experiment k's joint-theta index of each of its
    parameters; ``obs_list``/``times_list``/``y0_list`` per experiment
    (host observations, grids, initial states); ``theta0`` (C, D) in the
    joint layout (a tensor runs on its device, an array on ``device``),
    ``keys`` (C, 2), each chain's key split every iteration into the next
    key and the proposal and accept keys. ``prior_logpdf(theta (N, D)) ->
    (N,)`` with ``use_priors``; the solves are fixed-step (``method``
    'fixed_dopri5' or 'rk4', ``substeps`` or ``substeps_list``). Other
    conventions as :func:`~odelib_tpu_torch.samplers.mh.
    metropolis_hastings`."""
    burnin, specs, idx_maps, subs, theta0, keys, mask = _inputs(
        specs, idx_maps, theta0, keys, walk_mask, nits, burnin, use_priors,
        prior_logpdf, substeps, substeps_list, device)
    total_chi = _total_chi_fn(specs, idx_maps, obs_list, times_list,
                              y0_list, method, subs)
    make = _joint_launcher(total_chi, theta0, keys, mask, nits=int(nits),
                           burnin=burnin, rwalk_std=float(rwalk_std),
                           prior_logpdf=prior_logpdf,
                           use_priors=bool(use_priors))
    return _joint_output(make()(), nits, burnin, theta0.device)


def joint_metropolis_hastings_checkpointed(
        specs, idx_maps, obs_list, times_list, y0_list, theta0, keys, *,
        nits: int = 1000, burnin: Optional[int] = None, walk_mask=None,
        rwalk_std: float = 0.05, prior_logpdf=None,
        use_priors: bool = False, method: str = "fixed_dopri5",
        substeps=4, substeps_list=None, config_token: str = "",
        checkpoint_every: int = 100, checkpoint_path: Optional[str] = None,
        resume_from: Optional[str] = None,
        _stop_after_chunks: Optional[int] = None,
        device="cuda") -> Optional[JointOutput]:
    """:func:`joint_metropolis_hastings` in chunks of ``checkpoint_every``
    proposals (:func:`~odelib_tpu_torch.ops.chunked.run`): after each, the
    chain state with the carried keys and the records so far go to
    ``checkpoint_path`` (the port's npz progress format), and
    ``resume_from`` continues from such a file, bitwise the uninterrupted
    run; a file of another configuration, ``config_token`` or package
    raises ``ValueError``. ``_stop_after_chunks`` returns None after that
    many chunks, as a killed run."""
    from ..ops import chunked
    burnin, specs, idx_maps, subs, theta0, keys, mask = _inputs(
        specs, idx_maps, theta0, keys, walk_mask, nits, burnin, use_priors,
        prior_logpdf, substeps, substeps_list, device)
    total_chi = _total_chi_fn(specs, idx_maps, obs_list, times_list,
                              y0_list, method, subs)
    make = _joint_launcher(total_chi, theta0, keys, mask, nits=int(nits),
                           burnin=burnin, rwalk_std=float(rwalk_std),
                           prior_logpdf=prior_logpdf,
                           use_priors=bool(use_priors))
    static = ("xla-joint", tuple(s.pnames for s in specs), idx_maps,
              tuple(theta0.shape), int(nits), burnin, float(rwalk_std),
              tuple(float(w) for w in mask.cpu()), bool(use_priors), method,
              subs, str(config_token))
    recs = chunked.run(make, "joint MCMC", static, nits=int(nits),
                       burnin=burnin, device=theta0.device,
                       checkpoint_every=int(checkpoint_every),
                       checkpoint_path=checkpoint_path,
                       resume_from=resume_from, stop_after=_stop_after_chunks)
    if recs is None:
        return None
    return _joint_output(recs, nits, burnin, theta0.device)


def joint_pmmh(specs: Tuple, idx_maps, obs_list, times_list, y0_list,
               theta0, keys, *, stoch_blocks, nits: int = 1000,
               burnin: Optional[int] = None, walk_mask=None,
               rwalk_std: float = 0.05, prior_logpdf=None,
               use_priors: bool = False, method: str = "fixed_dopri5",
               substeps=4, substeps_list=None, n_particles: int = 128,
               sde_substeps: int = 4, sde_method: str = "euler",
               adapt_proposal: bool = False, target_accept: float = 0.3,
               adapt_rate: float = 0.05, device="cuda") -> JointOutput:
    """Joint particle-marginal MH over K experiments, any mix of
    deterministic and stochastic (``diffusion=``) models (``odelib_tpu``'s
    ``joint_pmmh``): the ratio sums the deterministic experiments' exact
    chi and a fresh ``n_particles`` bootstrap-filter estimate for each
    stochastic one (experiment k's filter key ``fold_in(k_pf, k)``), the
    incumbent's total kept between acceptances. ``stoch_blocks[k]`` is
    :func:`~odelib_tpu_torch.samplers.pf.obs_blocks` of experiment k's
    observations for a stochastic experiment, None for a deterministic
    one. Keys: ``key, k0 = split(key)`` for the start's estimate, then
    ``key, k_eps, k_u, k_pf = split(key, 4)`` every iteration.
    ``adapt_proposal`` adapts a per-chain multiplier of ``rwalk_std``
    toward ``target_accept`` during burn-in only."""
    from .pf import _filter
    burnin, specs, idx_maps, subs, theta0, keys, mask = _inputs(
        specs, idx_maps, theta0, keys, walk_mask, nits, burnin, use_priors,
        prior_logpdf, substeps, substeps_list, device)
    stoch_blocks = tuple(stoch_blocks)
    if len(stoch_blocks) != len(specs):
        raise ValueError("stoch_blocks needs one entry per experiment")
    for s, b in zip(specs, stoch_blocks):
        if (b is not None) != (s.diffusion is not None):
            raise ValueError("stoch_blocks entries must be observation "
                             "plans exactly for the diffusion= specs")
    if not any(b is not None for b in stoch_blocks):
        raise ValueError("no stochastic experiment; use "
                         "joint_metropolis_hastings")
    C, D = theta0.shape
    dt, dev = theta0.dtype, theta0.device
    nits, rwalk_std = int(nits), float(rwalk_std)
    adapt, target, rate = (bool(adapt_proposal), float(target_accept),
                           float(adapt_rate))
    scorers = []
    for sp, ix, obs, times, y0, sub, blocks in zip(
            specs, idx_maps, obs_list, times_list, y0_list, subs,
            stoch_blocks):
        ix = list(ix)
        if blocks is None:
            scorers.append(lambda th, k, sp=sp, ix=ix, obs=obs, times=times,
                           y0=y0, sub=sub: chi_of_theta(
                               sp, obs, th[:, ix], y0, times, method=method,
                               substeps=sub))
            continue
        pf = _filter(sp, blocks, times, n_particles=int(n_particles),
                     substeps=int(sde_substeps), sde_method=str(sde_method),
                     dtype=dt, device=dev)
        y0t = torch.as_tensor(np.asarray(y0, np.float64), dtype=dt,
                              device=dev)
        scorers.append(lambda th, k, sp=sp, ix=ix, pf=pf, y0t=y0t: pf(
            th[:, ix], k, sp.override_inits(y0t, th[:, ix])))

    def total_chi(theta, key):
        parts = [score(theta, jr.fold_in(key, k) if stoch_blocks[k]
                       is not None else None)
                 for k, score in enumerate(scorers)]
        return _summed(parts), torch.stack(parts, -1)

    key, k0 = jr.split(keys).unbind(-2)
    lt = torch.log(theta0)
    chi, parts = total_chi(theta0, k0)
    acc = torch.zeros(C, dtype=dt, device=dev)
    ls = torch.zeros(C, dtype=dt, device=dev)
    R = nits - 1 - burnin
    recs = (torch.empty((R, C, D), dtype=dt, device=dev),
            torch.empty((R, C), dtype=dt, device=dev),
            torch.empty((R, C, len(specs)), dtype=dt, device=dev),
            torch.empty((R, C), dtype=dt, device=dev))
    for it in range(1, nits):
        key, k_eps, k_u, k_pf = jr.split(key, 4).unbind(-2)
        std = rwalk_std * torch.exp(ls)[:, None] if adapt else rwalk_std
        eps = std * jr.normal(k_eps, (D,), dt)
        prop = lt + eps * mask
        chi_n, parts_n = total_chi(torch.exp(prop), k_pf)
        # the incumbent's estimate stays between acceptances
        log_ratio = chi - chi_n
        if use_priors:
            log_ratio = log_ratio + (prior_logpdf(torch.exp(prop))
                                     - prior_logpdf(torch.exp(lt)))
        u = jr.uniform(k_u, (), dt)
        accept = torch.exp(log_ratio) > u     # NaN: rejected
        a = accept.to(dt)
        if adapt and it <= burnin:
            ls = ls + rate * (a - target)
        lt = torch.where(accept[:, None], prop, lt)
        chi = torch.where(accept, chi_n, chi)
        parts = torch.where(accept[:, None], parts_n, parts)
        acc = acc + a
        r = it - burnin - 1
        if r >= 0:
            recs[0][r] = torch.exp(lt)
            recs[1][r], recs[2][r] = chi, parts
            recs[3][r] = acc / torch.full_like(acc, float(it))
    return _joint_output(recs, nits, burnin, dev)
