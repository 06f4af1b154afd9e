"""Bootstrap particle filter and particle-marginal MH (PMMH) for SDE models.

Counterpart of ``odelib_tpu/samplers/pf.py``, the reference's XLA filter:
:func:`obs_blocks` plans the observation rows by grid time on the host,
:func:`particle_filter_chi` estimates the generalized chi (the negative
marginal log-likelihood) of each parameter vector with a K-particle
bootstrap filter, :func:`pmmh` and :func:`pmmh_checkpointed` sample with
pseudo-marginal MH (the incumbent's estimate is kept, never re-drawn), and
:func:`tune_particles` picks K by the var(log-likelihood) rule. The fused
kernel of the main path is :mod:`odelib_tpu_torch.ops.cuda_pf`; this is
where ``MCMC(sampler='pmmh')`` goes when that kernel cannot run the
configuration, or with ``backend='xla'``.

Chains and particles form one batch: the (C, K, S) cloud steps through
each gap between observation times with :func:`~odelib_tpu_torch.ops.sde.
euler_maruyama`, every particle a lane. Draws are the reference's
``jax.random`` stream (:mod:`odelib_tpu_torch.random`): block ``b`` of a
chain's filter key draws its increments from ``normal(fold_in(fold_in(key,
b), 0), (n_substeps, K, S))`` and its resampling uniform from
``fold_in(fold_in(key, b), 1)``; PMMH iteration ``it`` splits
``fold_in(chain key, it)`` into the proposal, accept and filter keys. Values
are float64 (the reference's x64 setting).

Resampling is systematic and has the reference's semantics, which are a
one-hot matrix product ``sel @ parts``: for a finite cloud that is the
gather done here, but a particle whose state is not finite puts NaN into
that state of every particle that does not copy it (0 x inf = 0 x NaN =
NaN), so one diverged particle before the last block makes the estimate
+inf, as it does in the reference; when every weight is dead the
positions are NaN, nothing is selected and the rows are 0 (NaN where a
state is not finite). Divisions by K take a tensor divisor, so the card
and the CPU divide alike.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import random as jr
from .. import stats
from ..model import ModelSpec, ObsData, dose_matrix
from ..ops.sde import flat_schedule, propagate, sde_functions
from .mh import chain_inputs, check_run

__all__ = ["obs_blocks", "particle_filter_chi", "pmmh",
           "pmmh_checkpointed", "tune_particles", "PMMHOutput"]


class _Block(NamedTuple):
    """One observation time's plan: plain tuples."""
    t_idx: int              # index into the integration grid
    state_index: tuple      # per-row post-summation state index
    log_abundance: tuple
    log_sigma: tuple
    abundance: tuple
    censor: Any             # tuple of ints, or None


def obs_blocks(obs: ObsData):
    """Group the observation rows by grid-time index into :class:`_Block`
    plans, ``t_idx`` strictly increasing (host numpy ``obs``)."""
    t_index = np.asarray(obs.t_index)
    out = []
    for t in np.unique(t_index):
        rows = np.where(t_index == t)[0]
        out.append(_Block(
            t_idx=int(t),
            state_index=tuple(int(s) for s in
                              np.asarray(obs.state_index)[rows]),
            log_abundance=tuple(float(v) for v in
                                np.asarray(obs.log_abundance)[rows]),
            log_sigma=tuple(float(v) for v in
                            np.asarray(obs.log_sigma)[rows]),
            abundance=tuple(float(v) for v in
                            np.asarray(obs.abundance)[rows]),
            censor=None if obs.censor is None else tuple(
                int(c) for c in np.asarray(obs.censor)[rows]),
        ))
    return tuple(out)


def _block_chi(spec: ModelSpec, blk, post):
    """Generalized chi of one observation block: ``post`` (..., S_post)
    post-summation states at the block's time -> (...,), the terms of
    :func:`~odelib_tpu_torch.model.score_pred` restricted to the block's
    rows (``blk`` a :class:`_Block`, or its rows as device tensors from
    :func:`_device_block`)."""
    if isinstance(blk, _Block):
        blk = _device_block(blk, post.dtype, post.device)
    rows, log_o, log_s, ab, censor = blk
    pred = post[..., rows]
    return stats.obs_negloglik(spec.obs_model, spec.obs_param, log_o,
                               torch.log(pred), log_s, ab, pred,
                               censor=censor)


def _device_block(blk: _Block, dtype, device):
    """A block's rows as tensors on ``device``, copied once a filter."""
    def t(v, dt=dtype):
        return torch.tensor(v, dtype=dt, device=device)
    return (t(blk.state_index, torch.int64), t(blk.log_abundance),
            t(blk.log_sigma), t(blk.abundance),
            None if blk.censor is None else t(blk.censor, torch.int64))


def logsumexp(x):
    """``jax.scipy.special.logsumexp`` over the last axis: ``log(sum(exp(x
    - m))) + m`` with ``m`` the maximum, or 0 where the maximum is not
    finite (every entry -inf gives -inf)."""
    m = x.max(-1).values
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.log(torch.exp(x - m[..., None]).sum(-1)) + m


def resample(parts, cum, pos):
    """``sel @ parts`` of the reference's systematic resampling, per
    chain: ``parts`` (C, K, S), ``cum`` (C, K) the weights' cumulative
    sums, ``pos`` (C, K) the positions. Row i copies the particle j with
    ``cum[j - 1] <= pos[i] < cum[j]`` (a gather), holds 0 where no j
    qualifies (NaN positions, or a position past the total), and NaN in
    state s where a particle it does not copy is not finite in s (the
    product's 0 x inf and 0 x NaN)."""
    C, K, S = parts.shape
    cumprev = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], -1)
    j = torch.searchsorted(cum.contiguous(), pos.contiguous(), right=True)
    j = j.clamp(max=K - 1)
    hit = (pos >= cumprev.gather(1, j)) & (pos < cum.gather(1, j))
    jj = j[..., None].expand(C, K, S)
    out = torch.where(hit[..., None], parts.gather(1, jj),
                      torch.zeros((), dtype=parts.dtype,
                                  device=parts.device))
    bad = ~torch.isfinite(parts)
    copied_bad = bad.gather(1, jj) & hit[..., None]
    poisoned = bad.sum(1, keepdim=True) > copied_bad.to(torch.int64)
    return torch.where(poisoned, torch.full((), math.nan, dtype=parts.dtype,
                                            device=parts.device), out)


def _filter(spec: ModelSpec, blocks, times, *, n_particles, substeps,
            sde_method, dtype, device):
    """``pf(theta (C, P), keys (C, 2), y0 (S, C), return_filtered)``: the
    bootstrap filter of :func:`particle_filter_chi` with the grid's
    schedule, the doses and the blocks' rows prepared once."""
    if spec.diffusion is None:
        raise ValueError("particle filter requires a spec with a "
                         "diffusion function (make_spec(diffusion=...))")
    if sde_method not in ("euler", "milstein"):
        raise ValueError(f"sde_method must be 'euler' (Euler-Maruyama) or "
                         f"'milstein', got {sde_method!r}")
    K, S = int(n_particles), len(spec.snames)
    substeps = int(substeps)
    times = np.asarray(times.cpu() if isinstance(times, torch.Tensor)
                       else times, np.float64)
    fns = sde_functions(spec, sde_method == "milstein")
    dose = dose_matrix(spec, times)
    k_t = torch.tensor(float(K), dtype=dtype, device=device)
    ar_k = torch.arange(K, dtype=dtype, device=device)
    log_k = float(np.log(float(K)))
    plan, prev = [], 0
    for b, blk in enumerate(blocks):
        seg = None
        if blk.t_idx > prev or (b == 0 and blk.t_idx > 0):
            ii, kk, t0, h, sq, _ = flat_schedule(times[prev:blk.t_idx + 1],
                                                 substeps, dtype)
            rows = None
            if dose is not None:
                rows = [torch.as_tensor(dose[prev + ii[j]], dtype=dtype,
                                        device=device)
                        if kk[j] == 0 else None for j in range(len(h))]
            seg = (t0, h, sq, rows)
            prev = blk.t_idx
        plan.append((seg, _device_block(blk, dtype, device)))

    def pf(theta, keys, y0, return_filtered=False):
        C = theta.shape[0]
        ps = spec.slots(theta.repeat_interleave(K, 0))
        parts = y0.t()[:, None, :].expand(C, K, S)          # (C, K, S)
        loglik = torch.zeros(C, dtype=dtype, device=device)
        filtered = []
        for b, (seg, rows) in enumerate(plan):
            kb = jr.fold_in(keys, b)
            if seg is not None:
                t0, h, sq, dose_rows = seg
                xi = jr.normal(jr.fold_in(kb, 0), (len(h), K, S), dtype)
                xs = xi.permute(1, 3, 0, 2).reshape(len(h), S, C * K)
                y = parts.permute(2, 0, 1).reshape(S, C * K)
                y, _ = propagate(fns, y, ps, t0, h, sq, xs, dose_rows)
                parts = y.reshape(S, C, K).permute(1, 2, 0)
            post = spec.apply_summations(parts)             # (C, K, S_post)
            chi_b = _block_chi(spec, rows, post)            # (C, K)
            # a diverged particle's weight is -inf
            logw = torch.where(torch.isfinite(chi_b), -chi_b,
                               torch.full((), -math.inf, dtype=dtype,
                                          device=device))
            lse = logsumexp(logw)
            loglik = loglik + lse - log_k
            w = torch.exp(logw - lse[:, None])
            cum = torch.cumsum(w, -1)
            u = jr.uniform(jr.fold_in(kb, 1), (), dtype)
            pos = (ar_k + u[:, None]) / k_t * cum[:, -1:]
            if return_filtered:
                filtered.append((post * w[..., None]).sum(1))
            parts = resample(parts, cum, pos)
        chi_hat = -loglik
        if return_filtered:
            return chi_hat, torch.stack(filtered, 1)
        return chi_hat
    return pf


def particle_filter_chi(spec: ModelSpec, blocks, times, y0, theta, key, *,
                        n_particles: int = 128, substeps: int = 4,
                        sde_method: str = "euler",
                        return_filtered: bool = False, device="cuda"):
    """Bootstrap-filter estimate of the generalized chi (the negative
    marginal log-likelihood, up to :func:`~odelib_tpu_torch.stats.
    obs_negloglik`'s data constant) of each parameter vector.

    ``blocks`` from :func:`obs_blocks`; ``times`` the integration grid;
    ``theta`` (P,) or (C, P) (a tensor keeps its device, an array goes to
    ``device``), ``y0`` (S,) or (S, C) initial states (the caller applies
    any '<s>0' overrides), ``key`` (2,) or (C, 2). Returns chi (C,), or a
    scalar for one theta and key; with ``return_filtered`` also the
    filtered means at the observation times, (C, n_blocks, S_post)."""
    from ..model import device_tensor
    theta = device_tensor(theta, torch.float64, device)
    one = torch.as_tensor(key).ndim == 1 and theta.ndim == 1
    theta = torch.atleast_2d(theta)
    keys = torch.as_tensor(key, dtype=torch.int64).to(theta.device)
    keys = keys[None] if keys.ndim == 1 else keys
    theta = theta.expand(keys.shape[0], -1)
    y0 = torch.as_tensor(y0, dtype=torch.float64).to(theta.device)
    y0 = y0[:, None] if y0.ndim == 1 else y0
    y0 = y0.expand(-1, theta.shape[0])
    pf = _filter(spec, blocks, times, n_particles=n_particles,
                 substeps=substeps, sde_method=sde_method,
                 dtype=theta.dtype, device=theta.device)
    out = pf(theta, keys, y0, return_filtered)
    if not one:
        return out
    return (out[0][0], out[1][0]) if return_filtered else out[0]


class PMMHOutput(NamedTuple):
    """Post-burnin samples. Leading axes: (chains, records)."""
    theta: Any             # (C, R, P)
    chi: Any               # (C, R) PF-estimated generalized chi
    aic: Any               # (C, R) 2*chi + 2k (same convention as MH)
    acceptance_ratio: Any  # (C, R)
    iteration: Any         # (R,)


def _pmmh_launcher(spec, obs, times, y0_base, theta0, keys, mask, *, nits,
                   burnin, rwalk_std, prior_logpdf, use_priors, n_particles,
                   substeps, sde_method, adapt_proposal, target_accept,
                   adapt_rate):
    """``make(R_chunk=None) -> launch(it_base=0, state=None)`` for
    :func:`~odelib_tpu_torch.ops.chunked.run`: the whole run's
    post-burn-in records, or the records of proposals ``it_base + 1 ..
    it_base + R_chunk`` and the state after them, a (P + 5, C) float64
    tensor (log-theta, the incumbent's chi, the accept count, the log
    proposal scale, the key's two words). Robbins-Monro adapts the scale
    during burn-in only (``adapt_proposal``); the estimate of the
    incumbent is kept; no Jacobian term enters the ratio."""
    C, P = theta0.shape
    dt, dev = theta0.dtype, theta0.device
    pf = _filter(spec, obs_blocks(obs), times, n_particles=n_particles,
                 substeps=substeps, sde_method=sde_method, dtype=dt,
                 device=dev)
    y0 = torch.as_tensor(np.asarray(y0_base, np.float64), dtype=dt,
                         device=dev)

    def score(theta, k):
        return pf(theta, k, spec.override_inits(y0, theta))

    def init():
        chi = score(theta0, jr.fold_in(keys, 0))
        zero = torch.zeros((1, C), dtype=dt, device=dev)
        return torch.cat([torch.log(theta0).t(), chi[None], zero, zero,
                          keys.t().to(dt)])

    def make(R_chunk=None):
        def launch(it_base=0, state=None):
            st = init() if state is None else state
            lt, chi, acc, ls = st[:P].t(), st[P], st[P + 1], st[P + 2]
            ks = st[P + 3:].t().to(torch.int64)
            if R_chunk is None:
                lo, hi, first = 1, nits, burnin + 1
            else:
                lo, hi = it_base + 1, it_base + 1 + R_chunk
                first = lo
            R = hi - first
            recs = (torch.empty((R, C, P), dtype=dt, device=dev),
                    torch.empty((R, C), dtype=dt, device=dev),
                    torch.empty((R, C), dtype=dt, device=dev))
            for it in range(lo, hi):
                k_eps, k_u, k_pf = jr.split(jr.fold_in(ks, it), 3) \
                    .unbind(-2)
                std = rwalk_std * torch.exp(ls)[:, None] \
                    if adapt_proposal else rwalk_std
                eps = std * jr.normal(k_eps, (P,), dt)
                prop = lt + eps * mask
                theta = torch.exp(prop)
                chi_n = score(theta, k_pf)
                log_ratio = chi - chi_n
                if use_priors:
                    log_ratio = log_ratio + (prior_logpdf(theta)
                                             - prior_logpdf(torch.exp(lt)))
                u = jr.uniform(k_u, (), dt)
                # NaN or inf chi_new: rejected
                accept = torch.exp(log_ratio) > u
                if adapt_proposal and it <= burnin:
                    ls = ls + adapt_rate * (accept.to(dt) - target_accept)
                lt = torch.where(accept[:, None], prop, lt)
                chi = torch.where(accept, chi_n, chi)
                acc = acc + accept.to(dt)
                r = it - first
                if r >= 0 and it > burnin:
                    recs[0][r] = torch.exp(lt)
                    recs[1][r] = chi
                    recs[2][r] = acc / torch.full_like(acc, float(it))
            if R_chunk is None:
                return recs
            return recs, torch.cat([lt.t(), chi[None], acc[None], ls[None],
                                    ks.t().to(dt)])
        return launch
    return make


def _pmmh_setup(spec, theta0, keys, walk_mask, nits, burnin, use_priors,
                prior_logpdf, device):
    if spec.diffusion is None:
        raise ValueError("particle filter requires a spec with a "
                         "diffusion function (make_spec(diffusion=...))")
    burnin = check_run(nits, burnin, use_priors, prior_logpdf)
    theta0, keys, mask = chain_inputs(theta0, keys, walk_mask, device)
    return burnin, theta0, keys, mask


def _pmmh_output(recs, nits, burnin, num, device):
    th, chi, ar = recs
    chi = chi.t()
    return PMMHOutput(theta=th.permute(1, 0, 2), chi=chi,
                      aic=stats.AIC(chi, num), acceptance_ratio=ar.t(),
                      iteration=torch.arange(1, nits, device=device)[burnin:])


def pmmh(spec: ModelSpec, obs: ObsData, times, y0_base, theta0, keys, *,
         nits: int = 1000, burnin: Optional[int] = None, walk_mask=None,
         rwalk_std: float = 0.05, prior_logpdf: Optional[Callable] = None,
         use_priors: bool = False, n_particles: int = 128,
         substeps: int = 4, sde_method: str = "euler",
         adapt_proposal: bool = False, target_accept: float = 0.3,
         adapt_rate: float = 0.05, device="cuda") -> PMMHOutput:
    """Particle-marginal MH over C chains (``odelib_tpu``'s XLA ``pmmh``):
    the random walk of :func:`~odelib_tpu_torch.samplers.mh.
    metropolis_hastings` with the solve and chi replaced by an
    ``n_particles`` bootstrap filter over the spec's SDE (``substeps``
    Euler-Maruyama or Milstein steps an interval of ``times``).

    ``theta0`` (C, P) positive starts (a tensor runs on its device, an
    array on ``device``), ``keys`` (C, 2): iteration ``it`` splits
    ``fold_in(key, it)`` into the proposal, accept and filter keys, and
    the first estimate uses ``fold_in(key, 0)``, so any chunking replays
    the same draws. ``obs`` host numpy observations. ``adapt_proposal``
    adapts a per-chain multiplier of ``rwalk_std`` during burn-in (gain
    ``adapt_rate`` toward ``target_accept``); the recording phase runs the
    frozen kernel. Returns :class:`PMMHOutput`, ``aic = 2 chi + 2
    count_nonzero(theta0[0])``."""
    burnin, theta0, keys, mask = _pmmh_setup(
        spec, theta0, keys, walk_mask, nits, burnin, use_priors,
        prior_logpdf, device)
    make = _pmmh_launcher(
        spec, obs, times, y0_base, theta0, keys, mask, nits=int(nits),
        burnin=burnin, rwalk_std=float(rwalk_std), prior_logpdf=prior_logpdf,
        use_priors=bool(use_priors), n_particles=int(n_particles),
        substeps=int(substeps), sde_method=str(sde_method),
        adapt_proposal=bool(adapt_proposal),
        target_accept=float(target_accept), adapt_rate=float(adapt_rate))
    num = int(torch.count_nonzero(theta0[0]))
    return _pmmh_output(make()(), nits, burnin, num, theta0.device)


def pmmh_checkpointed(
        spec: ModelSpec, obs: ObsData, times, y0_base, theta0, keys, *,
        nits: int = 1000, burnin: Optional[int] = None, walk_mask=None,
        rwalk_std: float = 0.05, prior_logpdf: Optional[Callable] = None,
        use_priors: bool = False, n_particles: int = 128,
        substeps: int = 4, sde_method: str = "euler",
        adapt_proposal: bool = False, target_accept: float = 0.3,
        adapt_rate: float = 0.05, config_token: str = "",
        checkpoint_every: int = 100, checkpoint_path: Optional[str] = None,
        resume_from: Optional[str] = None,
        _stop_after_chunks: Optional[int] = None,
        device="cuda") -> Optional[PMMHOutput]:
    """:func:`pmmh` in chunks of ``checkpoint_every`` proposals
    (:func:`~odelib_tpu_torch.ops.chunked.run`): after each, the chain
    state (log-theta, the incumbent's estimate, the accept count, the log
    proposal scale, the keys' words) and the records so far go to
    ``checkpoint_path`` (the port's npz progress format), and
    ``resume_from`` continues from such a file, bitwise the uninterrupted
    run; a file of another configuration, ``config_token`` or package
    raises ``ValueError``. ``_stop_after_chunks`` returns None after that
    many chunks, as a killed run."""
    from ..ops import chunked
    burnin, theta0, keys, mask = _pmmh_setup(
        spec, theta0, keys, walk_mask, nits, burnin, use_priors,
        prior_logpdf, device)
    kw = dict(nits=int(nits), burnin=burnin, rwalk_std=float(rwalk_std),
              prior_logpdf=prior_logpdf, use_priors=bool(use_priors),
              n_particles=int(n_particles), substeps=int(substeps),
              sde_method=str(sde_method),
              adapt_proposal=bool(adapt_proposal),
              target_accept=float(target_accept),
              adapt_rate=float(adapt_rate))
    make = _pmmh_launcher(spec, obs, times, y0_base, theta0, keys, mask,
                          **kw)
    static = ("xla-pmmh", spec.pnames, spec.pshapes, tuple(theta0.shape),
              kw["nits"], burnin, kw["rwalk_std"],
              tuple(float(w) for w in mask.cpu()), kw["use_priors"],
              kw["n_particles"], kw["substeps"], kw["sde_method"],
              str(config_token), kw["adapt_proposal"], kw["target_accept"],
              kw["adapt_rate"])
    recs = chunked.run(make, "PMMH", static, nits=int(nits), burnin=burnin,
                       device=theta0.device,
                       checkpoint_every=int(checkpoint_every),
                       checkpoint_path=checkpoint_path,
                       resume_from=resume_from, stop_after=_stop_after_chunks)
    if recs is None:
        return None
    num = int(torch.count_nonzero(theta0[0]))
    return _pmmh_output(recs, nits, burnin, num, theta0.device)


def tune_particles(spec: ModelSpec, obs: ObsData, times, y0_base, theta,
                   key, *, pilot_particles: int = 64, n_reps: int = 32,
                   target_var: float = 1.2, substeps: int = 4,
                   sde_method: str = "euler", min_particles: int = 16,
                   max_particles: int = 8192, device="cuda"):
    """Recommend ``n_particles`` for PMMH by the var(log-likelihood) rule:
    ``n_reps`` independent ``pilot_particles`` filters at ``theta`` (P,)
    (keys ``split(key, n_reps)``, one batch), ``v`` the variance of their
    finite estimates (ddof 1), and ``K* = ceil(pilot_particles v /
    target_var)`` clipped to [min_particles, max_particles] and rounded up
    to a multiple of 8. Returns ``(K*, v)``; fewer than 2 finite
    replicates raise ``ValueError``."""
    from ..model import device_tensor
    theta = device_tensor(theta, torch.float64, device)
    if theta.ndim != 1:
        raise ValueError("theta must be a single (P,) parameter vector")
    keys = jr.split(torch.as_tensor(key, dtype=torch.int64)
                    .to(theta.device), int(n_reps))
    thetas = theta[None].expand(int(n_reps), -1)
    y0 = torch.as_tensor(np.asarray(y0_base, np.float64),
                         dtype=theta.dtype, device=theta.device)
    pf = _filter(spec, obs_blocks(obs), times,
                 n_particles=int(pilot_particles), substeps=int(substeps),
                 sde_method=str(sde_method), dtype=theta.dtype,
                 device=theta.device)
    chis = pf(thetas, keys, spec.override_inits(y0, thetas)).cpu().numpy()
    finite = np.isfinite(chis)
    if finite.sum() < 2:
        raise ValueError(
            "particle filter diverged in (almost) every pilot replicate — "
            "the pilot theta is in a blow-up region; tune from a better "
            "point estimate (e.g. fit_survey's best row)")
    v = float(np.var(chis[finite], ddof=1))  # var(-loglik) == var(loglik)
    k_star = int(np.ceil(pilot_particles * v / float(target_var)))
    k_star = int(np.clip(k_star, min_particles, max_particles))
    k_star = -(-k_star // 8) * 8
    return k_star, v
