"""Batched Metropolis-Hastings: the scan sampler, the record structure and
the survey.

Counterpart of ``odelib_tpu/samplers/mh.py``: :class:`MHOutput`, the
record layout every MH path returns; :func:`metropolis_hastings`, the
reference's XLA scan sampler, and :func:`metropolis_hastings_checkpointed`;
and :func:`survey`, the chi of many parameter draws through the adaptive
solver. The scan sampler is a Python loop over iterations in which every
chain is a lane of one batched solve (:func:`~odelib_tpu_torch.model.
integrate_theta`: adaptive Dopri5, Kvaerno3/5 and 'auto', or fixed steps),
on the device of ``theta0``; its draws are ``jax.random``'s
(:mod:`odelib_tpu_torch.random`), so accept sequences are the
reference's. It computes in float64, whatever ``theta0``'s dtype (the
reference's XLA samplers take ``jnp.result_type(float)``). The main
path's fused kernel is :mod:`odelib_tpu_torch.ops.cuda_mh`.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import random as jr
from ..model import (ModelSpec, ObsData, chi_of_theta, device_obs,
                     device_tensor, fit_metrics, integrate_theta,
                     state_func)  # noqa: F401


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


def metrics_fn(spec: ModelSpec, obs: ObsData, times, y0_base, num_params,
               like, **ikw):
    """``metrics(theta (N, P)) -> (chi, rsq, aic)``: one batched solve of
    every row from ``y0_base`` with the '<s>0' overrides, scored by
    :func:`~odelib_tpu_torch.model.fit_metrics`, in ``like``'s dtype and
    device (the observations copied there once)."""
    y0 = torch.as_tensor(np.asarray(y0_base, np.float64), dtype=like.dtype,
                         device=like.device)
    obs = device_obs(obs, like.dtype, like.device)
    times = np.asarray(times, np.float64)

    def metrics(theta):
        ys = integrate_theta(spec, theta, spec.override_inits(y0, theta),
                             times, **ikw)
        return fit_metrics(spec, obs, ys, num_params)
    return metrics


def check_run(nits, burnin, use_priors, prior_logpdf):
    """The reference's argument checks; returns the resolved burn-in."""
    if burnin is None:
        burnin = int(nits / 2)
    if nits - 1 <= burnin:
        raise ValueError(f"nits={nits} leaves no recorded iterations after "
                         f"burnin={burnin}")
    if use_priors and prior_logpdf is None:
        raise ValueError("use_priors=True requires prior_logpdf")
    return int(burnin)


def chain_inputs(theta0, keys, walk_mask, device):
    """theta0 (C, P) as a float64 tensor on its device (an array on
    ``device``), the keys (C, 2) beside it and the walk mask (P,)."""
    theta0 = device_tensor(theta0, torch.float64, device)
    if theta0.ndim == 1:
        theta0 = theta0[None]
    P = theta0.shape[-1]
    keys = torch.as_tensor(keys, dtype=torch.int64).to(theta0.device)
    if keys.ndim == 1:
        keys = keys[None]
    mask = torch.ones(P, dtype=theta0.dtype, device=theta0.device) \
        if walk_mask is None else torch.as_tensor(
            np.ravel(np.asarray(walk_mask, np.float64)), dtype=theta0.dtype,
            device=theta0.device)
    return theta0, keys, mask


def solver_kw(method, rtol, atol, max_steps, substeps):
    return dict(method=method, rtol=float(rtol), atol=float(atol),
                max_steps=int(max_steps),
                substeps=substeps if isinstance(substeps, tuple)
                else int(substeps))


def _mh_launcher(spec, obs, times, y0_base, theta0, keys, mask, *, nits,
                 burnin, rwalk_std, prior_logpdf, use_priors, ikw):
    """``make(R_chunk=None) -> launch(it_base=0, state=None)`` for
    :func:`~odelib_tpu_torch.ops.chunked.run`: the whole run's post-burn-in
    records, or with ``R_chunk`` the records of proposals ``it_base + 1 ..
    it_base + R_chunk`` and the state after them, a (P + 6, C) float64
    tensor (log-theta, chi, R^2, AIC, the accept count, the key's two
    words)."""
    C, P = theta0.shape
    dt = theta0.dtype
    num = int(torch.count_nonzero(theta0[0]))
    metrics = metrics_fn(spec, obs, times, y0_base, num, theta0, **ikw)

    def init():
        chi, rsq, aic = metrics(theta0)
        return torch.cat([torch.log(theta0).t(), chi[None], rsq[None],
                          aic[None], torch.zeros((1, C), dtype=dt,
                                                 device=theta0.device),
                          keys.t().to(dt)])

    def make(R_chunk=None):
        def launch(it_base=0, state=None):
            st = init() if state is None else state
            lt, chi, rsq, aic, acc = (st[:P].t(), st[P], st[P + 1],
                                      st[P + 2], st[P + 3])
            ks = st[P + 4:].t().to(torch.int64)
            if R_chunk is None:
                lo, hi, first = 1, nits, burnin + 1
            else:
                lo, hi = it_base + 1, it_base + 1 + R_chunk
                first = lo
            R = hi - first
            recs = (torch.empty((R, C, P), dtype=dt, device=st.device),) \
                + tuple(torch.empty((R, C), dtype=dt, device=st.device)
                        for _ in range(4))
            for it in range(lo, hi):
                k_eps, k_u = jr.split(jr.fold_in(ks, it)).unbind(-2)
                eps = rwalk_std * jr.normal(k_eps, (P,), dt)
                prop = lt + eps * mask
                chi_n, rsq_n, aic_n = metrics(torch.exp(prop))
                log_ratio = chi - chi_n
                if use_priors:
                    log_ratio = log_ratio + (prior_logpdf(torch.exp(prop))
                                             - prior_logpdf(torch.exp(lt)))
                u = jr.uniform(k_u, (), dt)
                # a NaN chi_new gives a NaN ratio, which compares False
                accept = torch.exp(log_ratio) > u
                lt = torch.where(accept[:, None], prop, lt)
                chi = torch.where(accept, chi_n, chi)
                rsq = torch.where(accept, rsq_n, rsq)
                aic = torch.where(accept, aic_n, aic)
                acc = acc + accept.to(dt)
                r = it - first
                if r >= 0 and it > burnin:
                    recs[0][r] = torch.exp(lt)
                    recs[1][r], recs[2][r], recs[3][r] = chi, rsq, aic
                    recs[4][r] = acc / torch.full_like(acc, float(it))
            if R_chunk is None:
                return recs
            return recs, torch.cat([lt.t(), chi[None], rsq[None], aic[None],
                                    acc[None], ks.t().to(dt)])
        return launch
    return make


def _mh_output(recs, nits, burnin, device):
    th, chi, rsq, aic, ar = recs
    return MHOutput(theta=th.permute(1, 0, 2), chi=chi.t(),
                    rsquared=rsq.t(), aic=aic.t(), acceptance_ratio=ar.t(),
                    iteration=torch.arange(1, nits, device=device)[burnin:])


def metropolis_hastings(
        spec: ModelSpec, obs: ObsData, times, y0_base, theta0, keys, *,
        nits: int = 1000, burnin: Optional[int] = None, walk_mask=None,
        rwalk_std: float = 0.05, prior_logpdf: Optional[Callable] = None,
        use_priors: bool = False, method: str = "dopri5", rtol: float = 1e-6,
        atol: float = 1e-4, max_steps: int = 4096, substeps: int = 4,
        device="cuda") -> MHOutput:
    """Run C independent MH chains, every chain a lane of each
    iteration's batched solve (``odelib_tpu``'s XLA scan sampler).

    ``theta0`` (C, P) positive starts: a tensor runs on its device, an
    array on ``device`` (the card by default; without CUDA pass
    ``device='cpu'``). ``keys`` (C, 2): per-chain keys
    (:mod:`odelib_tpu_torch.random`); iteration ``it`` draws from
    ``split(fold_in(key, it))``, so any chunking replays the same draws.
    ``walk_mask`` (P,) 1.0 for walked slots, 0.0 for static ones;
    ``prior_logpdf(theta (N, P)) -> (N,)`` (with ``use_priors``). The walk
    is multiplicative in log space with std ``rwalk_std``; a proposal is
    accepted when ``exp(chi - chi_new [+ log prior ratio]) > u``, a NaN
    chi rejected; burn-in proposals are not recorded and the acceptance
    ratio is the accept count over ``it``. Solver: ``method`` as
    :func:`~odelib_tpu_torch.model.integrate_theta`."""
    burnin = check_run(nits, burnin, use_priors, prior_logpdf)
    theta0, keys, mask = chain_inputs(theta0, keys, walk_mask, device)
    make = _mh_launcher(spec, obs, times, y0_base, theta0, keys, mask,
                        nits=int(nits), burnin=burnin,
                        rwalk_std=float(rwalk_std),
                        prior_logpdf=prior_logpdf,
                        use_priors=bool(use_priors),
                        ikw=solver_kw(method, rtol, atol, max_steps,
                                      substeps))
    return _mh_output(make()(), nits, burnin, theta0.device)


def metropolis_hastings_checkpointed(
        spec: ModelSpec, obs: ObsData, times, y0_base, theta0, keys, *,
        nits: int = 1000, burnin: Optional[int] = None, walk_mask=None,
        rwalk_std: float = 0.05, prior_logpdf: Optional[Callable] = None,
        use_priors: bool = False, method: str = "dopri5", rtol: float = 1e-6,
        atol: float = 1e-4, max_steps: int = 4096, substeps: int = 4,
        config_token: str = "", checkpoint_every: int = 100,
        checkpoint_path: Optional[str] = None,
        resume_from: Optional[str] = None,
        _stop_after_chunks: Optional[int] = None, device="cuda"):
    """:func:`metropolis_hastings` in chunks of ``checkpoint_every``
    proposals (:func:`~odelib_tpu_torch.ops.chunked.run`): after each, the
    chain state with the keys' words and the records so far go to
    ``checkpoint_path`` (the port's npz progress format; a file of another
    configuration, ``config_token`` or package fails ``resume_from`` with
    ``ValueError``). Draws are counted on the global iteration, so a
    chunked, killed or resumed run is bitwise the whole run.
    ``_stop_after_chunks`` returns None after that many chunks, as a
    killed run."""
    from ..ops import chunked
    burnin = check_run(nits, burnin, use_priors, prior_logpdf)
    theta0, keys, mask = chain_inputs(theta0, keys, walk_mask, device)
    ikw = solver_kw(method, rtol, atol, max_steps, substeps)
    make = _mh_launcher(spec, obs, times, y0_base, theta0, keys, mask,
                        nits=int(nits), burnin=burnin,
                        rwalk_std=float(rwalk_std),
                        prior_logpdf=prior_logpdf,
                        use_priors=bool(use_priors), ikw=ikw)
    static = ("xla-mh", spec.pnames, spec.pshapes, tuple(theta0.shape),
              int(nits), burnin, float(rwalk_std),
              tuple(float(w) for w in mask.cpu()), bool(use_priors),
              ikw["method"], ikw["rtol"], ikw["atol"], ikw["max_steps"],
              ikw["substeps"], str(config_token))
    recs = chunked.run(make, "MCMC", static, nits=int(nits), burnin=burnin,
                       device=theta0.device,
                       checkpoint_every=int(checkpoint_every),
                       checkpoint_path=checkpoint_path,
                       resume_from=resume_from, stop_after=_stop_after_chunks)
    if recs is None:
        return None
    return _mh_output(recs, nits, burnin, theta0.device)
