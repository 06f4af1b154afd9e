"""Replica-exchange (parallel tempering) MH, the scan form, its
checkpointed run, the ladder tuner and the swap bookkeeping.

Counterpart of ``odelib_tpu/samplers/pt.py``: C chains each carry a ladder
of K rungs (replica k targets ``exp(-E / T_k)``, E = chi - log prior, its
walk scaled by sqrt(T_k)); every iteration solves the C x K proposals as
one batch of lanes, accepts each rung at ``exp(beta_k dE)``, then proposes
swaps between adjacent rungs whose pair parity matches the swap round's,
gated by a finite ``delta`` (a ``perm`` gather, as the reference's). The
key rides the state (split in four each iteration), so a chunked run is
bitwise the whole run. Swap rates are accepted swaps per proposal of each
pair (:func:`swap_attempts`). :func:`tune_ladder` bisects a geometric
ladder's log ratio on pilot runs. The main path's fused kernel is
:mod:`odelib_tpu_torch.ops.cuda_pt`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import random as jr
from .mh import (MHOutput, chain_inputs, check_run, metrics_fn,
                 solver_kw)


def swap_attempts(nits: int, swap_every: int, n_pairs: int) -> np.ndarray:
    """Per-pair PROPOSAL counts over iterations 1..nits-1: pair k is
    proposed on swap rounds whose parity matches k % 2."""
    its = np.arange(1, int(nits))
    rounds = its[its % int(swap_every) == 0]
    parity = (rounds // int(swap_every)) % 2
    return np.array([(parity == (k % 2)).sum() for k in range(n_pairs)],
                    dtype=float)


def validate_ladder(temperatures):
    """The ladder as floats: at least 2 rungs, starting at 1.0, strictly
    increasing (the reference's ``ValueError`` otherwise)."""
    temperatures = tuple(float(t) for t in temperatures)
    if len(temperatures) < 2:
        raise ValueError("parallel tempering needs >= 2 temperatures")
    if temperatures[0] != 1.0:
        raise ValueError("temperatures[0] must be 1.0 (the posterior rung)")
    if any(b >= a for b, a in zip(temperatures, temperatures[1:])):
        raise ValueError("temperatures must be strictly increasing")
    return temperatures


def _pt_launcher(spec, obs, times, y0_base, theta0, keys, mask, *,
                 temperatures, nits, burnin, swap_every, rwalk_std,
                 prior_logpdf, use_priors, ikw):
    """``make(R_chunk=None) -> launch(it_base=0, state=None)`` for
    :func:`~odelib_tpu_torch.ops.chunked.run`, as ``mh._mh_launcher``: the
    state is (K (P + 4) + K + 2, C) float64 (per rung log-theta, chi, R^2,
    AIC and log prior; the cold rung's accept count, the K - 1 pairs' swap
    counts and the key's two words)."""
    C, P = theta0.shape
    K = len(temperatures)
    dt, dev = theta0.dtype, theta0.device
    num = int(torch.count_nonzero(theta0[0]))
    metrics = metrics_fn(spec, obs, times, y0_base, num, theta0, **ikw)
    temps = torch.tensor(temperatures, dtype=dt, device=dev)
    betas = torch.ones_like(temps) / temps
    stds = rwalk_std * torch.sqrt(temps)[:, None]          # (K, 1)
    dbeta = betas[:-1] - betas[1:]
    pair = torch.arange(K - 1, device=dev) % 2
    arange = torch.arange(K, device=dev)

    def energy(z):                      # z (C, K, P)
        flat = torch.exp(z.reshape(C * K, P))
        chi, rsq, aic = metrics(flat)
        lp = prior_logpdf(flat) if use_priors else torch.zeros_like(chi)
        return tuple(v.reshape(C, K) for v in (chi, rsq, aic, lp))

    def pack(lt, chi, rsq, aic, lp, acc, sw, ks):
        return torch.cat([lt.reshape(C, K * P).t(), chi.t(), rsq.t(),
                          aic.t(), lp.t(), acc[None], sw.t(),
                          ks.t().to(dt)])

    def unpack(st):
        rows = st.t()
        o = K * P
        lt = rows[:, :o].reshape(C, K, P)
        chi, rsq, aic, lp = (rows[:, o + i * K:o + (i + 1) * K]
                             for i in range(4))
        o += 4 * K
        return (lt, chi, rsq, aic, lp, rows[:, o], rows[:, o + 1:o + K],
                rows[:, o + K:].to(torch.int64))

    def init():
        lt = torch.log(theta0)[:, None, :].expand(C, K, P)
        chi, rsq, aic, lp = energy(lt)
        return pack(lt, chi, rsq, aic, lp, torch.zeros(C, dtype=dt,
                                                       device=dev),
                    torch.zeros((C, K - 1), dtype=dt, device=dev), keys)

    def make(R_chunk=None):
        def launch(it_base=0, state=None):
            st = init() if state is None else state
            lt, chi, rsq, aic, lp, acc, sw, ks = (
                v.clone() for v in unpack(st))
            if R_chunk is None:
                lo, hi, first = 1, nits, burnin + 1
            else:
                lo, hi = it_base + 1, it_base + 1 + R_chunk
                first = lo
            R = hi - first
            recs = (torch.empty((R, C, P), dtype=dt, device=dev),) + tuple(
                torch.empty((R, C), dtype=dt, device=dev) for _ in range(4))
            # the running swap counts: every row in chunks (chunked.run
            # drops the burn-in rows), the last only for a whole run
            swr = torch.empty((R if R_chunk else 1, K - 1, C), dtype=dt,
                              device=dev)
            for it in range(lo, hi):
                ks, k_eps, k_u, k_s = jr.split(ks, 4).unbind(-2)
                eps = jr.normal(k_eps, (K, P), dt)
                prop = lt + stds * eps * mask
                chi_n, rsq_n, aic_n, lp_n = energy(prop)
                dE = (chi - chi_n) + (lp_n - lp)
                u = jr.uniform(k_u, (K,), dt)
                accept = torch.exp(dE * betas) > u       # NaN -> False
                lt = torch.where(accept[..., None], prop, lt)
                chi = torch.where(accept, chi_n, chi)
                rsq = torch.where(accept, rsq_n, rsq)
                aic = torch.where(accept, aic_n, aic)
                lp = torch.where(accept, lp_n, lp)
                # swaps of disjoint adjacent pairs, parity by the round
                us = jr.uniform(k_s, (K - 1,), dt)
                on = (it % swap_every == 0) & (
                    pair == (it // swap_every) % 2)
                E = chi - lp
                delta = dbeta * (E[:, :-1] - E[:, 1:])
                sflag = (torch.exp(delta) > us) & on & torch.isfinite(delta)
                no = torch.zeros((C, 1), dtype=torch.bool, device=dev)
                perm = (arange + torch.cat([sflag, no], 1).long()
                        - torch.cat([no, sflag], 1).long())
                lt = torch.gather(lt, 1, perm[..., None].expand(C, K, P))
                chi, rsq, aic, lp = (torch.gather(v, 1, perm)
                                     for v in (chi, rsq, aic, lp))
                acc = acc + accept[:, 0].to(dt)
                sw = sw + sflag.to(dt)
                r = it - first
                if r >= 0 and it > burnin:
                    recs[0][r] = torch.exp(lt[:, 0])
                    recs[1][r], recs[2][r], recs[3][r] = (
                        chi[:, 0], rsq[:, 0], aic[:, 0])
                    recs[4][r] = acc / torch.full_like(acc, float(it))
                    if R_chunk:
                        swr[r] = sw.t()
            if not R_chunk:
                swr[0] = sw.t()
            out = recs + (swr,)
            if R_chunk is None:
                return out
            return out, pack(lt, chi, rsq, aic, lp, acc, sw, ks)
        return launch
    return make


def _pt_args(theta0, keys, walk_mask, device, temperatures, nits, burnin,
             use_priors, prior_logpdf, swap_every):
    burnin = check_run(nits, burnin, use_priors, prior_logpdf)
    temperatures = validate_ladder(temperatures)
    if int(swap_every) < 1:
        raise ValueError("swap_every must be >= 1")
    theta0, keys, mask = chain_inputs(theta0, keys, walk_mask, device)
    return burnin, temperatures, theta0, keys, mask


def _pt_output(recs, nits, burnin, swap_every, K, device):
    th, chi, rsq, aic, ar, sw = recs
    att = swap_attempts(nits, swap_every, K - 1)
    swap_rate = sw[-1].t().contiguous() / torch.as_tensor(
        np.maximum(att, 1.0), dtype=sw.dtype, device=sw.device)[None, :]
    out = MHOutput(theta=th.permute(1, 0, 2), chi=chi.t(), rsquared=rsq.t(),
                   aic=aic.t(), acceptance_ratio=ar.t(),
                   iteration=torch.arange(1, nits, device=device)[burnin:])
    return out, swap_rate


def parallel_tempering(
        spec, obs, times, y0_base, theta0, keys, *,
        temperatures: Tuple[float, ...] = (1.0, 2.0, 4.0, 8.0),
        nits: int = 1000, burnin: Optional[int] = None, swap_every: int = 1,
        walk_mask=None, rwalk_std: float = 0.05, prior_logpdf=None,
        use_priors: bool = False, method: str = "dopri5", rtol: float = 1e-6,
        atol: float = 1e-4, max_steps: int = 4096, substeps=4,
        device="cuda"):
    """Run C tempered ladders; returns ``(MHOutput of the T=1 rung,
    swap_rate (C, K - 1))``, each pair's accepted swaps per proposal
    (column 0 the cold pair). ``theta0`` (C, P) and ``keys`` (C, 2) as
    :func:`~.mh.metropolis_hastings`'s; every rung of a chain starts at
    its theta0 row."""
    burnin, temperatures, theta0, keys, mask = _pt_args(
        theta0, keys, walk_mask, device, temperatures, nits, burnin,
        use_priors, prior_logpdf, swap_every)
    make = _pt_launcher(spec, obs, times, y0_base, theta0, keys, mask,
                        temperatures=temperatures, nits=int(nits),
                        burnin=burnin, swap_every=int(swap_every),
                        rwalk_std=float(rwalk_std),
                        prior_logpdf=prior_logpdf,
                        use_priors=bool(use_priors),
                        ikw=solver_kw(method, rtol, atol, max_steps,
                                      substeps))
    return _pt_output(make()(), nits, burnin, int(swap_every),
                      len(temperatures), theta0.device)


def parallel_tempering_checkpointed(
        spec, obs, times, y0_base, theta0, keys, *,
        temperatures: Tuple[float, ...] = (1.0, 2.0, 4.0, 8.0),
        nits: int = 1000, burnin: Optional[int] = None, swap_every: int = 1,
        walk_mask=None, rwalk_std: float = 0.05, prior_logpdf=None,
        use_priors: bool = False, method: str = "dopri5", rtol: float = 1e-6,
        atol: float = 1e-4, max_steps: int = 4096, substeps=4,
        config_token: str = "", checkpoint_every: int = 100,
        checkpoint_path: Optional[str] = None,
        resume_from: Optional[str] = None,
        _stop_after_chunks: Optional[int] = None, device="cuda"):
    """:func:`parallel_tempering` in chunks of ``checkpoint_every``
    proposals, the whole ladder's state (keys included) and the records
    persisted after each as ``mh.metropolis_hastings_checkpointed`` does;
    bitwise the whole run; None when stopped early."""
    from ..ops import chunked
    burnin, temperatures, theta0, keys, mask = _pt_args(
        theta0, keys, walk_mask, device, temperatures, nits, burnin,
        use_priors, prior_logpdf, swap_every)
    ikw = solver_kw(method, rtol, atol, max_steps, substeps)
    make = _pt_launcher(spec, obs, times, y0_base, theta0, keys, mask,
                        temperatures=temperatures, nits=int(nits),
                        burnin=burnin, swap_every=int(swap_every),
                        rwalk_std=float(rwalk_std),
                        prior_logpdf=prior_logpdf,
                        use_priors=bool(use_priors), ikw=ikw)
    static = ("xla-pt", spec.pnames, spec.pshapes, tuple(theta0.shape),
              int(nits), burnin, float(rwalk_std), temperatures,
              int(swap_every), tuple(float(w) for w in mask.cpu()),
              bool(use_priors), ikw["method"], ikw["rtol"], ikw["atol"],
              ikw["max_steps"], ikw["substeps"], str(config_token))
    recs = chunked.run(make, "PT", static, nits=int(nits), burnin=burnin,
                       device=theta0.device,
                       checkpoint_every=int(checkpoint_every),
                       checkpoint_path=checkpoint_path,
                       resume_from=resume_from, stop_after=_stop_after_chunks)
    if recs is None:
        return None
    return _pt_output(recs, nits, burnin, int(swap_every),
                      len(temperatures), theta0.device)


def tune_ladder(spec, obs, times, y0_base, theta0, keys, *,
                n_temps: int = 4, target_swap: float = 0.3,
                pilot_iters: int = 150, max_rounds: int = 6,
                r_init: float = 2.0, walk_mask=None, rwalk_std: float = 0.05,
                prior_logpdf=None, use_priors: bool = False,
                swap_every: int = 1, method: str = "dopri5",
                rtol: float = 1e-6, atol: float = 1e-4,
                max_steps: int = 4096, substeps=4, verbose: bool = False,
                device="cuda"):
    """Adapt a geometric ladder ``T_k = r^k`` toward a mean adjacent-pair
    swap acceptance of ``target_swap``: each round runs a pilot
    :func:`parallel_tempering` (``pilot_iters`` iterations, a third burn-in)
    from ``theta0`` with ``keys`` at the current ratio and bisects log r
    (acceptance falls as r grows) until it is within 0.05 of the target
    or ``max_rounds`` are spent. Returns ``(temperatures, mean swap
    acceptance)``, the last ladder evaluated and its acceptance."""
    if n_temps < 2:
        raise ValueError("n_temps must be >= 2")
    lo, hi = np.log(1.0 + 1e-3), np.log(64.0)
    lr = np.log(float(r_init))
    pilot_kw = dict(nits=int(pilot_iters),
                    burnin=max(1, int(pilot_iters) // 3),
                    swap_every=swap_every, walk_mask=walk_mask,
                    rwalk_std=rwalk_std, prior_logpdf=prior_logpdf,
                    use_priors=use_priors, method=method, rtol=rtol,
                    atol=atol, max_steps=max_steps, substeps=substeps,
                    device=device)
    acc = float("nan")
    temps = (1.0,) + tuple(float(np.exp(lr) ** k)
                           for k in range(n_temps))[1:]
    for rd in range(int(max_rounds)):
        temps = (1.0,) + tuple(float(np.exp(lr) ** k)
                               for k in range(n_temps))[1:]
        _, swap_rate = parallel_tempering(spec, obs, times, y0_base, theta0,
                                          keys, temperatures=temps,
                                          **pilot_kw)
        acc = float(np.mean(swap_rate.cpu().numpy()))
        if verbose:
            print(f"tune_ladder round {rd}: r={np.exp(lr):.3f} "
                  f"mean swap acc={acc:.3f}")
        if abs(acc - target_swap) < 0.05:
            break
        if acc > target_swap:       # rungs too close: grow r
            lo = lr
        else:
            hi = lr
        lr = 0.5 * (lo + hi)
    return temps, acc
