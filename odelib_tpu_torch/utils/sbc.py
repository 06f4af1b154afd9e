"""Simulation-based calibration (SBC) of the whole inference pipeline.

Counterpart of ``odelib_tpu/utils/sbc.py`` (Talts et al. 2018): draw
``theta*`` from the prior, simulate a dataset from the model's own
observation process (the spec's ``obs_model``: lognormal or Student-t
noise at each point's ``log_sigma``, or Poisson or negative-binomial
counts at the predicted intensity), run an MH chain on it, and rank
``theta*`` among the M thinned posterior draws. Correct solver,
likelihood, proposal and RNG give uniform ranks on {0..M}; a U shape
flags an underdispersed posterior, a slope a bias.

The replications run as one batched loop: each iteration is one
fixed-step solve of every replication (a lane each, every lane scored
against its own synthetic data), in float64 on the device of the
observations' tensors, with the reference's key stream
(:mod:`odelib_tpu_torch.random`): replication r keyed
``fold_in(PRNGKey(seed), r)``, its data from ``fold_in(key_r, 0)``, the
proposal and the uniform of iteration ``it`` from ``fold_in(key_r, 2 it
+ 1)`` and ``2 it + 2``, and ``theta*`` of slot j the prior's ``ppf`` of
``uniform(fold_in(PRNGKey(seed), 7919 + j), (reps,))``.

Measure note (the reference's): the framework's ``use_priors=True`` walks
``z = log theta`` with the prior as a theta-density and no ``e^z``
Jacobian; SBC adds the Jacobian (``log p_theta(e^z) + z``), so uniform
ranks certify the mechanics under the stated prior.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .. import random as jr
from ..model import ModelSpec, ObsData, device_obs, integrate_theta, observe
from ..model import score_pred

__all__ = ["SBCResult", "sbc_ranks", "rank_uniformity_pvalue"]


class SBCResult(NamedTuple):
    ranks: Any        # (reps, P) int32; -1 for slots without a prior
    valid: Any        # (reps,) bool: simulated data and chain chi finite
    acceptance: Any   # (reps,) final running acceptance ratio
    theta_star: Any   # (reps, P) the prior draws
    n_draws: Any      # M: thinned posterior draws each rank is out of


def _prior_draws(d, key, reps):
    """``d.rvs(key, (reps,))`` as the JAX package draws it: the ``ppf`` of
    float64 uniforms, or for a discrete normal ``round(mu + sigma *
    normal)``."""
    from ..distributions import DiscreteNormal
    if isinstance(d, DiscreteNormal):
        return torch.round(d.mu + d.sigma * jr.normal(key, (reps,)))
    return d.ppf(jr.uniform(key, (reps,), torch.float64))


def _simulate(spec, obs, pred, keys, dt):
    """One synthetic dataset a replication from the spec's observation
    model at the predictions ``pred`` (R, n): (log abundances, abundances,
    whether every point could be drawn)."""
    if spec.obs_model in ("poisson", "negbinom"):
        # the rate is capped as the JAX package's poisson needs; a draw
        # beyond the cap flags its replication invalid, like a failed solve
        lam_ok = torch.isfinite(pred) & (pred >= 0) & (pred < 1e9)
        lam = torch.where(lam_ok, pred, torch.zeros_like(pred))
        k_sim = keys
        if spec.obs_model == "negbinom":
            kg, kp = jr.split(keys).unbind(-2)
            r = spec.obs_param
            lam = jr.gamma(kg, r, pred.shape[1:], dt) * (lam / r)
            k_sim = kp
        counts = jr.poisson(k_sim, lam, pred.shape[1:]).to(dt)
        return torch.log(counts), counts, lam_ok.all(dim=1)
    if spec.obs_model == "student_t":
        eps = jr.t(keys, spec.obs_param, pred.shape[1:], dt)
    else:
        eps = jr.normal(keys, pred.shape[1:], dt)
    la = torch.log(pred) + obs.log_sigma * eps
    return la, torch.exp(la), torch.isfinite(la).all(dim=1)


def _ranks(spec, obs, times, y0, theta_star, walk_mask, key, slot_dists, *,
           nits, burnin, thin, rwalk_std, method, substeps):
    """The replications' chains as one batched loop -> (ranks (R, P)
    int32, valid (R,), acceptance (R,))."""
    dt, dev = theta_star.dtype, theta_star.device
    R, P = theta_star.shape
    ikw = dict(method=method, substeps=substeps)
    rep_keys = jr.fold_in(key, torch.arange(R, device=dev))

    def solve(th):
        return integrate_theta(spec, th, spec.override_inits(y0, th), times,
                               **ikw)

    def prior_z(z):
        tot = torch.zeros(R, dtype=dt, device=dev)
        for j, d in enumerate(slot_dists):
            if d is not None:
                tot = tot + d.logpdf(torch.exp(z[:, j])) + z[:, j]
        return tot

    pred = observe(spec, obs, solve(theta_star))
    la, ab, sim_ok = _simulate(spec, obs, pred, jr.fold_in(rep_keys, 0), dt)
    obs_r = obs._replace(log_abundance=la, abundance=ab)

    def chi_of(z):
        return score_pred(spec, obs_r, observe(spec, obs_r,
                                               solve(torch.exp(z))))

    z0 = torch.log(theta_star)
    z, chi, lp = z0, chi_of(z0), prior_z(z0)
    chi0 = chi
    acc = torch.zeros(R, dtype=dt, device=dev)
    below = torch.zeros((R, P), dtype=torch.int64, device=dev)
    step_mask = rwalk_std * walk_mask
    for it in range(1, nits):
        k_eps = jr.fold_in(rep_keys, 2 * it + 1)
        k_u = jr.fold_in(rep_keys, 2 * it + 2)
        prop = z + step_mask * jr.normal(k_eps, (P,), dt)
        chi_n = chi_of(prop)
        lp_n = prior_z(prop)
        log_ratio = (chi - chi_n) + (lp_n - lp)
        u = jr.uniform(k_u, (), dt)
        accept = torch.exp(log_ratio) > u         # NaN -> rejected
        z = torch.where(accept[:, None], prop, z)
        chi = torch.where(accept, chi_n, chi)
        lp = torch.where(accept, lp_n, lp)
        acc = acc + accept.to(dt)
        # the thinned draws: every thin-th post-burn-in iteration
        if it > burnin and (it - burnin - 1) % thin == 0:
            below += (z < z0).to(torch.int64)
    valid = sim_ok & torch.isfinite(chi) & torch.isfinite(chi0)
    # times the reciprocal, as XLA divides by the constant
    return below.to(torch.int32), valid, acc * (1.0 / (nits - 1))


def sbc_ranks(spec: ModelSpec, obs_template: ObsData, times, y0_base,
              slot_dists, theta_base, *, reps: int = 128,
              nits: int = 2000, burnin=None, thin: int = 10,
              rwalk_std: float = 0.05, walk_mask=None, seed: int = 0,
              method: str = "fixed_dopri5", substeps=4,
              device="cuda") -> SBCResult:
    """Run ``reps`` SBC replications as one batched loop on ``device``.

    ``slot_dists``: one prior (the port's distributions, or None) per FLAT
    theta slot; a slot without one keeps its ``theta_base`` value, never
    walks and gets rank -1. ``obs_template`` gives the observation design
    (grid indices, states, per-point log_sigma); its values are replaced
    by each replication's simulated draws. ``valid`` flags replications
    whose synthetic data or chain chi were not finite (a prior draw whose
    solve blew up): drop them from the histogram. ``method`` 'rk4' or
    'fixed_dopri5' with ``substeps``."""
    slot_dists = tuple(slot_dists)
    theta_base = np.ravel(np.asarray(theta_base, float))
    P = theta_base.size
    if len(slot_dists) != P:
        raise ValueError(f"slot_dists must have {P} entries, got "
                         f"{len(slot_dists)}")
    if burnin is None:
        burnin = int(nits / 2)
    if nits - 1 <= burnin:
        raise ValueError(f"nits={nits} leaves no recorded iterations "
                         f"after burnin={burnin}")
    dev = torch.device(device)
    if walk_mask is None:
        walk_mask = np.array([1.0 if d is not None else 0.0
                              for d in slot_dists])
    walk_mask = np.asarray(walk_mask, float)
    key = jr.PRNGKey(seed, device=dev)
    theta_star = torch.as_tensor(np.tile(theta_base, (int(reps), 1)),
                                 device=dev)
    for j, d in enumerate(slot_dists):
        if d is not None and walk_mask[j] != 0:
            theta_star[:, j] = _prior_draws(d, jr.fold_in(key, 7919 + j),
                                            int(reps)).to(dev)
    ranks, valid, acc = _ranks(
        spec, device_obs(obs_template, torch.float64, dev),
        np.asarray(times, np.float64),
        torch.as_tensor(np.asarray(y0_base, np.float64), device=dev),
        theta_star, torch.as_tensor(walk_mask, device=dev), key, slot_dists,
        nits=int(nits), burnin=int(burnin), thin=int(thin),
        rwalk_std=float(rwalk_std), method=method,
        substeps=substeps if isinstance(substeps, tuple) else int(substeps))
    M = (nits - 1 - int(burnin) + int(thin) - 1) // int(thin)
    ranks = ranks.cpu().numpy()
    for j, d in enumerate(slot_dists):
        if d is None or walk_mask[j] == 0:
            ranks[:, j] = -1
    return SBCResult(ranks=ranks, valid=valid.cpu().numpy(),
                     acceptance=acc.cpu().numpy(),
                     theta_star=theta_star.cpu().numpy(), n_draws=M)


def rank_uniformity_pvalue(ranks, n_draws: int, bins: int = 16) -> float:
    """Chi-square uniformity p-value for one slot's SBC ranks (values
    0..n_draws inclusive); each bin's expected count follows its integer
    support."""
    from scipy.stats import chi2

    ranks = np.asarray(ranks)
    ranks = ranks[ranks >= 0]
    if ranks.size == 0:
        return float("nan")
    bins = int(min(bins, n_draws + 1))
    edges = np.linspace(0, n_draws + 1, bins + 1)
    counts, _ = np.histogram(ranks, bins=edges)
    ints = np.arange(n_draws + 1)
    idx = np.clip(np.digitize(ints, edges) - 1, 0, bins - 1)
    support = np.bincount(idx, minlength=bins)
    expected = ranks.size * support / (n_draws + 1)
    stat = float(np.sum((counts - expected) ** 2 / expected))
    return float(chi2.sf(stat, bins - 1))
