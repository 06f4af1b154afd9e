"""Hamiltonian Monte Carlo over batched chains, with cross-chain warmup
adaptation (diagonal or dense mass, dual-averaged step size, ChEES
trajectory lengths).

Counterpart of ``odelib_tpu/samplers/hmc.py``: the same potential
``U(z) = chi(e^z) [- log prior(e^z)]`` over ``z = log theta``, the same
transition (per-chain +-50 % step jitter, the shared mass matrix refreshed
from the chains' spread every warmup iteration, one step size
dual-averaged on the chains' mean acceptance, stuck chains restarted from
another chain at the warmup boundary, ChEES's Adam on the log trajectory
length) and the same ``jax.random`` draws (:mod:`odelib_tpu_torch.random`,
one stream from ``keys[0]``), so an accept sequence is the reference's.

The gradient is reverse-mode autograd through the fixed-step solve
(:func:`~odelib_tpu_torch.model.integrate_theta` with 'fixed_dopri5' or
'rk4'): :func:`potential` returns ``U``, the fit metrics and ``dU/dz`` of
every chain from one solve and one ``torch.autograd.grad`` of ``U.sum()``
(the chains are independent lanes, so the sum's gradient is each chain's
own; a chain whose solve fails gives NaN there and nowhere else). The
trajectory is a Python loop over leapfrog steps, every chain a lane of
each step's batched solve; the scalar adaptation state (step size, ChEES)
is held on the host in float64, one device read an iteration. Everything
computes in float64 on the device of ``theta0``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import random as jr
from .mh import MHOutput, _mh_output, chain_inputs, check_run, metrics_fn

__all__ = ["hamiltonian_mc", "hamiltonian_mc_checkpointed",
           "hamiltonian_mc_custom", "hamiltonian_mc_custom_checkpointed",
           "potential", "potential_custom"]

# dual averaging (Stan's defaults) and ChEES's Adam
_GAMMA, _T0, _KAPPA = 0.05, 10.0, 0.75
_B1, _B2 = 0.9, 0.999
FIXED_METHODS = ("fixed_dopri5", "rk4")


class _DualAvg(NamedTuple):
    log_eps: float       # current log step size (shared)
    log_eps_bar: float   # averaged log step size, taken at burn-in's end
    h_bar: float         # running acceptance-statistic average
    mu: float            # shrinkage target, log(10 eps0)


class _Chees(NamedTuple):
    log_tau: float       # current log trajectory length (shared)
    log_tau_bar: float   # iterate average, taken at burn-in's end
    m1: float            # Adam's moments
    m2: float


class _Carry(NamedTuple):
    z: Any               # (C, P) log-theta
    u_pot: Any           # (C,) potential at z
    chi: Any
    rsq: Any
    aic: Any
    g: Any               # (C, P) dU/dz at z
    acc_count: Any       # (C,)
    da: _DualAvg
    chees: _Chees
    mass_inv: Any        # (P,) diagonal inverse mass, or (P, P) Cholesky
    key: Any             # (2,)


def _halton2(n: int):
    """Radical-inverse base-2 (van der Corput) sequence for m = 1..n: the
    low-discrepancy jitter of ChEES's trajectory lengths."""
    out = np.zeros(n)
    for i in range(n):
        m, f, r = i + 1, 0.5, 0.0
        while m:
            r += f * (m & 1)
            m >>= 1
            f *= 0.5
        out[i] = r
    return out


def _div(x, s):
    """``x / s`` for a Python number ``s`` as a true division on every
    device (a CUDA tensor divided by a host scalar is multiplied by its
    reciprocal)."""
    return x / torch.full_like(x, float(s))


def _exp(x):
    """``exp`` of a host float, overflowing to inf as XLA's does
    (``math.exp`` raises)."""
    try:
        return math.exp(x)
    except OverflowError:
        return math.inf


def _mean0(x):
    """``jnp.mean(x, axis=0)``: the sum over chains divided by their
    count."""
    return _div(x.sum(0), x.shape[0])


def _autograd_potential(metrics, use_priors, prior_logpdf):
    """``vag`` over ``metrics(theta) -> (chi, rsq, aic)``: one forward pass
    of every lane and one ``torch.autograd.grad`` of the summed potential
    (the lanes are independent, so each lane's gradient is its own)."""
    def vag(z):
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            theta = torch.exp(z)
            chi, rsq, aic = metrics(theta)
            u = chi - prior_logpdf(theta) if use_priors else chi
            g, = torch.autograd.grad(u.sum(), z)
        return u.detach(), (chi.detach(), rsq.detach(), aic.detach()), g
    return vag


def potential(spec, obs, times, y0_base, like, *, num_params,
              use_priors=False, prior_logpdf=None, method="fixed_dopri5",
              substeps=4):
    """``vag(z (N, P)) -> (U (N,), (chi, rsq, aic), dU/dz (N, P))``: the
    HMC potential ``U = chi(e^z) [- log prior(e^z)]`` of N lanes, its fit
    metrics and its gradient from one fixed-step solve (``method``
    'fixed_dopri5' or 'rk4', ``substeps`` per interval) and one backward
    pass, in ``like``'s dtype and device (``odelib_tpu``'s
    ``_make_vag_u``)."""
    return _autograd_potential(
        metrics_fn(spec, obs, times, y0_base, num_params, like,
                   method=method, substeps=substeps),
        use_priors, prior_logpdf)


def custom_metrics(chi_fn):
    """``metrics(theta) -> (chi, NaN, NaN)`` over any ``chi_fn(theta (N,
    D)) -> (N,)``: no single-experiment R^2 or AIC."""
    def metrics(theta):
        chi = chi_fn(theta)
        nan = torch.full_like(chi, math.nan)
        return chi, nan, nan
    return metrics


def potential_custom(chi_fn, *, use_priors=False, prior_logpdf=None):
    """:func:`potential` over any differentiable ``chi_fn(theta (N, D)) ->
    (N,)`` (a JointFit's summed chi); R^2 and AIC come back NaN
    (``odelib_tpu``'s ``_make_vag_u_custom``)."""
    return _autograd_potential(custom_metrics(chi_fn), use_priors,
                               prior_logpdf)


def _leapfrog(vag, z, p, g, eps, n_steps, free, drift):
    """``n_steps`` leapfrog steps of ``H = U(z) + p^T M^-1 p / 2``: z, p,
    g (C, P), eps (C, 1), ``drift(p)`` the inverse mass applied to p. The
    incoming gradient is the previous endpoint's, so a trajectory costs
    ``n_steps`` solves, each giving the endpoint's potential and metrics.
    Static slots (``free`` False) take no kick and no drift, by selection:
    their gradient may be NaN at log(0)."""
    u = aux = None
    for _ in range(n_steps):
        p = p - torch.where(free, 0.5 * eps * g, 0.0)
        z = z + torch.where(free, eps * drift(p), 0.0)
        u, aux, g = vag(z)
        p = p - torch.where(free, 0.5 * eps * g, 0.0)
    return z, p, g, u, aux


def _metric(free, dense):
    """(cross_chain_mass, momentum, kinetic, drift) of the diagonal or the
    dense metric. Diagonal: the inverse mass is the chains' variance of z
    (``jnp.var``: mean, then mean squared deviation). Dense: the Cholesky
    factor L of their covariance shrunk 10 % toward its diagonal; the
    momentum is ``L^-T xi``, the kinetic energy ``|L^T p|^2 / 2`` and the
    drift ``L L^T p``. A refresh that is not finite and positive keeps the
    old metric."""
    if dense:
        def mass(z, old):
            C = z.shape[0]
            keep = free.to(z.dtype)
            zm = torch.where(free, z - _mean0(z), 0.0)
            cov = _div(zm.t() @ zm, max(C - 1, 1))
            cov = 0.9 * cov + 0.1 * torch.diag(torch.diagonal(cov))
            cov = cov * keep[:, None] * keep[None, :]
            var = torch.diagonal(cov)
            cov = cov + torch.diag(torch.where(free, 1e-8 * var + 1e-12,
                                               1.0))
            L, info = torch.linalg.cholesky_ex(cov)
            ok = (torch.where(free, (var > 1e-10) & torch.isfinite(var),
                              True).all()
                  & torch.isfinite(L).all() & (info == 0))
            return torch.where(ok, L, old)

        def momentum(xi, L):
            return torch.linalg.solve_triangular(L.t(), xi.t(),
                                                 upper=True).t()

        def kinetic(p, L):
            return 0.5 * ((p @ L) ** 2).sum(-1)

        def drift(L):
            return lambda p: (p @ L) @ L.t()
    else:
        def mass(z, old):
            var = _mean0((z - _mean0(z)) ** 2)
            ok = (var > 1e-10) & torch.isfinite(var) & free
            return torch.where(ok, var, old)

        def momentum(xi, m):
            return xi * torch.rsqrt(m)

        def kinetic(p, m):
            return 0.5 * (p * p * m).sum(-1)

        def drift(m):
            return lambda p: m * p
    return mass, momentum, kinetic, drift


def _make_step(vag, walk_mask, *, burnin, n_leapfrog, target_accept,
               mass_adapt, path_adapt, max_leapfrog, adam_lr, dense_mass):
    """The transition ``step(carry, it, h_m) -> (carry, record)`` of
    iteration ``it`` (Halton jitter ``h_m``), as ``odelib_tpu``'s
    ``_make_step``; every random draw and adaptation statistic is in the
    carry, so a run cut into chunks is the whole run bitwise."""
    free = walk_mask > 0
    warm0 = min(10, max(burnin // 4, 1))    # mass refreshes start here
    cross_chain_mass, momentum, kinetic, drift_of = _metric(free, dense_mass)

    def step(carry: _Carry, it: int, h_m: float):
        C, P = carry.z.shape
        dt = carry.z.dtype
        key, k_mom, k_u, k_jit, k_rej = jr.split(carry.key, 5).unbind(-2)
        da, ch = carry.da, carry.chees
        eps = _exp(da.log_eps)
        u_j = 0.5 + jr.uniform(k_jit, (C, 1), dt)
        if path_adapt:
            # one Halton-jittered leapfrog count for every chain; the
            # per-chain step jitter spreads the trajectory times. As
            # jnp.clip(jnp.ceil(tau / eps), 1, max_leapfrog): a step size
            # that underflowed to 0 (or a NaN) takes the cap
            ratio = h_m * _exp(ch.log_tau) / eps if eps > 0 else math.inf
            n_steps = max(math.ceil(ratio), 1) if ratio < max_leapfrog \
                else max_leapfrog
        else:
            n_steps = n_leapfrog
        eps_j = eps * u_j
        drift = drift_of(carry.mass_inv)
        p0 = momentum(jr.normal(k_mom, (C, P), dt), carry.mass_inv) \
            * walk_mask
        z1, p1, g1, u1, (chi1, rsq1, aic1) = _leapfrog(
            vag, carry.z, p0, carry.g, eps_j, n_steps, free, drift)
        log_ratio = (carry.u_pot + kinetic(p0, carry.mass_inv)) \
            - (u1 + kinetic(p1, carry.mass_inv))
        # a NaN Hamiltonian, or an endpoint gradient not finite on a free
        # slot (it would seed the next trajectory), rejects
        g1 = torch.where(free, g1, 0.0)
        ok = torch.isfinite(log_ratio) & torch.isfinite(g1).all(-1)
        alpha = torch.where(ok, torch.clamp(torch.exp(log_ratio), max=1.0),
                            0.0)
        accept = alpha > jr.uniform(k_u, (C,), dt)
        acc = accept[:, None]
        z = torch.where(acc, z1, carry.z)
        g = torch.where(acc, g1, carry.g)
        u_pot, chi, rsq, aic = (torch.where(accept, a, b) for a, b in (
            (u1, carry.u_pot), (chi1, carry.chi), (rsq1, carry.rsq),
            (aic1, carry.aic)))

        adapting = it <= burnin
        mass = carry.mass_inv
        if mass_adapt and adapting and it >= warm0:
            mass = cross_chain_mass(z, mass)

        # the shared dual averaging on the chains' mean acceptance
        m = float(it)
        mean_alpha = float(alpha.sum()) / C
        eta = 1.0 / (m + _T0)
        h_bar = (1.0 - eta) * da.h_bar + eta * (target_accept - mean_alpha)
        log_eps = da.mu - math.sqrt(m) / _GAMMA * h_bar
        w = m ** (-_KAPPA)
        log_eps_bar = w * log_eps + (1.0 - w) * da.log_eps_bar
        if adapting:
            da = _DualAvg(log_eps, log_eps_bar, h_bar, da.mu)
        switch = it == burnin
        if switch:
            da = da._replace(log_eps=da.log_eps_bar)

        # at the warmup boundary a chain whose warmup acceptance stayed
        # below 2 % restarts from another chain's state (no sample is
        # recorded yet)
        new_acc = carry.acc_count + accept.to(dt)
        if burnin > 0 and switch:
            rej = new_acc < 0.02 * burnin
            perm = jr.permutation(k_rej, C)
            rc = rej[:, None]
            z = torch.where(rc, z[perm], z)
            g = torch.where(rc, g[perm], g)
            u_pot, chi, rsq, aic = (torch.where(rej, v[perm], v)
                                    for v in (u_pot, chi, rsq, aic))

        if path_adapt:
            # the ChEES criterion's stochastic gradient in tau through the
            # Halton jitter (Hoffman, Radul & Sountsov 2021, eq. 6), Adam
            # ascent on log tau, clipped to what max_leapfrog realises
            dz0 = torch.where(free, carry.z - _mean0(carry.z), 0.0)
            dz1 = torch.where(free, z1 - _mean0(z1), 0.0)
            v1 = torch.where(free, drift(p1), 0.0)
            r_diff = (dz1 * dz1).sum(-1) - (dz0 * dz0).sum(-1)
            proj = (dz1 * v1).sum(-1)
            contrib = alpha * h_m * u_j[:, 0] * r_diff * proj
            contrib = torch.where(torch.isfinite(contrib), contrib, 0.0)
            s_c, s_a = torch.stack([contrib.sum(), alpha.sum()]).tolist()
            g_tau = s_c / max(s_a, 1e-6)
            glt = g_tau * _exp(ch.log_tau)
            glt = glt if math.isfinite(glt) else 0.0
            m1 = _B1 * ch.m1 + (1.0 - _B1) * glt
            m2 = _B2 * ch.m2 + (1.0 - _B2) * glt * glt
            mh_ = m1 / (1.0 - _B1 ** m)
            vh_ = m2 / (1.0 - _B2 ** m)
            log_tau = ch.log_tau + adam_lr * mh_ / (math.sqrt(vh_) + 1e-8)
            log_tau = min(max(log_tau, da.log_eps),
                          da.log_eps + math.log(float(max_leapfrog)))
            log_tau_bar = w * log_tau + (1.0 - w) * ch.log_tau_bar
            if adapting:
                ch = _Chees(log_tau, log_tau_bar, m1, m2)
            if switch:
                ch = ch._replace(log_tau=ch.log_tau_bar)

        new = _Carry(z=z, u_pot=u_pot, chi=chi, rsq=rsq, aic=aic, g=g,
                     acc_count=new_acc, da=da, chees=ch, mass_inv=mass,
                     key=key)
        return new, (torch.exp(z), chi, rsq, aic, _div(new_acc, it))

    return step


def _init_carry(vag, theta0, keys, walk_mask, *, n_leapfrog, step_size,
                mass_adapt, dense_mass):
    """The carry before iteration 1 (``odelib_tpu``'s ``_init_core``)."""
    C, P = theta0.shape
    dt = theta0.dtype
    z0 = torch.log(theta0)
    u0, (chi0, rsq0, aic0), g0 = vag(z0)
    g0 = torch.where(torch.isfinite(g0), g0, 0.0)
    le0 = math.log(float(step_size))
    da0 = _DualAvg(le0, le0, 0.0, math.log(10.0 * float(step_size)))
    mass0 = torch.eye(P, dtype=dt, device=z0.device) if dense_mass \
        else torch.ones(P, dtype=dt, device=z0.device)
    if mass_adapt:
        mass0 = _metric(walk_mask > 0, dense_mass)[0](z0, mass0)
    lt0 = math.log(n_leapfrog * float(step_size))
    return _Carry(z=z0, u_pot=u0, chi=chi0, rsq=rsq0, aic=aic0, g=g0,
                  acc_count=torch.zeros(C, dtype=dt, device=z0.device),
                  da=da0, chees=_Chees(lt0, lt0, 0.0, 0.0), mass_inv=mass0,
                  key=keys[0])


def _pack(c: _Carry):
    """The carry as one flat float64 tensor (the chunked runs' state)."""
    flat = [c.z.reshape(-1), c.u_pot, c.chi, c.rsq, c.aic,
            c.g.reshape(-1), c.acc_count, c.mass_inv.reshape(-1),
            torch.tensor(list(c.da) + list(c.chees), dtype=c.z.dtype,
                         device=c.z.device), c.key.to(c.z.dtype)]
    return torch.cat(flat)


def _unpack(st, C, P, dense):
    """Inverse of :func:`_pack`."""
    sizes = [C * P, C, C, C, C, C * P, C, P * P if dense else P, 8, 2]
    z, u, chi, rsq, aic, g, acc, mass, sc, key = torch.split(st, sizes)
    sc = sc.tolist()
    return _Carry(z=z.reshape(C, P), u_pot=u, chi=chi, rsq=rsq, aic=aic,
                  g=g.reshape(C, P), acc_count=acc,
                  mass_inv=mass.reshape(P, P) if dense else mass,
                  da=_DualAvg(*sc[:4]), chees=_Chees(*sc[4:]),
                  key=key.to(torch.int64))


def _launcher(vag, theta0, keys, mask, *, nits, burnin, n_leapfrog,
              step_size, target_accept, mass_adapt, path_adapt,
              max_leapfrog, adam_lr, dense_mass):
    """``make(R_chunk=None) -> launch(it_base=0, state=None)`` for
    :func:`~odelib_tpu_torch.ops.chunked.run`: the whole run's
    post-burn-in records, or the records of iterations ``it_base + 1 ..
    it_base + R_chunk`` and the packed carry after them."""
    C, P = theta0.shape
    dt, dev = theta0.dtype, theta0.device
    halton = _halton2(nits - 1)
    step = _make_step(
        vag, mask, burnin=burnin, n_leapfrog=n_leapfrog,
        target_accept=target_accept, mass_adapt=mass_adapt,
        path_adapt=path_adapt, max_leapfrog=max_leapfrog, adam_lr=adam_lr,
        dense_mass=dense_mass)

    def make(R_chunk=None):
        def launch(it_base=0, state=None):
            carry = _init_carry(
                vag, theta0, keys, mask, n_leapfrog=n_leapfrog,
                step_size=step_size, mass_adapt=mass_adapt,
                dense_mass=dense_mass) if state is None \
                else _unpack(state, C, P, dense_mass)
            if R_chunk is None:
                lo, hi, first = 1, nits, burnin + 1
            else:
                lo, hi = it_base + 1, it_base + 1 + R_chunk
                first = lo
            R = hi - first
            recs = (torch.empty((R, C, P), dtype=dt, device=dev),) \
                + tuple(torch.empty((R, C), dtype=dt, device=dev)
                        for _ in range(4))
            for it in range(lo, hi):
                carry, rec = step(carry, it, float(halton[it - 1]))
                r = it - first
                if r >= 0 and it > burnin:
                    for buf, v in zip(recs, rec):
                        buf[r] = v
            if R_chunk is None:
                return recs
            return recs, _pack(carry)
        return launch
    return make


def _knobs(n_leapfrog, step_size, target_accept, mass_adapt, path_adapt,
           max_leapfrog, adam_lr, dense_mass):
    return dict(n_leapfrog=int(n_leapfrog), step_size=float(step_size),
                target_accept=float(target_accept),
                mass_adapt=bool(mass_adapt), path_adapt=bool(path_adapt),
                max_leapfrog=int(max_leapfrog), adam_lr=float(adam_lr),
                dense_mass=bool(dense_mass))


def _check_method(method):
    if method not in FIXED_METHODS:
        raise ValueError(
            "HMC requires a fixed-step differentiable integrator: "
            "method='fixed_dopri5' or 'rk4' (an adaptive solve's step "
            "control is not differentiated)")


def _run(make, label, static, *, nits, burnin, device, chunk_iters=None,
         checkpoint_every=None, checkpoint_path=None, resume_from=None,
         stop_after=None):
    from ..ops import chunked
    if checkpoint_every is None and chunk_iters:
        checkpoint_every = int(chunk_iters)
    recs = chunked.run(make, label, static, nits=nits, burnin=burnin,
                       device=device, checkpoint_every=checkpoint_every,
                       checkpoint_path=checkpoint_path,
                       resume_from=resume_from, stop_after=stop_after)
    if recs is None:
        return None
    return _mh_output(recs, nits, burnin, device)


def _model_setup(spec, obs, times, y0_base, theta0, keys, walk_mask, *,
                 nits, burnin, use_priors, prior_logpdf, method, substeps,
                 device):
    burnin = check_run(nits, burnin, use_priors, prior_logpdf)
    _check_method(method)
    theta0, keys, mask = chain_inputs(theta0, keys, walk_mask, device)
    substeps = substeps if isinstance(substeps, tuple) else int(substeps)
    vag = potential(spec, obs, times, y0_base, theta0,
                    num_params=int(torch.count_nonzero(theta0[0])),
                    use_priors=bool(use_priors), prior_logpdf=prior_logpdf,
                    method=method, substeps=substeps)
    return burnin, theta0, keys, mask, substeps, vag


def hamiltonian_mc(
        spec, obs, times, y0_base, theta0, keys, *, nits: int = 1000,
        burnin: Optional[int] = None, n_leapfrog: int = 4,
        step_size: float = 0.02, target_accept: float = 0.65,
        walk_mask=None, prior_logpdf: Optional[Callable] = None,
        use_priors: bool = False, method: str = "fixed_dopri5",
        substeps=4, mass_adapt: bool = True, path_adapt: bool = False,
        max_leapfrog: int = 256, adam_lr: float = 0.025,
        dense_mass: bool = False, chunk_iters: Optional[int] = None,
        device="cuda") -> MHOutput:
    """Run C HMC chains whose warmup adapts one shared metric and step
    size across them (``odelib_tpu``'s ``hamiltonian_mc``).

    Inputs as :func:`~odelib_tpu_torch.samplers.mh.metropolis_hastings`
    (``theta0`` (C, P): a tensor runs on its device, an array on
    ``device``). The chains interact through warmup, so one stream seeded
    from ``keys[0]`` serves them all; ``keys[1:]`` do not enter. The
    solve is fixed-step (``method`` 'fixed_dopri5' or 'rk4'; an adaptive
    method raises ``ValueError``). During the ``burnin`` warmup the
    inverse mass is refreshed every iteration from the chains' variance
    of z (``mass_adapt``; ``dense_mass`` the Cholesky factor of their
    covariance) and the step size is dual-averaged toward
    ``target_accept``; both freeze at its end, where chains whose warmup
    acceptance stayed below 2 % restart from a random other chain.
    ``path_adapt`` (ChEES) adapts the trajectory length too, seeded at
    ``n_leapfrog * step_size`` and capped at ``max_leapfrog`` steps; else
    every trajectory takes ``n_leapfrog`` steps. ``chunk_iters`` runs the
    iterations in chunks of that many, bitwise the whole run."""
    burnin, theta0, keys, mask, substeps, vag = _model_setup(
        spec, obs, times, y0_base, theta0, keys, walk_mask, nits=nits,
        burnin=burnin, use_priors=use_priors, prior_logpdf=prior_logpdf,
        method=method, substeps=substeps, device=device)
    knobs = _knobs(n_leapfrog, step_size, target_accept, mass_adapt,
                   path_adapt, max_leapfrog, adam_lr, dense_mass)
    make = _launcher(vag, theta0, keys, mask, nits=int(nits), burnin=burnin,
                     **knobs)
    return _run(make, "HMC", (), nits=int(nits), burnin=burnin,
                device=theta0.device, chunk_iters=chunk_iters)


def hamiltonian_mc_checkpointed(
        spec, obs, times, y0_base, theta0, keys, *, nits: int = 1000,
        burnin: Optional[int] = None, n_leapfrog: int = 4,
        step_size: float = 0.02, target_accept: float = 0.65,
        walk_mask=None, prior_logpdf: Optional[Callable] = None,
        use_priors: bool = False, method: str = "fixed_dopri5",
        substeps=4, mass_adapt: bool = True, path_adapt: bool = False,
        max_leapfrog: int = 256, adam_lr: float = 0.025,
        dense_mass: bool = False, config_token: str = "",
        checkpoint_every: int = 100, checkpoint_path: Optional[str] = None,
        resume_from: Optional[str] = None,
        _stop_after_chunks: Optional[int] = None, device="cuda"):
    """:func:`hamiltonian_mc` in chunks of ``checkpoint_every`` iterations
    (:func:`~odelib_tpu_torch.ops.chunked.run`): after each, the whole
    sampler state (positions, gradients, key, step size, ChEES and mass
    statistics) and the records so far go to ``checkpoint_path``, and
    ``resume_from`` continues from such a file, bitwise the uninterrupted
    run; a file of another configuration, ``config_token`` or package
    raises ``ValueError``. ``_stop_after_chunks`` returns None after that
    many chunks, as a killed run."""
    burnin, theta0, keys, mask, substeps, vag = _model_setup(
        spec, obs, times, y0_base, theta0, keys, walk_mask, nits=nits,
        burnin=burnin, use_priors=use_priors, prior_logpdf=prior_logpdf,
        method=method, substeps=substeps, device=device)
    knobs = _knobs(n_leapfrog, step_size, target_accept, mass_adapt,
                   path_adapt, max_leapfrog, adam_lr, dense_mass)
    make = _launcher(vag, theta0, keys, mask, nits=int(nits), burnin=burnin,
                     **knobs)
    static = ("xla-hmc", spec.pnames, spec.pshapes, tuple(theta0.shape),
              int(nits), burnin, tuple(knobs.items()),
              tuple(float(w) for w in mask.cpu()), bool(use_priors), method,
              substeps, str(config_token))
    return _run(make, "HMC", static, nits=int(nits), burnin=burnin,
                device=theta0.device,
                checkpoint_every=int(checkpoint_every),
                checkpoint_path=checkpoint_path, resume_from=resume_from,
                stop_after=_stop_after_chunks)


def _custom_setup(chi_fn, theta0, keys, walk_mask, nits, burnin,
                  use_priors, prior_logpdf, device):
    burnin = check_run(nits, burnin, use_priors, prior_logpdf)
    theta0, keys, mask = chain_inputs(theta0, keys, walk_mask, device)
    vag = potential_custom(chi_fn, use_priors=bool(use_priors),
                           prior_logpdf=prior_logpdf)
    return burnin, theta0, keys, mask, vag


def hamiltonian_mc_custom(
        chi_fn, theta0, keys, *, nits: int = 1000,
        burnin: Optional[int] = None, n_leapfrog: int = 4,
        step_size: float = 0.02, target_accept: float = 0.65,
        walk_mask=None, prior_logpdf: Optional[Callable] = None,
        use_priors: bool = False, mass_adapt: bool = True,
        path_adapt: bool = False, max_leapfrog: int = 256,
        adam_lr: float = 0.025, dense_mass: bool = False,
        chunk_iters: Optional[int] = None, device="cuda") -> MHOutput:
    """:func:`hamiltonian_mc` against any differentiable ``chi_fn(theta (N,
    D)) -> (N,)`` (a JointFit's summed chi, whose hierarchical pooling
    makes a funnel), with its conventions; the R^2 and AIC records are
    NaN (``odelib_tpu``'s ``hamiltonian_mc_custom``)."""
    burnin, theta0, keys, mask, vag = _custom_setup(
        chi_fn, theta0, keys, walk_mask, nits, burnin, use_priors,
        prior_logpdf, device)
    knobs = _knobs(n_leapfrog, step_size, target_accept, mass_adapt,
                   path_adapt, max_leapfrog, adam_lr, dense_mass)
    make = _launcher(vag, theta0, keys, mask, nits=int(nits), burnin=burnin,
                     **knobs)
    return _run(make, "HMC", (), nits=int(nits), burnin=burnin,
                device=theta0.device, chunk_iters=chunk_iters)


def hamiltonian_mc_custom_checkpointed(
        chi_fn, theta0, keys, *, nits: int = 1000,
        burnin: Optional[int] = None, n_leapfrog: int = 4,
        step_size: float = 0.02, target_accept: float = 0.65,
        walk_mask=None, prior_logpdf: Optional[Callable] = None,
        use_priors: bool = False, mass_adapt: bool = True,
        path_adapt: bool = False, max_leapfrog: int = 256,
        adam_lr: float = 0.025, dense_mass: bool = False,
        config_token: str = "", checkpoint_every: int = 100,
        checkpoint_path: Optional[str] = None,
        resume_from: Optional[str] = None,
        _stop_after_chunks: Optional[int] = None, device="cuda"):
    """:func:`hamiltonian_mc_custom` checkpointed as
    :func:`hamiltonian_mc_checkpointed`; the closure cannot be
    fingerprinted, so ``config_token`` (a process-stable digest of what
    ``chi_fn`` bakes in) enters the resume signature."""
    burnin, theta0, keys, mask, vag = _custom_setup(
        chi_fn, theta0, keys, walk_mask, nits, burnin, use_priors,
        prior_logpdf, device)
    knobs = _knobs(n_leapfrog, step_size, target_accept, mass_adapt,
                   path_adapt, max_leapfrog, adam_lr, dense_mass)
    make = _launcher(vag, theta0, keys, mask, nits=int(nits), burnin=burnin,
                     **knobs)
    static = ("xla-hmc-custom", str(config_token), tuple(theta0.shape),
              int(nits), burnin, tuple(knobs.items()),
              tuple(float(w) for w in mask.cpu()), bool(use_priors))
    return _run(make, "HMC", static, nits=int(nits), burnin=burnin,
                device=theta0.device,
                checkpoint_every=int(checkpoint_every),
                checkpoint_path=checkpoint_path, resume_from=resume_from,
                stop_after=_stop_after_chunks)
