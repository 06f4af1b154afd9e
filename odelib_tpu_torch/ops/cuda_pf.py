"""Fused particle-marginal MH (PMMH): the CUDA kernel and its torch twin.

Counterpart of ``odelib_tpu/ops/pallas_pf.py`` (Euler-Maruyama and
Milstein): the public ``pmmh_fused`` with the JAX package's arguments and
validation, ``pmmh_supported``, and ``PMMHOutput``
(``odelib_tpu/samplers/pf.py``). Each proposal of each chain is scored by
a K-particle bootstrap filter over the model's SDE
(``sde_method='milstein'`` adds the Milstein correction after each Euler
step, with the diffusion's diagonal derivative from the RHS front end,
``RhsProgram.diagonal``, and Euler's draws), with systematic resampling at
every observed grid point (the plan's observation model, Tobit terms of
censored log-space data, bolus doses after each grid point's block),
in-kernel priors (:mod:`.priors`) and Robbins-Monro proposal-scale
adaptation during burn-in (``csrc/pf.cu`` states the semantics and every
parity trap with the JAX line it mirrors).

A CUDA tensor launches the hand-written kernel (``csrc/pf.cu``, built by
:mod:`.build` with the traced drift and diffusion) or raises; a CPU tensor
runs the plain torch twin :func:`pmmh_plain`, which performs the kernel's
float32 operations in the same order, sums the weights in the same order
and draws the same counter-RNG words. Chain c keys its streams on its
global index, so the JAX kernel's padding to 128-chain tiles changes
nothing and is not done here. Chunked checkpointing and resume follow
``_pf_fused_chunked`` (:mod:`.chunked`). Meshes and more than 512
particles are not ported (ROADMAP queue 1, item 18, queue 2, item 6).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..model import ModelSpec, ObsData, diffusion_program, rhs_program
from ..rhs import RhsTraceError, diagonal_evaluator, torch_evaluator
from . import chunked
from .cuda_mh import (_M32, LAUNCHES, _as_f32_tensor, _build_plan,
                      _check_mesh, _device_plan, _key, _normalize_substeps,
                      _ptr, _records, apply_doses, chunk_range, mix,
                      obs_terms, scoring, stage_forcings, uniform_of)
from .build import PF_KMAX
from .priors import checked_priors, logprior_plain, prior_table
from .runge_kutta import const


class PMMHOutput(NamedTuple):
    """Post-burnin PMMH samples. Leading axes: (chains, records)."""
    theta: Any             # (C, R, P)
    chi: Any               # (C, R) the chain's likelihood estimate
    aic: Any               # (C, R)
    acceptance_ratio: Any  # (C, R)
    iteration: Any         # (R,)


def pmmh_supported(spec: ModelSpec, n_particles: int,
                   sde_method: str) -> bool:
    """Whether the fused kernel runs this PMMH configuration: a diffusion
    that traces like the drift (for Milstein, with a derivative rule for
    each of its operations), Euler-Maruyama or Milstein, and 8 to 512
    particles in multiples of 8."""
    if spec.diffusion is None or sde_method not in ("euler", "milstein"):
        return False
    K = int(n_particles)
    if not (8 <= K <= PF_KMAX and K % 8 == 0):
        return False
    try:
        _trace_sde(spec, sde_method == "milstein")
    except RhsTraceError:
        return False
    return True


def _trace_sde(spec: ModelSpec, milstein: bool):
    """Trace the drift and the diffusion (and, for Milstein, the
    diffusion's diagonal derivative) as the kernel's build does: raises
    ``RhsTraceError`` for a function the kernel cannot take."""
    rhs_program(spec)
    g = diffusion_program(spec)
    if milstein:
        g.diagonal()


def obs_grid_indices(plan):
    """Grid indices carrying at least one observation, ascending."""
    return [gi for gi in range(plan.n_grid) if plan.obs_after[gi]]


def slot_stride(plan, S: int, n_walked: int) -> int:
    """Per-iteration counter stride: the next power of two of the JAX
    kernel's slot count (``_count_slots``: proposal normals, the accept
    uniform, two slots per state and step, one uniform per block)."""
    n = 2 * n_walked + 1 + 2 * S * len(plan.step_ts) \
        + len(obs_grid_indices(plan))
    return 1 << int(math.ceil(math.log2(max(2, n))))


def pf_keys(seed: int, K: int, chains: torch.Tensor):
    """Per-chain keys (C,) (particle 0's, for the per-chain draws) and
    per-particle keys (K, C): particle k of chain c keys on
    ``mix(seed * 0x9E3779B1 + (c // 128) * K * 128 + k * 128 + c % 128)``,
    the lane ids of the JAX kernel's (K, 128) plane."""
    s = int(np.uint32(np.int64(seed) & _M32))
    c = chains.to(torch.int64)
    base = (s * 0x9E3779B1 + (c // 128) * (K * 128) + c % 128) & _M32
    k = torch.arange(K, dtype=torch.int64, device=c.device)[:, None]
    return mix(base), mix((base[None, :] + k * 128) & _M32)


def rng_normal_pair(key, ctr: int):
    """Both Box-Muller halves (cos, sin) from slots ``ctr``, ``ctr + 1``."""
    u1 = uniform_of(key, ctr)
    u2 = uniform_of(key, ctr + 1)
    r = torch.sqrt(const(-2.0, u1) * torch.log(u1))
    a = const(2.0 * math.pi, u2) * u2
    return r * torch.cos(a), r * torch.sin(a)


def rng_normal(key, ctr: int):
    """Box-Muller, cos half only (the per-chain proposal normals)."""
    return rng_normal_pair(key, ctr)[0]


def group_sum(w):
    """Sum over the particle axis (0) of ``w`` (K, C): 32-particle groups
    in particle order, then the group sums in order (the kernel's order,
    and XLA:CPU's for K <= 32 or K a multiple of 32)."""
    total = torch.zeros_like(w[0])
    for g in range(0, w.shape[0], 32):
        part = torch.zeros_like(w[0])
        for row in w[g:g + 32]:
            part = part + row
        total = total + part
    return total


def hillis_steele(w):
    """Inclusive prefix sum over the particle axis (0) of ``w`` (K, C): the
    Hillis-Steele ladder ``c[k] += c[k - d]`` for d = 1, 2, 4, ..., each
    level reading only the previous level's values (the kernel's
    association)."""
    K = w.shape[0]
    cum, d = w, 1
    while d < K:
        cum = cum + torch.cat([torch.zeros_like(cum[:d]), cum[:-d]])
        d *= 2
    return cum


def systematic_resample(w, u, y):
    """Systematic resampling of particles ``y`` (S tensors (K, C)) with
    weights ``w`` (K, C) and one uniform per chain ``u`` (C,): ``cum`` is
    the Hillis-Steele prefix sum of ``w``, ``pos_i = ((i + u) / K) *
    cum[K-1]``, and slot i takes the sum, in particle order, of the
    particles j with ``cum[j-1] <= pos_i < cum[j]`` (``cum[-1] = 0``).

    Selected as the kernel selects: in a chain whose ``cum`` never falls,
    the intervals tile [0, total), so the first j with ``cum[j] > pos_i``
    is the only match (``0 + y_j``), and none (all-zero states) when
    rounding puts ``pos_i`` at or past the total; in a chain where
    rounding made ``cum`` dip, the masked sum over every particle."""
    K = w.shape[0]
    cum = hillis_steele(w)
    rows = torch.arange(K, device=w.device, dtype=torch.float32)[:, None]
    pos = ((rows + u) * const(1.0 / K, w)) * cum[-1]
    zero = const(0.0, w)
    j = torch.searchsorted(cum.t().contiguous(), pos.t().contiguous(),
                           right=True).t()
    hit = j < K
    j = j.clamp(max=K - 1)
    new = [torch.where(hit, zero + torch.gather(ys, 0, j), zero) for ys in y]
    rising = (cum[1:] >= cum[:-1]).all(dim=0)
    if not bool(rising.all()):
        masked = [torch.zeros_like(w) for _ in y]
        for j in range(K):
            sel = (pos >= (cum[j - 1] if j else zero)) & (pos < cum[j])
            masked = [n + torch.where(sel, ys[j], zero)
                      for n, ys in zip(masked, y)]
        new = [torch.where(rising, a, b) for a, b in zip(new, masked)]
    return new


class _Filter:
    """The bootstrap particle filter of :func:`pmmh_plain` for one model,
    plan and particle count; ``run`` estimates -loglik for every chain."""

    def __init__(self, spec, plan, y0_base, K, keys, key0, milstein=False):
        S, shapes, forc = len(spec.snames), spec.pshapes, spec.forcings
        self.spec, self.plan, self.K, self.S = spec, plan, K, S
        self.f = torch_evaluator(spec.rhs, S, shapes, forc)
        self.g = torch_evaluator(spec.diffusion, S, shapes, forc)
        self.dg = diagonal_evaluator(spec.diffusion, S, shapes, forc) \
            if milstein else None
        self.forc = {}      # the Euler rows of the forcing table, by device
        self.y0 = tuple(float(v) for v in np.asarray(y0_base))
        self.keys, self.key0 = keys, key0
        gis = obs_grid_indices(plan)
        self.last_gi = gis[-1] if gis else -1
        self.dosed = scoring(plan)[3]

    def resample(self, y, gi, loglik, ctr, slot):
        ref = y[0]
        chi_b, _ = obs_terms(self.plan.obs_after[gi], y,
                             torch.zeros_like(ref), None,
                             self.plan.obs_model, self.plan.obs_param)
        finite = (chi_b == chi_b) & (chi_b < const(1e30, ref))
        logw = torch.where(finite, -chi_b, const(-math.inf, ref))
        m = logw.amax(dim=0)
        lw = logw - m                       # NaN when every particle died
        w = torch.where(lw > const(-60.0, ref), torch.exp(lw),
                        const(0.0, ref))
        loglik = ((loglik + m) + torch.log(group_sum(w))) \
            - const(math.log(self.K), ref)
        if gi == self.last_gi:
            return y, loglik, slot
        u = uniform_of(self.key0, ctr + slot)
        return systematic_resample(w, u, y), loglik, slot + 1

    def run(self, theta, ctr, slot):
        """-loglik (C,) at ``theta`` (P tensors (C,)) with the counters of
        iteration ``ctr``; returns (chi, next slot)."""
        ref = theta[0]
        shape = (self.K, ref.shape[0])
        y = [theta[i].expand(shape) if i >= 0
             else torch.full(shape, self.y0[s], dtype=torch.float32,
                             device=ref.device)
             for s, i in enumerate(self.spec.init_pidx)]
        loglik = torch.zeros_like(ref)
        stash = None
        if self.plan.obs_after[0]:
            y, loglik, slot = self.resample(y, 0, loglik, ctr, slot)
        if self.dosed:
            y = apply_doses(self.plan, 0, y)
        dev = ref.device
        if dev not in self.forc:
            self.forc[dev] = stage_forcings(self.spec, self.plan, "euler",
                                            dev)
        at = self.forc[dev]
        for k, (t, h, gi) in enumerate(self.plan.step_ts):
            u = None if at is None else at[k][t]   # the forcings at t
            f = self.f(t, y, theta, u)
            g = self.g(t, y, theta, u)
            # Milstein: d g_s / d y_s at the pre-step state
            dg = None if self.dg is None else self.dg(t, y, theta, u)
            xi = []
            for _ in range(self.S):
                if stash is not None:
                    xi.append(stash)
                    stash = None
                else:
                    a, stash = rng_normal_pair(self.keys, ctr + slot)
                    slot += 2
                    xi.append(a)
            hc = const(h, ref)
            sq = const(float(np.sqrt(h)), ref)
            y = [(y[s] + hc * f[s]) + (sq * g[s]) * xi[s]
                 for s in range(self.S)]
            if dg is not None:
                hh, one = const(0.5 * h, ref), const(1.0, ref)
                y = [y[s] + ((hh * g[s]) * dg[s]) * (xi[s] * xi[s] - one)
                     for s in range(self.S)]
            if gi >= 0 and self.plan.obs_after[gi]:
                y, loglik, slot = self.resample(y, gi, loglik, ctr, slot)
            if gi >= 0 and self.dosed:
                y = apply_doses(self.plan, gi, y)
        return -loglik, slot


def pmmh_plain(spec, plan, y0_base, theta0, seed, *, K, nits, burnin, walk,
               walked, rwalk_std, prior=None, adapt=False, target=0.3,
               adapt_rate=0.05, milstein=False, R_chunk=None, it_base=0,
               state=None):
    """Twin of the PMMH kernel: ``theta0`` (P, C) float32; returns the
    chain-minor records theta (R, P, C), chi and acceptance ratio (R, C),
    R = nits - 1 - burnin. ``walk`` is the walk mask, ``walked`` its
    non-zero slots, ``prior`` a :func:`~.priors.prior_table` or None;
    ``milstein`` takes the Milstein step (Euler's draws).
    Chunk mode as ``cuda_mh.mh_plain``'s, the state (P + 3, C): log-theta,
    chi, the accept count and the log proposal scale; the scale adapts
    while ``it <= burnin``, the run's burn-in."""
    P, C = theta0.shape
    dev = theta0.device
    it_end, rec0 = chunk_range(nits, burnin, R_chunk, it_base)
    R = it_end - 1 - rec0
    stride = slot_stride(plan, len(spec.snames), sum(walked))
    key0, keys = pf_keys(seed, K, torch.arange(C, device=dev))
    filt = _Filter(spec, plan, y0_base, K, keys, key0, milstein)
    if state is None:
        theta = list(theta0)
        chi, _ = filt.run(theta, 0, 0)
        lt = [torch.log(th) for th in theta]
        acc = torch.zeros_like(chi)
        lsc = torch.zeros_like(chi)
    else:
        lt = list(state[:P])
        chi, acc, lsc = state[P], state[P + 1], state[P + 2]
    rw, ar_c, tg_c = (const(v, chi) for v in (rwalk_std, adapt_rate, target))
    wc = [const(float(w), chi) for w in walk]
    recs = _records(R, P, C, dev, n_rows=2)
    for it in range(it_base + 1, it_end):
        ctr = (it * stride) & _M32
        slot = 0
        std = rw * torch.exp(lsc)
        prop = []
        for p in range(P):
            if walked[p]:
                prop.append(lt[p] + (std * wc[p]) * rng_normal(key0,
                                                               ctr + slot))
                slot += 2
            else:
                prop.append(lt[p])
        thp = [torch.exp(v) for v in prop]
        u = uniform_of(key0, ctr + slot)
        chi_new, _ = filt.run(thp, ctr, slot + 1)
        log_ratio = chi - chi_new
        if prior is not None:
            log_ratio = log_ratio + (logprior_plain(prior, thp)
                                     - logprior_plain(prior, [
                                         torch.exp(v) for v in lt]))
        accept = torch.exp(log_ratio) > u    # NaN / -inf ratio rejects
        lt = [torch.where(accept, a, b) for a, b in zip(prop, lt)]
        chi = torch.where(accept, chi_new, chi)
        a = accept.to(torch.float32)
        acc = acc + a
        if adapt and it <= burnin:
            lsc = lsc + ar_c * (a - tg_c)
        r = it - 1 - rec0
        if r >= 0:
            recs[0][r] = torch.stack([torch.exp(v) for v in lt])
            recs[1][r] = chi
            recs[2][r] = acc / torch.full_like(acc, float(it))
    if R_chunk is None:
        return recs
    return recs, torch.stack(lt + [chi, acc, lsc])


def pmmh_launcher(spec, plan, y0_base, th0, seed, *, K, nits, burnin, walk,
                  walked, rwalk_std, prior=None, adapt=False, target=0.3,
                  adapt_rate=0.05, milstein=False, R_chunk=None):
    """Prepare the PMMH kernel for chains ``th0`` (P, C) on the card and
    return ``launch() -> records`` (as :func:`pmmh_plain`); each call
    launches the kernel once (and counts it). With ``R_chunk`` it is
    ``launch(it_base, state) -> (records, state)``, a chunk of
    :func:`pmmh_plain`'s chunk mode. ``milstein`` launches the Milstein
    instantiations, from a library of their own."""
    from . import build
    lib = build.load_kernels(spec, diffusion=True, scoring=[scoring(plan)],
                             milstein=milstein)
    dev = th0.device
    P, C = th0.shape
    plan_i, plan_f = _device_plan(spec, plan, _key(y0_base), "euler",
                                  str(dev))
    gis = obs_grid_indices(plan)
    walk_t = torch.as_tensor(np.asarray(
        tuple(float(w) for w in walk) + tuple(float(w) for w in walked),
        np.float32), device=dev)
    table = prior_table([None] * P) if prior is None else prior
    prior_t = torch.as_tensor(np.ascontiguousarray(table), device=dev)
    stride = slot_stride(plan, len(spec.snames), sum(walked))
    head = (plan_i.data_ptr(), plan_f.data_ptr(), th0.data_ptr(),
            walk_t.data_ptr(), prior_t.data_ptr())
    tail = (int(burnin), int(np.uint32(np.int64(seed) & _M32)), stride,
            gis[-1] if gis else -1, int(prior is not None), int(adapt),
            int(milstein),
            *(float(np.float32(v)) for v in (rwalk_std, adapt_rate, target,
                                             math.log(K), 1.0 / K)),
            build.stream(dev))

    def launch(it_base=0, state=None):
        it_end, rec0 = chunk_range(nits, burnin, R_chunk, it_base)
        recs = _records(it_end - 1 - rec0, P, C, dev, n_rows=2)
        out = None if R_chunk is None else torch.empty(
            (P + 3, C), dtype=torch.float32, device=dev)
        build.check(lib, lib.odelib_pf(
            *head, _ptr(state), _ptr(out), *(r.data_ptr() for r in recs), C,
            int(K), int(it_base), int(it_end), int(rec0), *tail),
            "particle filter")
        LAUNCHES["pmmh_fused"] += 1
        return recs if R_chunk is None else (recs, out)
    launch.keep = (walk_t, prior_t)   # alive as long as the launcher
    return launch


def pmmh_fused(spec: ModelSpec, obs: ObsData, times, y0_base, theta0,
               seed: int, *, nits: int = 1000,
               burnin: Optional[int] = None, walk_mask=None,
               rwalk_std: float = 0.05, n_particles: int = 128,
               substeps: int = 4, sde_method: str = "euler",
               priors=None, adapt_proposal: bool = False,
               target_accept: float = 0.3, adapt_rate: float = 0.05,
               interpret: bool = False, mesh=None,
               checkpoint_every: Optional[int] = None,
               checkpoint_path: Optional[str] = None,
               resume_from: Optional[str] = None, config_token: str = "",
               _stop_after_chunks: Optional[int] = None, device="cuda"):
    """Run C chains of particle-marginal MH in one kernel launch.

    ``theta0`` is (C, P) float32; a CUDA tensor launches the PMMH kernel, a
    CPU one runs its twin, an array goes to ``device`` (the card by
    default; without CUDA it raises unless ``device='cpu'``). ``substeps`` Euler-Maruyama steps per interval
    of ``times``; ``priors`` one distribution (or None) per theta slot,
    LogNormal, Normal or Uniform. Returns :class:`PMMHOutput` with
    ``aic = 2 chi + 2 count_nonzero(theta0[0])``. ``checkpoint_every``/
    ``checkpoint_path``/``resume_from``/``config_token``/
    ``_stop_after_chunks`` as in ``cuda_mh.metropolis_hastings_fused``
    (the chunks carry the proposal scale; the adaptation and the RNG
    counter's range follow the run's ``burnin`` and ``nits``).
    ``sde_method='milstein'`` adds the Milstein correction
    ``0.5 h g_s (d g_s / d y_s) (xi_s^2 - 1)`` after each Euler step, with
    Euler's draws. ``interpret`` is accepted and ignored; a ``mesh``
    raises ``NotImplementedError``."""
    if spec.diffusion is None:
        raise ValueError("pmmh_fused requires a spec with diffusion=")
    if sde_method not in ("euler", "milstein"):
        raise ValueError("the fused PMMH kernel integrates Euler-Maruyama "
                         f"or Milstein, not sde_method={sde_method!r}")
    milstein = sde_method == "milstein"
    K = int(n_particles)
    if not (8 <= K <= PF_KMAX and K % 8 == 0):
        raise ValueError(f"fused PMMH needs n_particles in [8, {PF_KMAX}] and "
                         "a multiple of 8 (lifting it is ROADMAP queue 2, "
                         "item 6)")
    _check_mesh(mesh)
    if burnin is None:
        burnin = int(nits / 2)
    if nits - 1 <= burnin:
        raise ValueError(f"nits={nits} leaves no recorded iterations after "
                         f"burnin={burnin}")
    P = spec.theta_size
    theta0 = _as_f32_tensor(theta0, device)
    if theta0.shape[1] != P:
        raise ValueError(f"theta0 must have {P} columns")
    num = int(torch.count_nonzero(theta0[0]))
    if walk_mask is None:
        walk_mask = [1.0] * P
    walk = tuple(float(w) for w in np.asarray(walk_mask).ravel())
    walked = tuple(w != 0.0 for w in walk)
    prior = checked_priors(priors, P)
    substeps = _normalize_substeps(substeps, len(np.asarray(times)) - 1)
    plan = _build_plan(spec, obs, times, substeps)
    stride = slot_stride(plan, len(spec.snames), sum(walked))
    if float(nits) * stride >= 2.0 ** 32:
        raise ValueError("nits * RNG stride exceeds the 32-bit counter")
    th0 = theta0.t().contiguous()
    kw = dict(K=K, nits=int(nits), burnin=int(burnin), walk=walk,
              walked=walked, rwalk_std=float(rwalk_std), prior=prior,
              adapt=bool(adapt_proposal), target=float(target_accept),
              adapt_rate=float(adapt_rate), milstein=milstein)
    if th0.device.type != "cuda":
        def make(R_chunk=None):
            return lambda **ck: pmmh_plain(spec, plan, y0_base, th0, seed,
                                           R_chunk=R_chunk, **kw, **ck)
    else:
        # raises RhsTraceError for a function the kernel cannot take
        _trace_sde(spec, milstein)

        def make(R_chunk=None):
            return pmmh_launcher(spec, plan, y0_base, th0, seed,
                                 R_chunk=R_chunk, **kw)
    static = ("pmmh", spec.pnames, P, K, th0.shape[1], int(nits),
              int(burnin), walk, float(rwalk_std), num, substeps, int(seed),
              chunked.prior_key(prior), bool(adapt_proposal),
              float(target_accept), float(adapt_rate), str(config_token),
              str(sde_method))
    recs = chunked.run(make, "PMMH", static, nits=int(nits),
                       burnin=int(burnin), device=th0.device,
                       checkpoint_every=checkpoint_every,
                       checkpoint_path=checkpoint_path,
                       resume_from=resume_from, stop_after=_stop_after_chunks)
    if recs is None:
        return None
    th_r, chi_r, ar_r = recs
    chi = chi_r.t()
    return PMMHOutput(theta=th_r.permute(2, 0, 1), chi=chi,
                      aic=const(2.0, chi) * chi + const(2.0 * num, chi),
                      acceptance_ratio=ar_r.t(),
                      iteration=torch.arange(1, nits, device=th0.device)
                      [burnin:])
