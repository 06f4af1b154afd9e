"""Fused parallel tempering: the CUDA kernel and its torch twin.

Counterpart of ``odelib_tpu/ops/pallas_pt.py``: the public
``parallel_tempering_fused`` with the JAX package's arguments, validation
and returns (``MHOutput`` of the T=1 rung, per-chain cold-pair swap
acceptance per proposal). Each chain carries a ladder of K rungs; per
iteration every rung takes a tempered random-walk step, then adjacent
pairs of alternating parity propose swaps every ``swap_every`` iterations.

A CUDA tensor launches the hand-written kernel (``csrc/pt.cu``, built by
:mod:`.build`) or raises; a CPU tensor runs the plain torch twin
:func:`pt_plain`, which performs the kernel's float32 operations in the
same order and draws the same counter-RNG words. Chain c keys its stream
on its global index, so the JAX kernel's padding to a tile changes
nothing and is not done here; ``tile_chains`` is accepted and ignored.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..model import ModelSpec, ObsData
from ..samplers.pt import swap_attempts
from . import chunked
from .cuda_mh import (_M32, _SLOT_BUDGET, _STEPPER_ID, LAUNCHES, Rng,
                      _as_f32_tensor, _build_plan, _check_cuda, _check_mesh,
                      _check_stepper, _device_plan, _key,
                      _normalize_substeps, _prior_tensor, _ptr, _records,
                      chunk_range, make_scorer, scoring, twin_launcher)
from .priors import checked_priors, logprior_plain
from .runge_kutta import const


def ladder_constants(temperatures, rwalk_std: float, walk_mask):
    """The ladder's float32 constants, rounded on the host where the JAX
    kernel's Python doubles meet float32: per rung and slot the walk scale
    ``f32(rwalk_std * T_k ** 0.5 * mask_p)``, ``beta_k = f32(1 / T_k)``,
    and per adjacent pair ``f32(beta_k - beta_{k+1})`` (differences taken
    in double). Returns (scales (K, P), betas (K,), dbetas (K-1,))."""
    betas = [1.0 / float(t) for t in temperatures]
    stds = [float(rwalk_std) * float(t) ** 0.5 for t in temperatures]
    scales = np.asarray([[s * float(w) for w in walk_mask] for s in stds],
                        np.float32)
    dbetas = np.asarray([b0 - b1 for b0, b1 in zip(betas, betas[1:])],
                        np.float32)
    return scales, np.asarray(betas, np.float32), dbetas


def state_planes(K: int, P: int) -> int:
    """The PT chunk state's planes: per rung log-theta, chi, R^2 and log
    prior, then the cold rung's accept count and the cold pair's swap
    count (the JAX kernel's K (P + 3) + 2)."""
    return K * (P + 3) + 2


def pt_plain(spec, plan, y0_base, theta0, seed, *, nits, burnin, scales,
             walked, betas, dbetas, swap_every, num, stepper="dopri5",
             prior=None, R_chunk=None, it_base=0, state=None):
    """Twin of the PT kernel: ``theta0`` (P, C) float32; returns the T=1
    rung's records theta (R, P, C) and chi, rsq, aic, acceptance ratio and
    the running count of accepted (0,1) swaps (R, C),
    R = nits - 1 - burnin. ``prior``: a :func:`~.priors.prior_table` or
    None; with one each rung carries its log prior. Chunk mode as
    ``cuda_mh.mh_plain``'s, the state (:func:`state_planes`, C): rung k's
    log-theta at k P + p, chi at K P + k, R^2 at K P + K + k, log prior
    (0 without priors) at K P + 2 K + k, then the two counts."""
    score = make_scorer(spec, plan, y0_base, stepper)
    P, C = theta0.shape
    K = len(betas)
    dev = theta0.device
    it_end, rec0 = chunk_range(nits, burnin, R_chunk, it_base)
    R = it_end - 1 - rec0
    rng = Rng(seed, torch.arange(C, device=dev))
    if state is None:
        chi0, rsq0 = score(list(theta0))
        lt = [[torch.log(th) for th in theta0] for _ in range(K)]
        chi, rsq = [chi0] * K, [rsq0] * K
        lp = None if prior is None else \
            [logprior_plain(prior, list(theta0))] * K
        acc = torch.zeros_like(chi0)
        sw = torch.zeros_like(chi0)
    else:
        lt = [list(state[k * P:(k + 1) * P]) for k in range(K)]
        chi = list(state[K * P:K * P + K])
        rsq = list(state[K * P + K:K * P + 2 * K])
        lp = None if prior is None else \
            list(state[K * P + 2 * K:K * P + 3 * K])
        acc, sw = state[-2], state[-1]
        chi0 = chi[0]
    sc = [[const(float(v), chi0) for v in row] for row in scales]
    bc = [const(float(b), chi0) for b in betas]
    dc = [const(float(d), chi0) for d in dbetas]
    recs = _records(R, P, C, dev, n_rows=5)
    two, aic_c = const(2.0, chi0), const(2.0 * num, chi0)
    for it in range(it_base + 1, it_end):
        rng.start(it)
        # every rung's proposal and accept uniform in the kernel's slot
        # order, then all rungs scored in one call on (K C,) tensors: the
        # same elementwise float32 operations, a K-th of the launches
        props, us = [], []
        for k in range(K):
            props.append([lt[k][p] + sc[k][p] * rng.normal() if walked[p]
                          else lt[k][p] for p in range(P)])
            us.append(rng.uniform())
        thp_all = [torch.exp(torch.cat([pr[p] for pr in props]))
                   for p in range(P)]
        chi_all, rsq_all = score(thp_all)
        for k in range(K):
            prop, u = props[k], us[k]
            thp = [v[k * C:(k + 1) * C] for v in thp_all]
            chi_new = chi_all[k * C:(k + 1) * C]
            rsq_new = rsq_all[k * C:(k + 1) * C]
            log_ratio = chi[k] - chi_new
            if prior is not None:
                lp_new = logprior_plain(prior, thp)
                log_ratio = log_ratio + (lp_new - lp[k])
            accept = torch.exp(log_ratio * bc[k]) > u
            lt[k] = [torch.where(accept, a, b) for a, b in zip(prop, lt[k])]
            chi[k] = torch.where(accept, chi_new, chi[k])
            rsq[k] = torch.where(accept, rsq_new, rsq[k])
            if prior is not None:
                lp[k] = torch.where(accept, lp_new, lp[k])
            if k == 0:
                acc = acc + accept.to(torch.float32)
        do_swap = it % swap_every == 0
        parity = (it // swap_every) % 2
        for k in range(K - 1):
            u = rng.uniform()
            if prior is None:
                delta = dc[k] * (chi[k] - chi[k + 1])
            else:
                delta = dc[k] * ((chi[k] - lp[k]) - (chi[k + 1] - lp[k + 1]))
            flag = (torch.exp(delta) > u) & torch.isfinite(delta) & (
                do_swap and parity == k % 2)
            lt[k], lt[k + 1] = (
                [torch.where(flag, b, a) for a, b in zip(lt[k], lt[k + 1])],
                [torch.where(flag, a, b) for a, b in zip(lt[k], lt[k + 1])])
            for arr in (chi, rsq) if prior is None else (chi, rsq, lp):
                arr[k], arr[k + 1] = (torch.where(flag, arr[k + 1], arr[k]),
                                      torch.where(flag, arr[k], arr[k + 1]))
            if k == 0:
                sw = sw + flag.to(torch.float32)
        r = it - 1 - rec0
        if r >= 0:
            recs[0][r] = torch.stack([torch.exp(v) for v in lt[0]])
            recs[1][r] = chi[0]
            recs[2][r] = rsq[0]
            recs[3][r] = two * chi[0] + aic_c
            recs[4][r] = acc / torch.full_like(acc, float(it))
            recs[5][r] = sw
    if R_chunk is None:
        return recs
    lp = [torch.zeros_like(acc)] * K if lp is None else lp
    return recs, torch.stack(
        [v for rung in lt for v in rung] + chi + rsq + lp + [acc, sw])


def pt_launcher(spec, plan, y0_base, stepper, th0, seed, *, nits, burnin,
                scales, walked, betas, dbetas, swap_every, num, prior=None,
                R_chunk=None):
    """Prepare the PT kernel for chains ``th0`` (P, C) on the card and
    return ``launch() -> records`` (as :func:`pt_plain`); each call
    launches the kernel once (and counts it). With ``R_chunk`` it is
    ``launch(it_base, state) -> (records, state)``, a chunk of
    :func:`pt_plain`'s chunk mode."""
    from . import build
    K = len(betas)
    lib = build.load_kernels(spec, scoring=[scoring(plan)],
                             stiff=stepper == "kvaerno3",
                             wide=K > build.PT_KMAX)
    dev = th0.device
    P, C = th0.shape
    plan_i, plan_f = _device_plan(spec, plan, _key(y0_base), stepper,
                                  str(dev))
    ladder = torch.as_tensor(np.concatenate([
        np.asarray(scales, np.float32).ravel(),
        np.asarray(walked, np.float32), betas, dbetas]).astype(np.float32),
        device=dev)
    prior_t = _prior_tensor(prior, dev)
    head = (plan_i.data_ptr(), plan_f.data_ptr(), th0.data_ptr(),
            ladder.data_ptr(), _ptr(prior_t))
    tail = (int(swap_every), int(np.uint32(np.int64(seed) & _M32)),
            float(np.float32(2.0 * num)), _STEPPER_ID[stepper],
            build.stream(dev))

    def launch(it_base=0, state=None):
        it_end, rec0 = chunk_range(nits, burnin, R_chunk, it_base)
        recs = _records(it_end - 1 - rec0, P, C, dev, n_rows=5)
        out = None if R_chunk is None else torch.empty(
            (state_planes(K, P), C), dtype=torch.float32, device=dev)
        build.check(lib, lib.odelib_pt(
            *head, _ptr(state), _ptr(out), *(r.data_ptr() for r in recs), C,
            K, int(it_base), int(it_end), int(rec0), *tail),
            "parallel tempering")
        LAUNCHES["parallel_tempering_fused"] += 1
        return recs if R_chunk is None else (recs, out)
    launch.keep = (ladder, prior_t)   # alive as long as the launcher
    return launch


def parallel_tempering_fused(
        spec: ModelSpec, obs: ObsData, times, y0_base, theta0, seed: int, *,
        temperatures=(1.0, 2.0, 4.0, 8.0), swap_every: int = 1,
        nits: int = 1000, burnin: Optional[int] = None,
        walk_mask: Optional[Sequence[float]] = None, rwalk_std: float = 0.05,
        substeps: int = 4, stepper: str = "dopri5",
        tile_chains: Optional[int] = None, interpret: bool = False,
        mesh=None, priors=None, checkpoint_every: Optional[int] = None,
        checkpoint_path: Optional[str] = None,
        resume_from: Optional[str] = None, config_token: str = "",
        _stop_after_chunks: Optional[int] = None, device="cuda"):
    """Run C tempered ladders in one kernel launch.

    ``theta0`` is (C, P) float32; a CUDA tensor launches the PT kernel, a
    CPU one runs its twin, an array goes to ``device`` (the card by
    default; without CUDA it raises unless ``device='cpu'``). ``temperatures`` (at least 2 rungs, starting
    at 1.0, strictly increasing; as many as the RNG's 1024 slots an
    iteration hold) and ``swap_every`` as in the JAX package: a ladder of
    more than ``build.PT_KMAX`` rungs spans warps, in a library built
    with ``wide``. Returns ``(MHOutput of the T=1 rung, swap_rate (C,))``, the
    cold pair's accepted swaps per proposal. ``priors``: one distribution
    (or None) per theta slot, in the tempered acceptance and the swaps as
    in the JAX kernel (a family without an in-kernel form raises
    ``ValueError``). ``checkpoint_every``/``checkpoint_path``/
    ``resume_from``/``config_token``/``_stop_after_chunks`` as in
    ``cuda_mh.metropolis_hastings_fused``: the chunks carry the whole
    ladder's state, and the swap parity follows the global iteration.
    ``tile_chains``/``interpret`` are accepted and ignored; a ``mesh``
    raises ``NotImplementedError``."""
    from ..samplers.mh import MHOutput
    _check_mesh(mesh)
    _check_stepper(stepper)
    if burnin is None:
        burnin = int(nits / 2)
    temperatures = tuple(float(t) for t in temperatures)
    if len(temperatures) < 2:
        raise ValueError("parallel tempering needs >= 2 temperatures")
    if temperatures[0] != 1.0:
        raise ValueError("temperatures[0] must be 1.0 (the posterior rung)")
    if any(b >= a for b, a in zip(temperatures, temperatures[1:])):
        raise ValueError("temperatures must be strictly increasing")
    K = len(temperatures)
    if int(swap_every) < 1:
        raise ValueError("swap_every must be >= 1")
    theta0 = _as_f32_tensor(theta0, device)
    C, P = theta0.shape
    if P != spec.theta_size:
        raise ValueError(f"theta0 must have {spec.theta_size} columns")
    prior = checked_priors(priors, P)
    if nits - 1 <= burnin:
        raise ValueError(f"nits={nits} leaves no recorded iterations after "
                         f"burnin={burnin}")
    num = int(torch.count_nonzero(theta0[0]))
    if walk_mask is None:
        walk_mask = [1.0] * P
    walked = tuple(float(w) != 0.0 for w in walk_mask)
    if K * (2 * sum(walked) + 1) + (K - 1) > _SLOT_BUDGET:
        raise ValueError(
            "per-iteration RNG slot budget (1024) exhausted — too many "
            "draw sites (rungs x walked parameters) for the fused kernel")
    scales, betas, dbetas = ladder_constants(temperatures, rwalk_std,
                                             walk_mask)
    substeps = _normalize_substeps(substeps, len(np.asarray(times)) - 1)
    plan = _build_plan(spec, obs, times, substeps)
    th0 = theta0.t().contiguous()
    launcher = pt_launcher if _check_cuda(spec, th0) \
        else twin_launcher(pt_plain)

    def make(R_chunk=None):
        return launcher(spec, plan, y0_base, stepper, th0, seed,
                        nits=int(nits), burnin=int(burnin), scales=scales,
                        walked=walked, betas=betas, dbetas=dbetas,
                        swap_every=int(swap_every), num=num, prior=prior,
                        R_chunk=R_chunk)
    static = ("pt", spec.pnames, P, C, int(nits), int(burnin),
              tuple(float(w) for w in walk_mask), float(rwalk_std), num,
              stepper, substeps, int(seed), temperatures, int(swap_every),
              chunked.prior_key(prior), str(config_token))
    recs = chunked.run(make, "MCMC", static, nits=int(nits),
                       burnin=int(burnin), device=th0.device,
                       checkpoint_every=checkpoint_every,
                       checkpoint_path=checkpoint_path,
                       resume_from=resume_from, stop_after=_stop_after_chunks)
    if recs is None:
        return None
    th_r, chi_r, rsq_r, aic_r, ar_r, sw_r = recs
    att0 = max(float(swap_attempts(nits, swap_every, 1)[0]), 1.0)
    swap_rate = sw_r[-1] / const(att0, sw_r)
    out = MHOutput(theta=th_r.permute(2, 0, 1), chi=chi_r.t(),
                   rsquared=rsq_r.t(), aic=aic_r.t(),
                   acceptance_ratio=ar_r.t(),
                   iteration=torch.arange(1, nits, device=th0.device)[burnin:])
    return out, swap_rate
