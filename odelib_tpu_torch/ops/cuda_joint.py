"""Fused joint (multi-experiment) MH: the CUDA kernel and its torch twin.

Counterpart of ``odelib_tpu/ops/pallas_joint.py``: the public
``joint_metropolis_hastings_fused`` with the JAX package's arguments,
validation and ``JointFusedOutput``. Chains walk a D-dimensional joint
theta; each of the K experiments is scored on ``theta[idx_maps[k]]`` with
its own plan (grid, y0, observations, substeps) and model, and the total
chi is the sum of the parts in experiment order.

A CUDA tensor launches the hand-written kernel (``csrc/joint.cu``, built
by :mod:`.build` with every distinct model of the fit compiled in) or
raises; a CPU tensor runs the plain torch twin :func:`joint_plain`, which
performs the kernel's float32 operations in the same order and draws the
same counter-RNG words. Chain c keys its stream on its global index, so
the JAX kernel's padding to a tile changes nothing and is not done here;
``tile_chains`` is accepted and ignored. Chunked checkpointing and resume
follow ``_joint_fused_chunked`` (:mod:`.chunked`).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..model import rhs_program
from . import chunked
from .cuda_mh import (_M32, _SLOT_BUDGET, _STEPPER_ID, LAUNCHES, Rng,
                      _as_f32_tensor, _build_plan, _check_stepper,
                      _check_mesh, _normalize_substeps, _prior_tensor, _ptr,
                      chunk_range, make_scorer, plan_tables, scoring,
                      twin_launcher)
from .priors import checked_priors, logprior_plain
from .runge_kutta import const


class JointFusedOutput(NamedTuple):
    """Post-burnin joint records. Leading axes: (chains, records)."""
    theta: Any             # (C, R, D)
    chi: Any               # (C, R) total
    chi_parts: Any         # (C, R, K)
    acceptance_ratio: Any  # (C, R)
    iteration: Any         # (R,)


def _joint_records(R, D, K, C, dev):
    """Chain-minor joint records: theta (R, D, C), chi (R, C), the parts
    (R, K, C) and the acceptance ratio (R, C)."""
    return tuple(torch.empty(shape, dtype=torch.float32, device=dev)
                 for shape in ((R, D, C), (R, C), (R, K, C), (R, C)))


def joint_plain(specs, plans, y0s, idx_maps, theta0, seed, *, nits, burnin,
                walk, walked, stepper="dopri5", prior=None, R_chunk=None,
                it_base=0, state=None):
    """Twin of the joint kernel: ``theta0`` (D, C) float32; returns the
    chain-minor records theta (R, D, C), chi (R, C), chi parts (R, K, C)
    and acceptance ratio (R, C), R = nits - 1 - burnin. ``walk`` is the
    per-dimension scale ``rwalk_std * walk_mask`` and ``walked`` marks the
    dimensions that draw a normal; ``prior`` a :func:`~.priors.prior_table`
    of one entry per joint dimension, or None.

    Chunk mode (``R_chunk`` proposals, ``cuda_mh.chunk_range``): the
    proposals ``it_base + 1 .. it_base + R_chunk``, every one recorded,
    from ``state`` ((D + K + 3, C): log-theta, the total chi, the K parts,
    the accept count and the log prior, 0 without priors; None scores
    theta0); returns (records, the state after the chunk)."""
    scorers = [make_scorer(sp, pl, y0, stepper)
               for sp, pl, y0 in zip(specs, plans, y0s)]

    def joint_score(theta):
        parts = [score([theta[i] for i in idx])[0]
                 for score, idx in zip(scorers, idx_maps)]
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total, parts

    D, C = theta0.shape
    K = len(specs)
    dev = theta0.device
    it_end, rec0 = chunk_range(nits, burnin, R_chunk, it_base)
    R = it_end - 1 - rec0
    rng = Rng(seed, torch.arange(C, device=dev))
    if state is None:
        chi, parts = joint_score(list(theta0))
        lp = None if prior is None else logprior_plain(prior, list(theta0))
        lt = [torch.log(th) for th in theta0]
        acc = torch.zeros_like(chi)
    else:
        lt = list(state[:D])
        chi, parts = state[D], list(state[D + 1:D + 1 + K])
        acc = state[D + K + 1]
        lp = None if prior is None else state[D + K + 2]
    recs = _joint_records(R, D, K, C, dev)
    for it in range(it_base + 1, it_end):
        rng.start(it)
        prop = [lt[d] + const(walk[d], chi) * rng.normal() if walked[d]
                else lt[d] for d in range(D)]
        thp = [torch.exp(v) for v in prop]
        chi_new, parts_new = joint_score(thp)
        u = rng.uniform()
        log_ratio = chi - chi_new
        if prior is not None:
            lp_new = logprior_plain(prior, thp)
            log_ratio = log_ratio + (lp_new - lp)
        accept = torch.exp(log_ratio) > u   # NaN / -inf ratio rejects
        if prior is not None:
            lp = torch.where(accept, lp_new, lp)
        lt = [torch.where(accept, a, b) for a, b in zip(prop, lt)]
        chi = torch.where(accept, chi_new, chi)
        parts = [torch.where(accept, a, b) for a, b in zip(parts_new, parts)]
        acc = acc + accept.to(torch.float32)
        r = it - 1 - rec0
        if r >= 0:
            recs[0][r] = torch.stack([torch.exp(v) for v in lt])
            recs[1][r] = chi
            recs[2][r] = torch.stack(parts)
            recs[3][r] = acc / torch.full_like(acc, float(it))
    if R_chunk is None:
        return recs
    return recs, torch.stack(
        lt + [chi] + parts + [acc, torch.zeros_like(chi) if lp is None
                              else lp])


def joint_tables(specs, plans, y0s, idx_maps, stepper):
    """The K plans as one pair of flat tables (``plan_tables`` of each,
    concatenated) and the experiment table the kernel reads: per
    experiment its two plan offsets, its model (an index into
    :func:`~odelib_tpu_torch.ops.build.distinct_programs`) and its idx map
    padded to the widest model. Returns (plan_i, plan_f, exp_tab, width)."""
    from .build import distinct_programs
    programs, model_of = distinct_programs(specs,
                                           [scoring(pl) for pl in plans])
    width = 3 + max(p.n_params for p in programs)
    tabs = [plan_tables(sp, pl, y0, stepper)
            for sp, pl, y0 in zip(specs, plans, y0s)]
    off_i = np.cumsum([0] + [len(t[0]) for t in tabs])
    off_f = np.cumsum([0] + [len(t[1]) for t in tabs])
    exp_tab = np.zeros((len(specs), width), np.int32)
    for k, idx in enumerate(idx_maps):
        exp_tab[k, :3] = (off_i[k], off_f[k], model_of[k])
        exp_tab[k, 3:3 + len(idx)] = idx
    return (np.concatenate([t[0] for t in tabs]),
            np.concatenate([t[1] for t in tabs]), exp_tab.ravel(), width)


def joint_launcher(specs, plans, y0s, idx_maps, stepper, th0, seed, *,
                   nits, burnin, walk, walked, prior=None, R_chunk=None,
                   smem_cap=0):
    """Prepare the joint kernel for chains ``th0`` (D, C) on the card and
    return ``launch() -> records`` (as :func:`joint_plain`); each call
    launches the kernel once (and counts it). With ``R_chunk`` it is
    ``launch(it_base, state) -> (records, state)``, a chunk of
    :func:`joint_plain`'s chunk mode, state a (D + K + 3, C) tensor on the
    card (None on the first chunk). A fit of more than ``JOINT_KMAX``
    experiments or ``JOINT_DMAX`` slots loads the library built with
    ``wide`` (``joint_kernel``'s ``WIDE`` instantiations), whose log-theta
    and proposal planes sit in shared memory up to ``smem_cap`` bytes (0:
    the card's opt-in maximum), else in device memory."""
    from . import build
    D, C = th0.shape
    K = len(specs)
    lib = build.load_kernels(
        specs[0], specs[1:], scoring=[scoring(pl) for pl in plans],
        wide=K > build.JOINT_KMAX or D > build.JOINT_DMAX)
    dev = th0.device
    plan_i, plan_f, exp_tab, width = joint_tables(specs, plans, y0s,
                                                  idx_maps, stepper)
    plan_i, exp_tab = (torch.as_tensor(a, device=dev)
                       for a in (plan_i, exp_tab))
    plan_f = torch.as_tensor(plan_f, device=dev)
    # per dimension: the walk scale, then the walked flag
    walk_t = torch.as_tensor(np.asarray(
        tuple(walk) + tuple(float(w) for w in walked), np.float32),
        device=dev)
    prior_t = _prior_tensor(prior, dev)
    head = (plan_i.data_ptr(), plan_i.numel(), plan_f.data_ptr(),
            plan_f.numel(), exp_tab.data_ptr(), width, th0.data_ptr(),
            walk_t.data_ptr(), _ptr(prior_t))
    tail = (int(np.uint32(np.int64(seed) & _M32)), _STEPPER_ID[stepper],
            int(smem_cap), build.stream(dev))

    def launch(it_base=0, state=None):
        it_end, rec0 = chunk_range(nits, burnin, R_chunk, it_base)
        recs = _joint_records(it_end - 1 - rec0, D, K, C, dev)
        out = None if R_chunk is None else torch.empty(
            (D + K + 3, C), dtype=torch.float32, device=dev)
        build.check(lib, lib.odelib_joint(
            *head, _ptr(state), _ptr(out), *(r.data_ptr() for r in recs),
            C, D, K, int(it_base), int(it_end), int(rec0), *tail), "joint")
        LAUNCHES["joint_metropolis_hastings_fused"] += 1
        return recs if R_chunk is None else (recs, out)
    # alive as long as the launcher
    launch.keep = (plan_i, plan_f, exp_tab, walk_t, prior_t)
    return launch


def joint_metropolis_hastings_fused(
        specs, idx_maps, obs_list, times_list, y0_list, theta0, seed: int,
        *, nits: int = 1000, burnin: Optional[int] = None,
        walk_mask: Optional[Sequence[float]] = None,
        rwalk_std: float = 0.05, substeps_list=None,
        stepper: str = "dopri5", tile_chains: Optional[int] = None,
        interpret: bool = False, mesh=None, priors=None,
        checkpoint_every: Optional[int] = None,
        checkpoint_path: Optional[str] = None,
        resume_from: Optional[str] = None, config_token: str = "",
        _stop_after_chunks: Optional[int] = None, device="cuda"):
    """Run C joint chains over K experiments in one kernel launch.

    ``theta0`` is (C, D) float32 joint thetas; a CUDA tensor launches the
    joint kernel, a CPU one runs its twin, an array goes to ``device``
    (the card by default; without CUDA it raises unless
    ``device='cpu'``). ``idx_maps`` gives each
    experiment's gather map into the joint theta and ``substeps_list`` its
    substeps (default 4 each). ``priors``: one distribution (or None) per
    joint dimension, added once to the acceptance (a family without an
    in-kernel form raises ``ValueError``). Returns ``JointFusedOutput``.

    ``checkpoint_every``/``checkpoint_path``/``resume_from``/
    ``config_token``/``_stop_after_chunks`` as in
    ``cuda_mh.metropolis_hastings_fused`` (``_joint_fused_chunked``): the
    proposals in chunks, one launch each, bitwise one launch's records;
    the chunks carry the joint state (log-theta, chi, the parts, the
    accept count, the log prior), and a progress file of another joint
    configuration, or of ``odelib_tpu``, fails the resume with
    ``ValueError``. ``tile_chains``/``interpret`` are accepted and
    ignored; a ``mesh`` raises ``NotImplementedError``."""
    _check_mesh(mesh)
    # JointFit integrates dopri5 or rk4 under every method (kvaerno3 too,
    # as odelib_tpu/joint.py does): the joint kernel holds those two
    _check_stepper(stepper, ("dopri5", "rk4"))
    if burnin is None:
        burnin = int(nits / 2)
    theta0 = _as_f32_tensor(theta0, device)
    C, D = theta0.shape
    specs = tuple(specs)
    K = len(specs)
    idx_maps = tuple(tuple(int(i) for i in m) for m in idx_maps)
    for sp, m in zip(specs, idx_maps):
        if len(m) != sp.theta_size:
            raise ValueError(f"idx map length {len(m)} != spec theta size "
                             f"{sp.theta_size}")
        if any(i < 0 or i >= D for i in m):
            raise ValueError(f"idx map {m} out of range for joint size {D}")
    if nits - 1 <= burnin:
        raise ValueError(f"nits={nits} leaves no recorded iterations after "
                         f"burnin={burnin}")
    prior = checked_priors(priors, D, "joint dimension")
    if walk_mask is None:
        walk_mask = [1.0] * D
    walked = tuple(float(w) != 0.0 for w in walk_mask)
    walk = tuple(float(rwalk_std) * float(w) for w in walk_mask)
    if 2 * sum(walked) + 1 > _SLOT_BUDGET:
        raise ValueError(
            "per-iteration RNG slot budget (1024) exhausted — too many "
            "draw sites (walked parameters) for the fused kernel")
    if substeps_list is None:
        substeps_list = [4] * K
    subs = tuple(_normalize_substeps(sub, len(np.asarray(tm)) - 1)
                 for sub, tm in zip(substeps_list, times_list))
    plans = tuple(_build_plan(sp, obs, tm, sub)
                  for sp, obs, tm, sub in zip(specs, obs_list, times_list,
                                              subs))
    y0s = tuple(np.asarray(y0, np.float64) for y0 in y0_list)
    th0 = theta0.t().contiguous()
    if th0.device.type == "cuda":
        for sp in specs:   # raises RhsTraceError for an RHS the kernel
            rhs_program(sp)  # cannot take
        launcher = joint_launcher
    else:
        launcher = twin_launcher(joint_plain)

    def make(R_chunk=None):
        return launcher(specs, plans, y0s, idx_maps, stepper, th0, seed,
                        nits=int(nits), burnin=int(burnin), walk=walk,
                        walked=walked, prior=prior, R_chunk=R_chunk)
    static = ("joint", tuple(sp.pnames for sp in specs), idx_maps, D, K, C,
              int(nits), int(burnin), walk, stepper, subs, int(seed),
              chunked.prior_key(prior), str(config_token))
    recs = chunked.run(make, "joint MCMC", static, nits=int(nits),
                       burnin=int(burnin), device=th0.device,
                       checkpoint_every=checkpoint_every,
                       checkpoint_path=checkpoint_path,
                       resume_from=resume_from, stop_after=_stop_after_chunks)
    if recs is None:
        return None
    th_r, chi_r, parts_r, ar_r = recs
    return JointFusedOutput(
        theta=th_r.permute(2, 0, 1), chi=chi_r.t(),
        chi_parts=parts_r.permute(2, 0, 1), acceptance_ratio=ar_r.t(),
        iteration=torch.arange(1, nits, device=th0.device)[burnin:])
