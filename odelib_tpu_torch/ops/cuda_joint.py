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
``tile_chains`` is accepted and ignored.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..rhs import trace_rhs
from .cuda_mh import (_M32, _SLOT_BUDGET, _STEPPER_ID, LAUNCHES, Rng,
                      _as_f32_tensor, _build_plan, _check_stepper,
                      _check_unported, _normalize_substeps, make_scorer,
                      plan_tables)
from .runge_kutta import const


class JointFusedOutput(NamedTuple):
    """Post-burnin joint records. Leading axes: (chains, records)."""
    theta: Any             # (C, R, D)
    chi: Any               # (C, R) total
    chi_parts: Any         # (C, R, K)
    acceptance_ratio: Any  # (C, R)
    iteration: Any         # (R,)


def joint_plain(specs, plans, y0s, idx_maps, theta0, seed, *, nits, burnin,
                walk, walked, stepper="dopri5"):
    """Twin of the joint kernel: ``theta0`` (D, C) float32; returns the
    chain-minor records theta (R, D, C), chi (R, C), chi parts (R, K, C)
    and acceptance ratio (R, C), R = nits - 1 - burnin. ``walk`` is the
    per-dimension scale ``rwalk_std * walk_mask`` and ``walked`` marks the
    dimensions that draw a normal."""
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
    R = nits - 1 - burnin
    rng = Rng(seed, torch.arange(C, device=dev))
    chi, parts = joint_score(list(theta0))
    lt = [torch.log(th) for th in theta0]
    acc = torch.zeros_like(chi)
    recs = (torch.empty((R, D, C), dtype=torch.float32, device=dev),
            torch.empty((R, C), dtype=torch.float32, device=dev),
            torch.empty((R, K, C), dtype=torch.float32, device=dev),
            torch.empty((R, C), dtype=torch.float32, device=dev))
    for it in range(1, nits):
        rng.start(it)
        prop = [lt[d] + const(walk[d], chi) * rng.normal() if walked[d]
                else lt[d] for d in range(D)]
        chi_new, parts_new = joint_score([torch.exp(v) for v in prop])
        u = rng.uniform()
        accept = torch.exp(chi - chi_new) > u   # NaN / -inf ratio rejects
        lt = [torch.where(accept, a, b) for a, b in zip(prop, lt)]
        chi = torch.where(accept, chi_new, chi)
        parts = [torch.where(accept, a, b) for a, b in zip(parts_new, parts)]
        acc = acc + accept.to(torch.float32)
        r = it - 1 - burnin
        if r >= 0:
            recs[0][r] = torch.stack([torch.exp(v) for v in lt])
            recs[1][r] = chi
            recs[2][r] = torch.stack(parts)
            recs[3][r] = acc / torch.full_like(acc, float(it))
    return recs


def joint_tables(specs, plans, y0s, idx_maps, stepper):
    """The K plans as one pair of flat tables (``plan_tables`` of each,
    concatenated) and the experiment table the kernel reads: per
    experiment its two plan offsets, its model (an index into
    :func:`~odelib_tpu_torch.ops.build.distinct_programs`) and its idx map
    padded to the widest model. Returns (plan_i, plan_f, exp_tab, width)."""
    from .build import distinct_programs
    programs, model_of = distinct_programs(specs)
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
                   nits, burnin, walk, walked):
    """Prepare the joint kernel for chains ``th0`` (D, C) on the card and
    return ``launch() -> records`` (as :func:`joint_plain`); each call
    launches the kernel once (and counts it)."""
    from . import build
    lib = build.load_kernels(specs[0], specs[1:])
    dev = th0.device
    D, C = th0.shape
    K = len(specs)
    R = nits - 1 - burnin
    plan_i, plan_f, exp_tab, width = joint_tables(specs, plans, y0s,
                                                  idx_maps, stepper)
    plan_i, exp_tab = (torch.as_tensor(a, device=dev)
                       for a in (plan_i, exp_tab))
    plan_f = torch.as_tensor(plan_f, device=dev)
    # per dimension: the walk scale, then the walked flag
    walk_t = torch.as_tensor(np.asarray(
        tuple(walk) + tuple(float(w) for w in walked), np.float32),
        device=dev)
    recs = (torch.empty((R, D, C), dtype=torch.float32, device=dev),
            torch.empty((R, C), dtype=torch.float32, device=dev),
            torch.empty((R, K, C), dtype=torch.float32, device=dev),
            torch.empty((R, C), dtype=torch.float32, device=dev))
    args = (plan_i.data_ptr(), plan_f.data_ptr(), exp_tab.data_ptr(), width,
            th0.data_ptr(), walk_t.data_ptr(),
            *(r.data_ptr() for r in recs), C, D, K, int(nits), int(burnin),
            int(np.uint32(np.int64(seed) & _M32)), _STEPPER_ID[stepper],
            build.stream(dev))

    def launch():
        build.check(lib, lib.odelib_joint(*args), "joint")
        LAUNCHES["joint_metropolis_hastings_fused"] += 1
        return recs
    launch.keep = (plan_i, plan_f, exp_tab, walk_t)   # alive with the launcher
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
        resume_from: Optional[str] = None, config_token: str = ""):
    """Run C joint chains over K experiments in one kernel launch.

    ``theta0`` is (C, D) float32 joint thetas; a CUDA tensor launches the
    joint kernel, a CPU one runs its twin. ``idx_maps`` gives each
    experiment's gather map into the joint theta and ``substeps_list`` its
    substeps (default 4 each). Returns ``JointFusedOutput``. ``tile_chains``
    /``interpret``/``config_token`` are accepted and ignored; in-kernel
    priors, checkpointing and meshes are not ported yet and raise
    ``NotImplementedError``."""
    from .build import JOINT_DMAX, JOINT_KMAX
    _check_unported(priors, checkpoint_every, checkpoint_path, resume_from,
                    mesh)
    _check_stepper(stepper)
    if burnin is None:
        burnin = int(nits / 2)
    theta0 = _as_f32_tensor(theta0)
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
    if K > JOINT_KMAX or D > JOINT_DMAX:
        raise ValueError(f"the joint kernel holds at most {JOINT_KMAX} "
                         f"experiments and {JOINT_DMAX} joint slots, got "
                         f"{K} and {D}")
    if nits - 1 <= burnin:
        raise ValueError(f"nits={nits} leaves no recorded iterations after "
                         f"burnin={burnin}")
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
    plans = tuple(_build_plan(sp, obs, tm, _normalize_substeps(
        sub, len(np.asarray(tm)) - 1))
        for sp, obs, tm, sub in zip(specs, obs_list, times_list,
                                    substeps_list))
    y0s = tuple(np.asarray(y0, np.float64) for y0 in y0_list)
    th0 = theta0.t().contiguous()
    kw = dict(nits=int(nits), burnin=int(burnin), walk=walk, walked=walked)
    if th0.device.type != "cuda":
        recs = joint_plain(specs, plans, y0s, idx_maps, th0, seed,
                           stepper=stepper, **kw)
    else:
        for sp in specs:   # raises RhsTraceError for an RHS the kernel
            trace_rhs(sp.rhs, len(sp.snames), sp.theta_size)  # cannot take
        recs = joint_launcher(specs, plans, y0s, idx_maps, stepper, th0,
                              seed, **kw)()
    th_r, chi_r, parts_r, ar_r = recs
    return JointFusedOutput(
        theta=th_r.permute(2, 0, 1), chi=chi_r.t(),
        chi_parts=parts_r.permute(2, 0, 1), acceptance_ratio=ar_r.t(),
        iteration=torch.arange(1, nits, device=th0.device)[burnin:])
