"""Drive odelib_tpu_torch's main paths once on one CUDA card.

    python3 chip_smoke.py

Phases, each failing the script if it fails:

1. device: the card's name and power limit (nvidia-smi); exits non-zero
   without CUDA;
2. build: all six kernels (ops/csrc/*.cu) from the checkout's sources
   into a clean build directory, every library the run loads started
   together, eight at a time: the main-path model's, a joint fit of two
   different models' (zero_i and one_i), the PMMH path's SDE model's,
   each scoring branch's and path's, and the stiff path's two (zero_i's
   and Robertson's, with the kvaerno3 instantiations) and the PMMH
   path's Milstein library; the builds' seconds and each kernel's
   registers, stack and spills;
3. kernel versus twin on the card, at the main-path model (zero_i on the
   demo data, t_steps=288, substeps=4): the survey on 4096 LHS draws, MH
   on 1024 chains x 200 iterations (the kernel's rounds counted by the
   iterations each completes), the ensemble on 2048 walkers (two
   ensembles of 1024) x 50 iterations, in one launch of as many blocks as
   can be co-resident and again on 7 blocks of 32 threads, so each thread
   loops over 4-5 of the 1024 columns, PT with the main path's 4 rungs on
   1024 chains x 100 iterations, and with 3 (an idle lane in each chain's
   group of 4) and 8 rungs on 1000 chains x 60 (identical accept
   sequences and swap counts),
   the joint kernel on the heterogeneous pair zero_i + one_i, 256
   chains x 20 iterations, and with a third experiment (K = 3, blocks of
   three warps) on 1000 chains, so the last block has dead lanes, and
   the ensemble (512 walkers, substeps=100) and the joint pair (256
   chains, substeps=50) x 3 iterations with plans above the 48 KB staged
   in shared memory, so both kernels read their tables from global
   memory, and with in-kernel priors: four assignments over zero_i's
   slots that together cover the ten in-kernel families (``prior_sets``),
   each through MH (1024 chains x 12), the ensemble (2048 walkers x 10),
   PT (1024 chains x 4 rungs x 12) and the joint pair zero_i + one_i (256
   chains x 12), from start points around the fit (all bitwise records);
4. the main paths, each with launch counts reset just before and read just
   after (each launching survey_fused and its chain kernel's wrapper
   once; Python's garbage collections per stage, and for MH the chains
   stage's host part, kernel time and record allocations):
   ModelFramework(..., device='cuda').MCMC(chain_inits=10000,
   iterations_per_chain=1000, fitsurvey_samples=1000, sd_fitdistance=6.0)
   with sampler='mh', 'ensemble' and 'pt' (temperatures (1, 2, 4, 8)):
   the posterior's columns, finite chi, mean final acceptance in the
   sampler's band, the printed Fitting Report, and for PT a finite swap
   rate in (0, 1]; JointFit({a, b}, shared=['phi', 'beta']).MCMC(10000
   chains x 1000 iterations) of zero_i on the demo data (a) and on the
   same frame with perturbed log abundances and initial abundances x 1.13
   (b); ModelFramework(GBM with diffusion=).MCMC(sampler='pmmh', 10240
   chains x 128 particles x 200 iterations, 40 Euler steps per 0.5
   interval, LogNormal prior, adaptation): finite chi, the frozen-phase
   acceptance in [0.15, 0.5], and the posterior of log mu against the
   exact grid-Kalman posterior of the target the kernel samples
   (|mean - exact| < 0.02, std within rtol 0.05). Then each of six
   kernels, through its public wrapper, against its twin on its main
   path's own inputs, captured where the path calls the wrapper:
   survey_fused (the MH path's 1,000 draws), metropolis_hastings_fused (all
   10,000 chains and the path's seed x 50 iterations, and the first 9,997
   chains, so the last warp's group of 8 chains is part empty; rounds of
   2 and 3 iterations must both occur), ensemble_fused (its 10,000
   walkers and seed, the default tile of 4096, padded to 12,288 walkers;
   50 iterations; the tile sets each walker's partners, so this is the
   geometry the main path runs),
   parallel_tempering_fused (all 10,000 chains x 4 rungs x 20 iterations:
   40,000 threads, so the last block of 128 is part empty; identical swap
   counts), joint_metropolis_hastings_fused (all 10,000 chains x 50
   iterations) and pmmh_fused (all 10,240 chains x 128 particles x 20
   iterations, adapting for 10); every comparison of phases 3-4 fails on
   any bit. The slice's path: the MH, ensemble and PT main paths again
   with use_priors=True (the demo's lognormal priors) and substeps='auto'
   (the schedule calibrated from the run's seeds, printed with its
   schedule_cost against substeps=4's 68 steps and the calibration
   call's seconds; the ensemble's share of walkers ending at mu = 0), and
   JointFit.MCMC(use_priors=True), each with the finite-chi and
   acceptance checks and its launch counts; then calibrate_substeps on
   the MH path's seeds on the card and on the CPU, which must agree; the
   calibrated schedule's chi against the adaptive solve's on the MH
   path's 10,000 seeds and final draws, as the JAX package's accuracy
   gate measures it (float64, adaptive Dopri5 at rtol 1e-6 and atol 1e-2
   on the full grid; near the fit, chi < 500, within 1e-4), beside
   substeps=4 and the survey kernel's float32 chi; and each prior-aware
   path's wrapper call, captured where the path made it (all 10,000
   chains, the demo's priors, the calibrated schedule; the joint fit's
   'auto' resolves to 4), through its kernel and through its twin
   (every launcher swapped for its twin), bitwise: MH, ensemble and
   joint x 50 iterations, PT x 20. Then chunked checkpointing, on the MH,
   ensemble, PT and PMMH paths' and both joint paths' (with and without
   priors) captured wrapper calls at their full run lengths: (a) each
   wrapper with checkpoint_every (250; PMMH 64, so its
   burn-in of 100 spans two boundaries while the scale adapts) against
   its whole run, bitwise, one launch a chunk, both timed (CUDA events
   around the wrapper call); (b) each run killed after its first chunk
   (``_stop_after_chunks``) and resumed from its progress file, bitwise
   the uninterrupted run, and a changed checkpoint_every refused; (c)
   ModelFramework.MCMC(sampler='mh') at full width with
   checkpoint_every=250 and a file, between two runs without: the wall
   times, each progress write's seconds, the posterior save's and the
   files' sizes, and the posterior equal to the plain run's; (d)
   MCMC(sampler='mh', until_min_ess=1.5 x a first run's least ESS) at
   2,000 chains x 200 iterations: at least one extension, the iteration
   column rising without a reset, acceptance_ratio x iteration integral,
   and the target met or the cap's warning given; (e) the joint kernel's
   chunk instantiation against the twin's chunk mode at both joint paths'
   inputs (all chains, 50 proposals in chunks of 20), bitwise; (f)
   JointFit.MCMC at the joint path's shape with checkpoint_every=250 and
   a file (four chunk launches, the posterior equal to the joint path's),
   then killed after its first chunk and resumed (equal again); (g)
   JointFit.MCMC(until_min_ess=1.5 x the joint path's least ESS,
   max_extensions=1) at the joint path's shape, with (d)'s checks and
   chi = chi:a + chi:b (NaN where NaN: a chain restarted where its solve
   fails keeps a NaN chi). Then
   PMMH's Milstein step on config 14: MCMC(sampler='pmmh',
   sde_method='milstein') at the Euler path's shape with its bands (log
   mu against kalman_posterior, frozen-phase acceptance), the Milstein
   pf_kernel (a library built with ODE_MILSTEIN) against its twin at
   every chain (3 proposals, 1 adapting), 4 chunks of 64 against the
   whole run bitwise, and its time beside Euler's on the same chains
   (Euler, Milstein, Euler). Then the scoring
   phases (every observation model, censoring and doses): (1) the Tobit
   device functions (probe kernel ``odelib_tobit``) against float64: log
   Phi within 2e-6 relative on z in [-37, 8], the t log-CDF within 1e-5
   for nu in {1, 2, 4, 10, 30, 100} on z in [-50, 50]; (2) every kernel
   against its twin (``plain_launchers``) on each compiled scoring branch
   of zero_i on the demo data (``SCORING``: lognormal censored and/or
   dosed, Student-t, Poisson on the counts / 1e5, negbinom r = 10, with
   and without a virus dose; host points below 1.5e6 left-, virus points
   above 2.5e8 right-censored): the survey on 1,000 draws, MH on 512
   chains, the ensemble on 512 walkers, PT on 256 chains x 3 rungs and the
   joint kernel (two experiments of the branch sharing phi and beta, so
   the branch's own library) on 128 chains, 5 proposals each, substeps 1,
   and the particle filter on the PMMH path's GBM under four branches
   (``PF_SCORING``), 512 chains x 128 particles x 5 proposals: equal
   accept sequences, every record bitwise (the Tobit branches within 1e-6
   relative); (3) paths (a)-(e) at full width, each
   with launch counts reset just before and read just after: (a)
   MCMC(sampler='mh', use_priors=True) on pk_oral with six doses and its
   points under the LLOQ left-censored, (b) sampler='pt' on zero_i with
   Student-t nu = 4 and four host points left-censored, (c)
   sampler='ensemble' on the demo as negbinom counts (12,288 walkers),
   (d) JointFit of zero_i (Poisson) and one_i (lognormal, censored), (e)
   sampler='pmmh' on the GBM with Student-t and a dose: the reference's
   posterior columns, finite chi, acceptance in (0, 1), the path's kernel
   launched once; (4) each of those paths' wrapper calls, captured where
   the path made it (all chains), through its kernel and through its twin
   for 10 proposals (PMMH: 20, 10 of them adapting): equal accept
   sequences, every record bitwise (the Tobit paths (a), (b) and (d)
   within 1e-6 relative); (5) paths (a)-(c)'s wrapper calls against the demo
   paths' (CUDA events around the call) and each kernel's time on each
   scoring branch at the main paths' shapes beside the demo's;
Then the stiff path (the survey, MH, ensemble and PT kernels'
   kvaerno3 instantiations, built from a library with ODE_KVAERNO3): (b)
   bench/suite.py's config 6 through the user API,
   ModelFramework(zero_i, the demo).MCMC(method='kvaerno3', substeps=4)
   with 10,240 chains x 1,000, and the ensemble (12,288 walkers) and PT
   (10,000 chains x 4 rungs) on it, each with the survey and its chain
   kernel launched once with stepper kvaerno3, finite chi 1.0 and the
   sampler's acceptance band; then MH with substeps='auto' (calibrated by
   Kvaerno5), printing the schedule and its step count; (c) the
   Robertson fit (``scoring_cases.robertson_frame``: y1 at config 5's
   grid with log-normal noise, the framework's grid spaced 1e-3, atol
   1e-12; the observation times that snap to other grid points printed)
   with MCMC(sampler='mh', method='kvaerno3', substeps='auto') at 10,240
   chains x 1,000, and its gates: fixed Kvaerno3 x 8 on config 5's grid
   on the card within 1e-3 relative of LSODA, fixed Dopri5 at the same
   steps not finite; (a) each of the four kernels against its twin at
   the wrapper calls (b) and (c) made (the survey's draws of config 6,
   of its 'auto' run and of the Robertson fit; MH at config 6, on its
   'auto' schedule and on Robertson's, S = 3, all chains x 10 proposals;
   the ensemble and PT, all chains x 5), bitwise, and MH in 4 chunks of
   250 against its whole run, bitwise; (d) config 5's 4,096 Robertson
   solves on the card through the port's torch solvers (fixed Kvaerno3,
   adaptive Kvaerno5, auto_stiff_grid and the two-pass
   odeint_grid_batch), each with bench/suite.py's gate; (e) each
   kvaerno3 kernel's time against its dopri5 instantiation at config 6's
   shapes (CUDA events), its twin's and its bound (``kernel_costs``, as
   phase 5 times the dopri5 kernels). Then forcings and array
   parameters, each path through the user API at full width with its
   launch counts reset just before and read just after, its sampler's
   band, and its wrapper calls (the survey's and the chain kernel's,
   captured where the path made them) through kernel and twin at all
   chains for 20 proposals (PMMH: 10 of them adapting), bitwise: forcings
   (a) MCMC(sampler='mh') on zero_i with its growth scaled by g = ((0,
   1.5, 3.2), (0.8, 1.4, 0.9)) in 'linear' mode (10,000 x 1,000, the
   demo data), (b) the ensemble (12,288 walkers) with g in 'cubic' mode,
   (c) PT (10,000 x 4 rungs) with g in 'hold' mode and
   MCMC(method='kvaerno3') MH (10,240 chains), (d) JointFit.MCMC of
   zero_i on the demo and forced zero_i on it perturbed (numpy seed 7),
   (e) PMMH on config 14's GBM, its drift scaled by a linear forcing;
   g = 1: the forced MH and PMMH paths' seeds and records bitwise the
   unforced main paths'; array (a) MCMC(use_priors=True) on zero_i with
   mu a 2-vector (per-slot priors), (b) with mu = [mu0, 0], the pinned
   entry exactly 0 in every row; and each forced kernel's time beside the
   unforced one on the same chains in the same call (the kernels line's
   ``:forced``, ``:forced-kvaerno3`` and ``:array`` rows). Then the
   shapes beyond the kernels' first limits, each path through the user
   API at full width with its launch counts reset just before and read
   just after, finite chi 1.0 and acceptance in (0, 1): limits (a)
   MCMC(sampler='pt') on Lotka-Volterra (``scoring_cases.lv_frame``:
   prey and predator at 25 times over [0, 50] from the defaults, log-normal
   noise sd 0.1, numpy seed 13) on a 16-rung geometric ladder from 1 to
   1,000 at 10,000 chains x 1,000, and on 40 rungs (the WIDE pt_kernel: a
   chain over two warps, a library built with ODE_WIDE) at 256 chains;
   (b) JointFit.MCMC of 12 chemostat runs at d = 0.05, ..., 0.60 (R and N
   at 16 times over [0, 80], sd 0.1, numpy seed 11; shared vmax, Ks and
   gamma, each run's d and Rin static slots) at 10,000 chains x 1,000,
   and of 40 runs at d = 0.015, ..., 0.6 with Ks and gamma per run (D =
   161, 81 walked) at 256 chains, both joint_kernel's WIDE instantiations; (c)
   MCMC(sampler='mh', substeps=4) on two_i with 40 latent classes (42
   states, the host summing 41: member masks of two words) on the demo
   data at 10,000 chains x 1,000. Each path's wrapper call through kernel
   and twin on its first chains for 1-2 proposals, bitwise; for (c) also
   the survey on the path's 1,000 draws, the ensemble (256 walkers), PT (16
   chains x 3 rungs) and kvaerno3 MH (4 chains, substeps 1, on the data's
   first three sampling times; its library's unrolled elimination and
   solves, its nvcc seconds in the build phase) at the path's seeds (PMMH at 33 states is the card test
   ``test_chain_model_pf_kernel_matches_twin``: its library's particle
   filters take ~15 minutes of nvcc); and each new instantiation's time
   (the kernels line's ``:16-rungs``, ``:40-rungs``, ``:wide-12``,
   ``:wide-40``, ``:42-states`` and ``:42-states-kvaerno3`` rows);
5. times: each kernel against its plain torch twin on the card at the main
   path's shapes (CUDA events; the twin over a few proposals, scaled), the
   MH, ensemble, PT and joint kernels with the demo's priors, with flat
   priors (the prior-free run's chains, so the prior's own cost) and MH on
   the calibrated schedule, the MCMC wall times with their stage breakdowns,
   and one more MH and
   ensemble run each under torch.profiler: the device's busy share (the
   union of its kernels' and copies' intervals), each kernel's launches,
   mean duration and mean gap between launches, and exactly one device
   launch of the ensemble kernel on its path. Each kernel's bound is the
   larger of its float32 operations (counted by running its twin on the
   CPU under a counting dispatch mode; per chain and iteration they do not
   depend on the data but for the particle filter's selection, which
   twin and kernel make by a search, one add per particle and state,
   or by a masked sum where rounding made the prefix sum dip: averaged
   over PF_OPS_CHAINS chains) over the FP32 peak and its
   bytes (inputs read once, outputs written once) over the memory rate.

Each phase's header gives the seconds since the start; the twins on the
card are launch-bound and take most of the run. Prints the device line
and a JSON line of kernels before the last line, and as the last line
``{"ok": true, "device": {...}}``.
"""
import contextlib
import io
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FP32_PEAK = 67e12      # H100 SXM float32 outside the tensor cores, FLOP/s
MEM_RATE = 3.35e12     # H100 SXM HBM3, bytes/s
NITS, BURNIN, CHAINS = 1000, 500, 10000
TEMPS = (1.0, 2.0, 4.0, 8.0)
BANDS = {"mh": (0.1, 0.6), "ensemble": (0.1, 0.8), "pt": (0.1, 0.6),
         "joint": (0.1, 0.6)}
# the PMMH path: bench/suite.py's config 14 as a user would call it
PF_CHAINS, PF_NITS, PF_K, PF_SUB = 10240, 200, 128, 40
# chains whose twins' float32 operations (counted on the host CPU, a few
# seconds each) average into the particle filter's bound
PF_OPS_CHAINS = 2
MU, SIG, S_OBS = 0.4, 0.3, 0.15
PRI_MU, PRI_SD = 0.4, 0.5          # mu ~ lognorm(s=PRI_SD, scale=PRI_MU)
CENTRE = (0.6, 2.4e-8, 24.0)       # zero_i's fit region: mu, phi, beta
# the stiff path: bench/suite.py's config 6 (10,240 chains), the ensemble
# main path's 12,288 walkers, config 5's batch of 4,096 Robertson solves
STIFF_CHAINS, STIFF_WALKERS, CONFIG5_N = 10240, 12288, 4096


def prior_sets():
    """Four prior assignments over zero_i's slots (mu, phi, beta) that
    together cover the ten in-kernel families, centred on CENTRE so the
    chains accept (tests/test_torch_mh_prefetch.py's PRIOR_SETS); the
    last leaves phi without a prior."""
    from odelib_tpu_torch import distributions as D
    return {
        "lognormal-normal-uniform": (
            D.LogNormal(s=0.05, scale=0.6),
            D.Normal(loc=2.4e-8, scale=0.1e-8),
            D.Uniform(loc=22.0, scale=4.0)),
        "gamma-truncnorm-exponential": (
            D.Gamma(a=400.0, scale=0.0015),
            D.TruncNormal(a=-1.5, b=1.5, loc=2.4e-8, scale=0.1e-8),
            D.Exponential(loc=20.0, scale=2.0)),
        "cauchy-halfnormal-weibull": (
            D.Cauchy(loc=0.6, scale=0.01),
            D.HalfNormal(loc=2.2e-8, scale=0.2e-8),
            D.Weibull(c=40.0, scale=24.5)),
        "beta-none-gamma": (
            D.Beta(a=60.0, b=40.0), None, D.Gamma(a=600.0, scale=0.04)),
    }


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


T0 = time.perf_counter()


def phase(name):
    print(f"== {name} (at {time.perf_counter() - T0:.0f} s)", flush=True)


# Python's garbage collections, (start, end, generation) on the host
# clock: each main path reports those that fell inside its MCMC call
GC_SPANS = []


def _gc_probe(stage, info):
    if stage == "start":
        _gc_probe.t = time.perf_counter()
    else:
        GC_SPANS.append((_gc_probe.t, time.perf_counter(),
                         info["generation"]))


def gc_report(t0, stages):
    """The collections since GC_SPANS was cleared, by the MCMC stage (from
    ``last_profile``'s durations after ``t0``) in which each started."""
    edges, at = [], t0
    for name, secs in stages.items():
        at += secs
        edges.append((at, name))
    per = {}
    for s, e, gen in GC_SPANS:
        name = next((n for end, n in edges if s < end), "after")
        n, secs, gens = per.get(name, (0, 0.0, set()))
        per[name] = (n + 1, secs + (e - s), gens | {gen})
    total = sum(e - s for s, e, _ in GC_SPANS)
    return (f"garbage collections: {len(GC_SPANS)}, {total:.6f} s; "
            + (", ".join(f"{k}: {n} ({secs:.6f} s, generations "
                         f"{sorted(g)})" for k, (n, secs, g) in per.items())
               or "none"))


def events_ms(fn, reps=1):
    import torch
    fn()                                  # warm-up (and lazy build)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_kernels(prof):
    """The device activities (kernels, copies) of a finished torch.profiler
    profile, from the device's timestamps: {name: [(start_us, end_us),
    ...]} in start order."""
    from torch.autograd import DeviceType
    spans = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            spans.setdefault(ev.name, []).append(
                (ev.time_range.start, ev.time_range.end))
    return {k: sorted(v) for k, v in spans.items()}


def launch_stats(spans):
    """Launches, total ms, mean us per launch and the mean gap in us from
    one launch's end to the next one's start (None for one launch)."""
    durs = [e - s for s, e in spans]
    gaps = [s1 - e0 for (_, e0), (s1, _) in zip(spans, spans[1:])]
    return (len(spans), sum(durs) / 1e3, sum(durs) / len(durs),
            sum(gaps) / len(gaps) if gaps else None)


def print_launches(kernels, top=8):
    """One line per device activity, the busiest first."""
    for name, spans in sorted(kernels.items(),
                              key=lambda kv: -sum(e - s for s, e in kv[1])
                              )[:top]:
        n, ms, mean_us, gap_us = launch_stats(spans)
        gap = "-" if gap_us is None else f"{gap_us:.3f} us"
        print(f"  {n:6d} launches {ms:10.3f} ms  mean {mean_us:10.3f} us  "
              f"gap {gap}  {name[:80]}")


def fp32_ops(fn):
    """Float32 arithmetic operations (elements) that ``fn`` runs, counted
    at the aten level: the twins perform the kernels' float32 operations
    in the same order. Integer RNG work, comparisons and selects are not
    counted, so the count is a lower bound of the kernels' work."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    arith = {"add", "sub", "rsub", "mul", "div", "exp", "log", "sqrt",
             "cos", "sin", "neg", "abs", "pow"}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if (name in arith and isinstance(out, torch.Tensor)
                    and out.dtype == torch.float32):
                Count.n += out.numel()
            return out
    with Count():
        fn()
    return Count.n


def per_iteration_ops(run):
    """(init, per iteration without a record row, extra per record row)
    float32 operations of a twin ``run(nits, burnin)``, per chain."""
    c = {k: fp32_ops(lambda k=k: run(*k)) for k in ((2, 1), (3, 2), (3, 1))}
    walk = c[(3, 2)] - c[(2, 1)]
    rec = c[(3, 1)] - c[(3, 2)]
    return c[(2, 1)] - walk, walk, rec


def bound(ops, nbytes):
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / MEM_RATE
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def accept_steps(ar, nits):
    """Per-iteration accept indicators (R, C) from running acceptance
    ratios (R, C) recorded from iteration 1."""
    import numpy as np
    return np.diff(np.concatenate([np.zeros((1, ar.shape[1])), np.round(
        ar * np.arange(1, nits)[:, None])]), axis=0)


MH_LABELS = ("theta", "chi", "rsquared", "aic", "ar", "sw")


def compare_records(name, rec_k, rec_t, nits, labels=MH_LABELS, burnin=0):
    """Kernel against twin records (chain-minor, from iteration burnin +
    1): identical accept sequences and every record bitwise equal (the same
    float32 operations); returns chi's max abs error."""
    import numpy as np
    rec_k = [r.cpu().numpy() for r in rec_k]
    rec_t = [r.cpu().numpy() for r in rec_t]
    ar = labels.index("ar")
    its = np.arange(burnin + 1, nits)[:, None]
    steps_k, steps_t = (np.diff(np.round(r[ar] * its), axis=0)
                        for r in (rec_k, rec_t))
    if (steps_k != steps_t).any() or (
            np.round(rec_k[ar][0] * its[0]) != np.round(rec_t[ar][0] * its[0])
    ).any():
        c = np.where((steps_k != steps_t).any(0))[0]
        fail(f"{name}: accept sequences differ for {c.size} chains")
    err = 0.0
    for label, a, b in zip(labels, rec_k, rec_t):
        if not (np.isfinite(a) == np.isfinite(b)).all():
            fail(f"{name}: {label} kernel and twin disagree on finiteness")
        m = np.isfinite(b)
        rel = float(np.max(np.abs(a[m] - b[m]) / np.maximum(np.abs(b[m]),
                                                            1e-30)))
        if label == "chi":
            err = float(np.max(np.abs(a[m] - b[m])))
        print(f"{name} {label}: max rel err {rel:.3g}, bitwise equal "
              f"{np.mean(a[m] == b[m]):.4f}")
        if not (a[m] == b[m]).all():
            fail(f"{name}: {label} kernel and twin differ in bits (max rel "
                 f"err {rel:.3g})")
    return err


def compare_chi(name, chi_k, chi_t):
    """Kernel against twin chi (numpy): every value bitwise equal, NaN
    where the twin's is NaN; returns the max abs error of the finite ones."""
    import numpy as np
    fin = np.isfinite(chi_t)
    same = (chi_k == chi_t) | (np.isnan(chi_k) & np.isnan(chi_t))
    print(f"{name} chi: bitwise equal {np.mean(same):.4f}")
    if not same.all():
        fail(f"{name}: kernel and twin chi differ in bits for "
             f"{int((~same).sum())} of {same.size}")
    return float(np.max(np.abs(chi_k[fin] - chi_t[fin]))) if fin.any() \
        else 0.0


@contextlib.contextmanager
def recording(module, name, store):
    """``module.name`` (a chain wrapper) records the arguments of its
    calls in ``store`` while the block runs."""
    real = getattr(module, name)

    def record(*args, **kw):
        store.update(args=args, kw=kw)
        return real(*args, **kw)
    setattr(module, name, record)
    try:
        yield
    finally:
        setattr(module, name, real)


def kernel_vs_twin_at(label, wrapper, call, nits, tobit=False):
    """A main path's captured wrapper call, cut to ``nits`` iterations
    without burn-in, through its kernel (one launch) and through its twin
    (``plain_launchers``, no launch): identical accept sequences, every
    record (with ``tobit``, censored data: within rtol 1e-6, ``held``) and
    PT's swap rates bitwise. Returns chi's max abs error and the kernel's
    output; the twin run's seconds are left in ``kernel_vs_twin_at.twin_s``
    and the kernel run's launches in ``kernel_vs_twin_at.launches``.
    """
    import torch
    from odelib_tpu_torch.ops import cuda_mh, plain_launchers
    kw = {**call["kw"], "nits": nits, "burnin": 0}
    n0 = sum(cuda_mh.LAUNCHES.values())
    res_k = wrapper(*call["args"], **kw)
    torch.cuda.synchronize()
    n1 = sum(cuda_mh.LAUNCHES.values())
    t0 = time.perf_counter()
    with plain_launchers():
        res_t = wrapper(*call["args"], **kw)
    torch.cuda.synchronize()
    kernel_vs_twin_at.twin_s = time.perf_counter() - t0
    kernel_vs_twin_at.launches = n1 - n0
    if (n1 - n0, sum(cuda_mh.LAUNCHES.values()) - n1) != (1, 0):
        fail(f"{label}: the kernel run launched {n1 - n0} kernels and the "
             "twin run launched some")
    (out_k, rate_k), (out_t, rate_t) = (
        (r, None) if hasattr(r, "_fields") else r for r in (res_k, res_t))
    names = [f for f in out_k._fields if f != "iteration"]
    labels = tuple("ar" if f == "acceptance_ratio" else f for f in names)
    err = held(label, tobit, *([getattr(o, f).movedim(0, -1)
                                for f in names] for o in (out_k, out_t)),
               nits, labels)
    if rate_k is not None and not torch.equal(rate_k, rate_t):
        fail(f"{label}: kernel and twin swap counts differ")
    return err, out_k


def pmmh_twin_kw(kw):
    """``pmmh_plain``'s keywords for a captured ``pmmh_fused`` call's."""
    from odelib_tpu_torch.ops.priors import prior_table
    walk = tuple(float(w) for w in kw["walk_mask"])
    return dict(K=kw["n_particles"], walk=walk,
                walked=tuple(w != 0.0 for w in walk),
                rwalk_std=kw["rwalk_std"], prior=prior_table(kw["priors"]),
                adapt=kw["adapt_proposal"], target=kw["target_accept"],
                adapt_rate=kw["adapt_rate"],
                milstein=kw.get("sde_method") == "milstein")


def pmmh_vs_twin(label, call, nits, burnin):
    """A PMMH path's captured ``pmmh_fused`` call, cut to ``nits``
    iterations (``burnin`` of them adapting), through the kernel (one
    launch) and through ``pmmh_plain``: every record bitwise. Returns
    chi's max abs error and the kernel's output."""
    import torch
    from odelib_tpu_torch.ops import cuda_mh, cuda_pf
    spec, obs, tf, y0, th0 = call["args"]
    kw = call["kw"]
    n0 = sum(cuda_mh.LAUNCHES.values())
    out = cuda_pf.pmmh_fused(*call["args"],
                             **{**kw, "nits": nits, "burnin": burnin})
    torch.cuda.synchronize()
    if sum(cuda_mh.LAUNCHES.values()) != n0 + 1:
        fail(f"{label}: the kernel run did not launch one kernel")
    plan = cuda_mh._build_plan(spec, obs, tf, cuda_mh._normalize_substeps(
        kw["substeps"], len(tf) - 1))
    rec_t = cuda_pf.pmmh_plain(spec, plan, y0, th0.t().contiguous(),
                               kw["seed"], nits=nits, burnin=burnin,
                               **pmmh_twin_kw(kw))
    torch.cuda.synchronize()
    err = compare_records(label, [out.theta.permute(1, 2, 0), out.chi.t(),
                                  out.acceptance_ratio.t()], rec_t, nits,
                          labels=("theta", "chi", "ar"), burnin=burnin)
    return err, out


# csrc/mh.cu's speculation trees: per tree and node, the node after a
# reject and after an accept (-1: the round ends there)
MH_CHILD = (((2, 1), (-1, -1), (3, -1), (-1, -1)),
            ((2, 1), (-1, 3), (-1, -1), (-1, -1)),
            ((-1, 1), (-1, 2), (-1, 3), (-1, -1)))


def rounds_of(steps):
    """The prefetching MH kernel's rounds (csrc/mh.cu) replayed from the
    accept indicators (R, C) of iterations 1 .. nits - 1: each round picks
    its tree from the acceptance so far, as the kernel does in float32, and
    walks it down the decisions. Returns {iterations a round: rounds}."""
    import collections

    import numpy as np
    R, C = steps.shape
    child = np.array(MH_CHILD)
    cols = np.arange(C)
    it = np.ones(C, int)                   # the next iteration
    acc = np.zeros(C, np.float32)
    counts = collections.Counter()
    while (it <= R).any():
        live = it <= R
        past = (it - 1).astype(np.float32)
        tree = np.where(acc > np.float32(0.8) * past, 2,
                        np.where(acc > np.float32(0.5) * past, 1, 0))
        n, k, going = np.zeros(C, int), np.zeros(C, int), live.copy()
        for _ in range(4):
            ok = going & (steps[np.minimum(it - 1 + k, R - 1), cols] > 0.5)
            acc += ok
            k += going
            nxt = child[tree, n, ok.astype(int)]
            going &= (nxt >= 0) & (it + k <= R)
            n = np.where(going, nxt, n)
        counts.update(k[live].tolist())
        it = np.where(live, it + k, it)
    return counts


def gbm_data():
    """tests/test_pallas_pf.py's GBM observations: log N at t = 0.5, ...,
    4.0 from numpy seed 42 (MU, SIG, S_OBS)."""
    import numpy as np
    rng = np.random.default_rng(42)
    t_obs = np.arange(1, 9) * 0.5
    z, zs = np.log(2.0), []
    for dt in np.diff(np.concatenate([[0.0], t_obs])):
        z = z + (MU - 0.5 * SIG ** 2) * dt + SIG * np.sqrt(dt) * rng.normal()
        zs.append(z)
    return t_obs, np.array(zs) + S_OBS * rng.normal(size=len(zs))


def kalman_posterior(t_obs, log_o):
    """Mean and std of log mu under the exact posterior: the GBM with
    lognormal observations is linear-Gaussian in log N, so the likelihood
    is a Kalman filter's, taken on a grid of log mu with the N(log PRI_MU,
    PRI_SD) prior (tests/test_pallas_pf.py:54-66, 94-101). The chain walks
    log mu but weighs the LogNormal density of mu, 1/mu included, with no
    Jacobian term (as the JAX kernel does), so the target it samples in
    log mu carries a further factor 1/mu: the ``- grid`` below."""
    import numpy as np

    def loglik(mu):
        m, P, ll, prev = np.log(2.0), 0.0, 0.0, 0.0
        for t, y in zip(t_obs, log_o):
            dt, prev = t - prev, t
            m += (mu - 0.5 * SIG ** 2) * dt
            P += SIG ** 2 * dt
            S = P + S_OBS ** 2
            ll += -0.5 * np.log(2 * np.pi * S) - 0.5 * (y - m) ** 2 / S
            K = P / S
            m += K * (y - m)
            P *= 1 - K
        return ll
    grid = np.log(PRI_MU) + np.linspace(-3, 3, 601)
    lp = np.array([loglik(np.exp(z)) for z in grid]) \
        - 0.5 * ((grid - np.log(PRI_MU)) / PRI_SD) ** 2 - grid
    w = np.exp(lp - lp.max())
    w /= w.sum()
    mean = float((grid * w).sum())
    return mean, float(np.sqrt(((grid - mean) ** 2 * w).sum()))


def outputs_of(res):
    """Every array of a chain wrapper's result on the host (PT: the
    records, then the swap rate)."""
    parts = (res,) if hasattr(res, "_fields") else res
    return [v.cpu().numpy() for p in parts
            for v in (p if hasattr(p, "_fields") else (p,))]


def same_bits(label, a, b):
    """Two wrapper results, array by array: every bit equal (NaN where
    NaN), or the script fails."""
    import numpy as np
    for i, (x, y) in enumerate(zip(outputs_of(a), outputs_of(b))):
        if x.shape != y.shape or not np.array_equal(
                np.ascontiguousarray(x).view(np.uint8),
                np.ascontiguousarray(y).view(np.uint8)):
            fail(f"{label}: output {i} differs in bits")


def chunk_phases(calls, framework, chains, nits):
    """Chunked checkpointing, bit-exact resume and run-length extension
    on the card. ``calls``: per kernel (label, wrapper, args, kw, E), a
    main path's captured wrapper call and its chunk length. Returns
    {label: (whole ms, chunked ms, chunks)}."""
    import tempfile

    import numpy as np
    import pandas as pd
    import torch
    from odelib_tpu_torch.ops import chunked, cuda_mh
    from odelib_tpu_torch.utils.diagnostics import effective_sample_size

    phase("chunks (a): each chain kernel chunked against its whole run at "
          "the main path's shape, bitwise")
    times = {}
    for label, wrapper, args, kw, E in calls:
        name = wrapper.__name__
        n_chunks = -(-(kw["nits"] - 1) // E)
        n0 = cuda_mh.LAUNCHES[name]
        whole = wrapper(*args, **kw)
        chunk = wrapper(*args, **{**kw, "checkpoint_every": E})
        torch.cuda.synchronize()
        if cuda_mh.LAUNCHES[name] - n0 != 1 + n_chunks:
            fail(f"{label}: {cuda_mh.LAUNCHES[name] - n0} launches, not "
                 f"1 + {n_chunks}")
        same_bits(f"{label} chunked (every {E})", chunk, whole)
        whole_ms = events_ms(lambda: wrapper(*args, **kw), reps=3)
        chunk_ms = events_ms(lambda: wrapper(
            *args, **{**kw, "checkpoint_every": E}), reps=3)
        times[label] = (whole_ms, chunk_ms, n_chunks)
        th0 = next(a for a in args if isinstance(a, torch.Tensor))
        print(f"{label}: {th0.shape[0]} chains x {kw['nits']} "
              f"iterations (burn-in {kw['burnin']}) in {n_chunks} chunks of "
              f"{E}: bitwise the whole run; wrapper call whole {whole_ms:.3f}"
              f" ms, chunked {chunk_ms:.3f} ms ({chunk_ms - whole_ms:+.3f} "
              f"ms, {(chunk_ms - whole_ms) / (n_chunks - 1):+.3f} ms a "
              "boundary)", flush=True)

    phase("chunks (b): kill after the first chunk and resume, through the "
          "public wrappers on the main paths' inputs")
    with tempfile.TemporaryDirectory() as tmp:
        for label, wrapper, args, kw, E in calls:
            path = os.path.join(tmp, f"{wrapper.__name__}.progress")
            whole = wrapper(*args, **kw)
            ck = {**kw, "checkpoint_every": E, "checkpoint_path": path}
            if wrapper(*args, **{**ck, "_stop_after_chunks": 1}) is not None:
                fail(f"{label}: the killed run returned records")
            with np.load(path) as z:
                if int(z["next_chunk"]) != 1:
                    fail(f"{label}: the killed run's file is at chunk "
                         f"{int(z['next_chunk'])}")
            try:
                wrapper(*args, **{**ck, "checkpoint_every": E + 1,
                                  "resume_from": path})
                fail(f"{label}: a changed checkpoint_every resumed")
            except ValueError as e:
                if "different" not in str(e):
                    raise
            res = wrapper(*args, **{**ck, "resume_from": path})
            torch.cuda.synchronize()
            same_bits(f"{label} killed and resumed", res, whole)
            print(f"{label}: killed after chunk 1 of "
                  f"{-(-(kw['nits'] - 1) // E)}, resumed: bitwise the "
                  "uninterrupted run; checkpoint_every "
                  f"{E + 1} refused the file", flush=True)

        phase("chunks (c): MCMC(sampler='mh') checkpointed every 250 "
              "iterations at full width, against the same run without")
        from odelib_tpu_torch.utils import checkpoint as post_io
        writes, saves = [], []
        real_write, real_save = chunked.write_checkpoint, \
            post_io.save_posterior

        def timed(fn, into):
            def run(*a, **k):
                t0 = time.perf_counter()
                fn(*a, **k)
                into.append(time.perf_counter() - t0)
            return run
        chunked.write_checkpoint = timed(real_write, writes)
        post_io.save_posterior = timed(real_save, saves)
        ckpt = os.path.join(tmp, "posterior.npz")
        walls, posts = {}, {}
        try:
            for mode in ("plain", "checkpointed", "plain"):
                fw = framework()
                extra = dict(checkpoint_every=250, checkpoint_path=ckpt) \
                    if mode == "checkpointed" else {}
                writes.clear()
                cuda_mh.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    posts[mode] = fw.MCMC(
                        chain_inits=chains, iterations_per_chain=nits,
                        fitsurvey_samples=1000, sd_fitdistance=6.0,
                        print_report=False, **extra)
                torch.cuda.synchronize()
                walls.setdefault(mode, []).append(time.perf_counter() - t0)
                n_mh = cuda_mh.LAUNCHES["metropolis_hastings_fused"]
                if n_mh != (-(-(nits - 1) // 250) if extra else 1):
                    fail(f"MCMC(mh) {mode}: {n_mh} MH launches")
                if extra:
                    sizes = (os.path.getsize(ckpt + ".progress"),
                             os.path.getsize(ckpt))
                    print(f"MCMC(mh) checkpointed: the {len(writes)} progress "
                          "writes "
                          f"{', '.join(f'{w:.4f}' for w in writes)} s "
                          f"(total {sum(writes):.4f} s), the posterior's "
                          f"save {saves[0]:.4f} s; progress file "
                          f"{sizes[0] / 2 ** 20:.1f} MiB, posterior file "
                          f"{sizes[1] / 2 ** 20:.1f} MiB", flush=True)
        finally:
            chunked.write_checkpoint = real_write
            post_io.save_posterior = real_save
        pd.testing.assert_frame_equal(posts["plain"], posts["checkpointed"])
        print("MCMC(mh) wall seconds, plain "
              f"{', '.join(f'{w:.3f}' for w in walls['plain'])}; "
              "checkpointed "
              f"{', '.join(f'{w:.3f}' for w in walls['checkpointed'])} "
              "(the posteriors equal)", flush=True)

    phase("chunks (d): MCMC(sampler='mh', until_min_ess=...) at 2,000 "
          "chains x 200 iterations")
    n_c, n_it = 2000, 200

    def min_ess(post):
        z = [np.log(np.stack([g[p].to_numpy(float) for _, g in
                              post.groupby("chain#")])) for p in
             ("mu", "phi", "beta")]
        return min(effective_sample_size(x) for x in z)
    with contextlib.redirect_stdout(io.StringIO()):
        first = framework().MCMC(chain_inits=n_c, iterations_per_chain=n_it,
                                 fitsurvey_samples=1000, sd_fitdistance=6.0,
                                 print_report=False)
    target = 1.5 * min_ess(first)
    import warnings
    cuda_mh.reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught, \
            contextlib.redirect_stdout(io.StringIO()):
        warnings.simplefilter("always")
        post = framework().MCMC(chain_inits=n_c, iterations_per_chain=n_it,
                                fitsurvey_samples=1000, sd_fitdistance=6.0,
                                print_report=False, until_min_ess=target,
                                max_extensions=3)
    extension_checks("until_min_ess", post, target, min_ess, n_it,
                     cuda_mh.LAUNCHES["metropolis_hastings_fused"] - 1,
                     caught)
    return times


def extension_checks(label, post, target, min_ess, nits, n_ext, caught):
    """An ``until_min_ess`` run's posterior (``n_ext`` extensions, the
    warnings ``caught``): at least one extension, the iteration column
    rising without a reset to its last extension's end, acceptance_ratio
    x iteration integral, and the target met or the cap's warning
    given."""
    import numpy as np
    capped = any("extension cap" in str(w.message) for w in caught)
    got = min_ess(post)
    its = post[post["chain#"] == 0]["iteration"].to_numpy()
    counts = (post["acceptance_ratio"].to_numpy(float)
              * post["iteration"].to_numpy(float))
    print(f"{label} {target:.1f} (1.5 x the single run's "
          f"{target / 1.5:.1f}): {n_ext} extension(s), min ESS {got:.1f}, "
          f"{len(its)} records a chain, iterations {its[0]}..{its[-1]}, "
          f"cap warning {capped}", flush=True)
    if n_ext < 1:
        fail(f"{label}: no extension ran")
    if not (np.diff(its) > 0).all() or its[-1] != nits - 1 + n_ext * (
            nits - 1):
        fail(f"{label}: the iteration column resets or stops short")
    # float32 ratios: counts to a few float32 ulps of their size
    if (np.abs(counts - np.round(counts))
            > 1e-6 * np.maximum(counts, 1.0)).any():
        fail(f"{label}: acceptance_ratio x iteration is not integral")
    if not (got >= target or capped):
        fail(f"{label}: the target was missed without a warning")


def joint_chunk_phases(joint_fit, jpost_plain, calls, nits):
    """The joint kernel's chunk mode beyond chunks (a)-(b): its CHUNK
    instantiation against the twin's chunk mode at the joint paths'
    captured calls (``calls``: (label, call), all chains, 50 proposals in
    chunks of 20), then ``JointFit.MCMC`` at the joint path's shape with
    a checkpoint file, killed after its first chunk and resumed, and with
    ``until_min_ess``. Returns (chi's max abs error, the checkpointed
    run's launches, {label: seconds})."""
    import tempfile
    import warnings

    import numpy as np
    import pandas as pd
    import torch
    from odelib_tpu_torch.ops import cuda_joint, cuda_mh, plain_launchers
    from odelib_tpu_torch.utils.diagnostics import effective_sample_size

    name = "joint_metropolis_hastings_fused"
    phase("chunks (e): the joint kernel's chunk mode against the twin's at "
          "the joint paths' inputs (all chains, 50 proposals in chunks of "
          "20)")
    err = 0.0
    for label, call in calls:
        kw = {**call["kw"], "nits": 51, "burnin": 0, "checkpoint_every": 20}
        n0 = cuda_mh.LAUNCHES[name]
        out_k = cuda_joint.joint_metropolis_hastings_fused(*call["args"],
                                                           **kw)
        torch.cuda.synchronize()
        n1 = cuda_mh.LAUNCHES[name]
        with plain_launchers():
            out_t = cuda_joint.joint_metropolis_hastings_fused(
                *call["args"], **kw)
        torch.cuda.synchronize()
        if (n1 - n0, cuda_mh.LAUNCHES[name] - n1) != (3, 0):
            fail(f"{label}: the chunked kernel run made {n1 - n0} launches "
                 "(not 3) or the twin run launched")
        err = max(err, compare_records(
            f"{label} in chunks, kernel vs twin",
            *([o.theta.permute(1, 2, 0), o.chi.t(),
               o.chi_parts.permute(1, 2, 0), o.acceptance_ratio.t()]
              for o in (out_k, out_t)), 51,
            labels=("theta", "chi", "chi parts", "ar")))
        print(f"{label}: all {call['args'][5].shape[0]} chains x 50 "
              "proposals in 3 chunk launches, records bitwise the twin's "
              "chunk mode", flush=True)

    phase("chunks (f): JointFit.MCMC checkpointed every 250 iterations at "
          "the joint path's shape, killed after its first chunk and "
          "resumed")
    kw = dict(chain_inits=CHAINS, iterations_per_chain=nits,
              fitsurvey_samples=1000, substeps=4, backend="pallas",
              print_report=False)
    secs = {}
    real = cuda_joint.joint_metropolis_hastings_fused

    class Killed(Exception):
        pass

    def killed(*a, **k):
        if real(*a, _stop_after_chunks=1, **k) is None:
            raise Killed
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "joint.npz")
        cuda_mh.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        post = joint_fit().MCMC(checkpoint_every=250, checkpoint_path=ckpt,
                                **kw)
        torch.cuda.synchronize()
        secs["checkpointed"] = time.perf_counter() - t0
        launches = cuda_mh.LAUNCHES[name]
        n_chunks = -(-(nits - 1) // 250)
        if launches != n_chunks:
            fail(f"JointFit checkpointed: {launches} joint launches, not "
                 f"{n_chunks}")
        size = os.path.getsize(ckpt + ".progress")
        pd.testing.assert_frame_equal(post, jpost_plain)
        cuda_joint.joint_metropolis_hastings_fused = killed
        try:
            joint_fit().MCMC(checkpoint_every=250, checkpoint_path=ckpt,
                             **kw)
            fail("JointFit: the killed run finished")
        except Killed:
            pass
        finally:
            cuda_joint.joint_metropolis_hastings_fused = real
        with np.load(ckpt + ".progress") as z:
            if int(z["next_chunk"]) != 1:
                fail("JointFit: the killed run's file is at chunk "
                     f"{int(z['next_chunk'])}")
        t0 = time.perf_counter()
        res = joint_fit().MCMC(checkpoint_every=250, checkpoint_path=ckpt,
                               resume_from=ckpt + ".progress", **kw)
        torch.cuda.synchronize()
        secs["resumed"] = time.perf_counter() - t0
        pd.testing.assert_frame_equal(res, jpost_plain)
    print(f"JointFit.MCMC checkpointed every 250: {launches} chunk "
          f"launches, posterior equal to the joint path's, wall "
          f"{secs['checkpointed']:.3f} s, progress file "
          f"{size / 2 ** 20:.1f} MiB; killed after chunk 1 and resumed "
          f"({secs['resumed']:.3f} s): the joint path's posterior",
          flush=True)

    phase("chunks (g): JointFit.MCMC(until_min_ess=...) at the joint "
          "path's shape")

    def min_ess(p):
        return min(effective_sample_size(np.log(np.stack(
            [g[c].to_numpy(float) for _, g in p.groupby("chain#")])))
            for c in ("phi", "beta", "a:mu", "b:mu"))
    target = 1.5 * min_ess(jpost_plain)
    cuda_mh.reset_launch_counts()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        post = joint_fit().MCMC(until_min_ess=target, max_extensions=1,
                                **kw)
    secs["until"] = time.perf_counter() - t0
    extension_checks("JointFit until_min_ess", post, target, min_ess, nits,
                     cuda_mh.LAUNCHES[name] - 1, caught)
    # an extension restarts a chain at its recorded theta, whose chi can be
    # NaN where the solve fails (the reference restarts the same way)
    chi = post["chi"].to_numpy()
    print(f"JointFit until_min_ess wall {secs['until']:.3f} s; chains with "
          f"a non-finite chi: {post['chain#'][~np.isfinite(chi)].nunique()}",
          flush=True)
    if not np.array_equal(chi, post["chi:a"].to_numpy()
                          + post["chi:b"].to_numpy(), equal_nan=True):
        fail("JointFit until_min_ess: chi is not chi:a + chi:b")
    return err, launches, secs


def milstein_phases(pmmh_framework):
    """PMMH's Milstein step on config 14 (``sde_method='milstein'``): the
    path through ``MCMC`` with the Euler path's bands, its kernel against
    its twin at every chain, 4 chunks of 64 against the whole run, and
    the Milstein kernel's time beside Euler's on the same chains. Returns
    (chi's max abs error, the path's launches, the captured call, the
    path's (wall, launches, stages), the kernel's ms: Euler, Milstein,
    Euler)."""
    import numpy as np
    import torch
    from odelib_tpu_torch.ops import cuda_mh, cuda_pf

    phase("PMMH Milstein: ModelFramework(GBM, diffusion=...).MCMC("
          "sampler='pmmh', sde_method='milstein')")
    call = {}
    real = cuda_pf.pmmh_fused
    out = io.StringIO()
    pfw = pmmh_framework()
    cuda_mh.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), \
            recording(cuda_pf, "pmmh_fused", call):
        post = pfw.MCMC(sampler="pmmh", chain_inits=PF_CHAINS,
                        iterations_per_chain=PF_NITS, fitsurvey_samples=1000,
                        n_particles=PF_K, sde_substeps=PF_SUB, rwalk_std=0.4,
                        use_priors=True, adapt_proposal=True,
                        target_accept=0.3, adapt_rate=0.15, profile=True,
                        sde_method="milstein")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(cuda_mh.LAUNCHES)
    print(f"MCMC(pmmh, milstein) wall seconds: {wall_s:.3f}; launches "
          f"{launches}; stages " + ", ".join(
              f"{k} {v:.3f} s" for k, v in pfw.last_profile.items()))
    if call["kw"].get("sde_method") != "milstein" \
            or launches["pmmh_fused"] != 1:
        fail(f"pmmh (milstein): the wrapper ran {call['kw'].get('sde_method')}"
             f" with {launches['pmmh_fused']} launches")
    pf_R = PF_NITS - 1 - PF_NITS // 2
    if len(post) != PF_CHAINS * pf_R or not post["rsquared"].isna().all():
        fail(f"pmmh (milstein): posterior of {len(post)} rows")
    finite = float(np.isfinite(post.chi.to_numpy()).mean())
    ar = post.acceptance_ratio.to_numpy().reshape(PF_CHAINS, pf_R)
    its = np.arange(1, PF_NITS)[PF_NITS // 2:].astype(float)
    frozen = float(np.mean((ar[:, -1] * its[-1] - ar[:, 0] * its[0])
                           / (its[-1] - its[0])))
    z = np.log(post.mu.to_numpy(np.float64))
    exact_mean, exact_std = kalman_posterior(*gbm_data())
    print(f"pmmh (milstein): finite chi fraction {finite}, frozen-phase "
          f"acceptance {frozen:.4f}; log mu posterior mean {z.mean():.4f} "
          f"(exact {exact_mean:.4f}), std {z.std():.4f} (exact "
          f"{exact_std:.4f})", flush=True)
    if finite != 1.0:
        fail(f"pmmh (milstein): finite chi fraction {finite}")
    if not 0.15 <= frozen <= 0.5:
        fail(f"pmmh (milstein): frozen-phase acceptance {frozen} outside "
             "[0.15, 0.5]")
    if not abs(z.mean() - exact_mean) < 0.02 \
            or not abs(z.std() - exact_std) <= 0.05 * exact_std:
        fail("pmmh (milstein): the log mu posterior misses the exact one")

    phase("PMMH Milstein: the kernel vs its twin at the path's inputs (all "
          "chains, 3 proposals, 1 adapting), and 4 chunks of 64 against "
          "the whole run")
    err, _ = pmmh_vs_twin("PMMH Milstein (path's inputs)", call, 4, 1)
    kw = call["kw"]
    n0 = cuda_mh.LAUNCHES["pmmh_fused"]
    whole = real(*call["args"], **kw)
    chunk = real(*call["args"], **{**kw, "checkpoint_every": 64})
    torch.cuda.synchronize()
    n_chunks = -(-(PF_NITS - 1) // 64)
    if cuda_mh.LAUNCHES["pmmh_fused"] - n0 != 1 + n_chunks:
        fail("PMMH Milstein chunked: wrong launch count")
    same_bits("PMMH Milstein chunked (every 64)", chunk, whole)
    print(f"PMMH Milstein: {PF_CHAINS} chains x {PF_NITS} in {n_chunks} "
          "chunks of 64: bitwise the whole run", flush=True)

    phase("PMMH Milstein: the kernel's time beside Euler's on the same "
          "chains")
    spec, obs, tf, y0, th0 = call["args"]
    plan = cuda_mh._build_plan(spec, obs, tf, cuda_mh._normalize_substeps(
        kw["substeps"], len(tf) - 1))
    th = th0.t().contiguous()
    run = {**pmmh_twin_kw(kw), "nits": PF_NITS, "burnin": PF_NITS // 2}
    times = [events_ms(cuda_pf.pmmh_launcher(
        spec, plan, y0, th, kw["seed"], **{**run, "milstein": m}))
        for m in (False, True, False)]
    print(f"pf_kernel {PF_CHAINS} chains x {PF_K} particles x {PF_NITS} "
          f"on the Milstein path's chains: Euler {times[0]:.3f} ms, "
          f"Milstein {times[1]:.3f} ms, Euler again {times[2]:.3f} ms "
          f"(Milstein / Euler {2 * times[1] / (times[0] + times[2]):.4f})",
          flush=True)
    return err, launches["pmmh_fused"], call, (
        wall_s, launches, dict(pfw.last_profile)), times


# -- the scorer's branches: every observation model, censoring and doses ----

# the particle filter's branches, on the PMMH path's GBM (counts are 50 N);
# the first is path (e)'s, whose library it shares
PF_SCORING = (("student_t", (), True), ("lognormal", ("left",), False),
              ("poisson", (), False), ("negbinom", (), True))


def scoring_inputs(case):
    """zero_i on the demo data as ``case`` scores it (counts and the dose
    divided by the Poisson scale): (spec, host obs on the compact grid,
    the grid, y0, the fit's centre)."""
    import numpy as np
    from scoring_cases import COUNT_SCALE, zero_i_case
    scale = COUNT_SCALE.get(case[0], 1.0)
    return (*zero_i_case(*case, scale=scale),
            np.array([0.6, 2.4e-8 * scale, 24.0]))


def pf_variant(case, spec, obs, y0):
    """The PMMH path's GBM (its spec, host obs and y0) as ``case`` scores
    it: counts of 50 N for the count models, the second and sixth
    observations left-censored, a dose after the block at t = 2."""
    import dataclasses
    import numpy as np
    from scoring_cases import FAMILIES
    fam, censor, dosed = case
    if fam in ("poisson", "negbinom"):
        ab = np.round(50.0 * np.asarray(obs.abundance))
        obs, y0 = obs._replace(log_abundance=np.log(ab), abundance=ab), \
            50.0 * np.asarray(y0)
    if censor:
        cen = np.zeros(len(obs.abundance), np.int32)
        cen[[1, 5]] = 1
        obs = obs._replace(censor=cen)
    spec = dataclasses.replace(
        spec, obs_model=fam,
        obs_param=float(FAMILIES[fam] or 0.0),
        dose_events=((2.0, 0, 75.0 if fam in ("poisson", "negbinom")
                      else 1.5),) if dosed else None)
    return spec, obs, np.asarray(y0, float)


def scoring_builds(pf_fw):
    """load_kernels arguments of the libraries of each zero_i branch and
    of the particle filter's branches on the PMMH path's framework."""
    from odelib_tpu_torch.ops import cuda_mh
    from scoring_cases import SCORING
    out = []
    for case in SCORING:
        spec, obs, tf, _, _ = scoring_inputs(case)
        out.append((spec, (), False,
                    [cuda_mh.scoring(cuda_mh._build_plan(spec, obs, tf, 1))]))
    for case in PF_SCORING:
        spec, obs, _ = pf_variant(case, pf_fw._spec, pf_fw._obsdata_fit_host,
                                  pf_fw.get_inits())
        out.append((spec, (), True, [cuda_mh.scoring(
            cuda_mh._build_plan(spec, obs, pf_fw._times_fit, 1))]))
    return out


def _gbm(y, t, ps):
    import numpy as np
    return np.array([ps[0] * y[0]])


def _gnoise(y, t, ps):
    import numpy as np
    return np.array([SIG * y[0]])


def held(name, tobit, rec_k, rec_t, nits, labels, burnin=0):
    """Kernel against twin records (chain-minor, from iteration burnin +
    1): the accept sequences equal; bitwise (compare_records), but with
    ``tobit`` (censored data: double erfc/erfcx/log1p of two libraries,
    rounded to float32 once) within rtol 1e-6. Returns chi's max abs
    error."""
    import numpy as np
    if not tobit:
        return compare_records(name, rec_k, rec_t, nits, labels=labels,
                               burnin=burnin)
    rec_k = [r.cpu().numpy() for r in rec_k]
    rec_t = [r.cpu().numpy() for r in rec_t]
    ar = labels.index("ar")
    if not (rec_k[ar] == rec_t[ar]).all():
        fail(f"{name}: accept sequences differ")
    err = 0.0
    for label, a, b in zip(labels, rec_k, rec_t):
        if not (np.isfinite(a) == np.isfinite(b)).all():
            fail(f"{name}: {label} kernel and twin disagree on finiteness")
        m = np.isfinite(b)
        rel = float(np.max(np.abs(a[m] - b[m]) / np.maximum(np.abs(b[m]),
                                                            1e-30)))
        print(f"{name} {label}: max rel err {rel:.3g}, bitwise equal "
              f"{np.mean(a[m] == b[m]):.4f}")
        if rel > 1e-6:
            fail(f"{name}: {label} max rel err {rel:.3g} above 1e-6")
        if label == "chi":
            err = float(np.max(np.abs(a[m] - b[m])))
    return err


def drive(label, model, kernel, pnames, n_chains, survey=True,
          report=True, **kw):
    """One path's ``MCMC`` call at full width (``NITS`` iterations unless
    ``nits`` is given), with launch counts reset just before and read just
    after: the reference's posterior columns, every chain, finite chi 1.0,
    mean final acceptance in (0, 1), ``kernel`` (and, with ``survey``, the
    survey kernel) launched once, and with ``report`` the Fitting Report
    printed. Returns the posterior and the launch counts."""
    import numpy as np
    import torch
    from odelib_tpu_torch import JointFit
    from odelib_tpu_torch.ops import cuda_mh
    cols = ["chi", "rsquared", "aic", "iteration", "acceptance_ratio",
            "chain#", "all_rejected"]
    cuda_mh.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        post = model.MCMC(iterations_per_chain=kw.pop("nits", NITS),
                          profile=True, print_report=report, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_mh.LAUNCHES)
    want = list(pnames) + cols
    if isinstance(model, JointFit):
        want = list(model.columns) + ["chi"] + [
            f"chi:{k}" for k in model.frameworks] + cols[3:]
    if list(post.columns) != want:
        fail(f"{label}: posterior columns {list(post.columns)}")
    if post["chain#"].nunique() != n_chains:
        fail(f"{label}: {post['chain#'].nunique()} chains")
    finite = float(np.isfinite(post.chi.to_numpy()).mean())
    last = post[post.iteration == post.iteration.max()]
    acc = float(last.acceptance_ratio.mean())
    print(f"{label}: wall {wall:.3f} s; stages " + ", ".join(
        f"{k} {v:.3f} s" for k, v in model.last_profile.items())
        + f"; launches {launches}; finite chi {finite}, mean final "
        f"acceptance {acc:.4f}; {len(post)} rows", flush=True)
    if finite != 1.0 or not 0.0 < acc < 1.0:
        fail(f"{label}: finite chi {finite}, acceptance {acc}")
    if launches[kernel] != 1 or (survey and
                                 launches["survey_fused"] != 1):
        fail(f"{label}: launches {launches}")
    if report and "Fitting Report" not in out.getvalue() and not isinstance(
            model, JointFit):
        fail(f"{label}: the Fitting Report did not print")
    return post, launches


def slice_paths(framework, device="cuda"):
    """The frameworks of paths (a)-(e) (the module docstring) on
    ``device``; ``framework(df, **kw)`` builds zero_i there with the demo
    paths' priors. (d) is the pair of its two frameworks."""
    import numpy as np
    import pandas as pd
    import scipy.stats
    from odelib_tpu_torch import ModelFramework, parameter
    from odelib_tpu_torch.models import one_i, pk_oral, zero_i
    from scoring_cases import COUNT_SCALE, PK_DOSES, demo_frame, pk_frame
    scale = COUNT_SCALE["poisson"]
    t_obs, log_o = gbm_data()
    hdf = demo_frame("lognormal", ("left",), host="H")
    h0 = float(hdf[(hdf["organism"] == "H") & (hdf["time"] == 0)]
               ["abundance"].iloc[0])
    return {
        "a": pk_oral.framework(pk_frame(), dose_events=list(PK_DOSES),
                               t_steps=145, device=device),
        "b": framework(demo_frame("student_t", ("left",)),
                       obs_model="student_t", obs_param=4.0),
        "c": framework(demo_frame("negbinom"), obs_model="negbinom",
                       obs_param=10.0),
        "d": (zero_i.framework(
            demo_frame("poisson", scale=scale),
            obs_model="poisson", t_steps=288, device=device,
            phi=parameter(scipy.stats.lognorm,
                          {"s": 3, "scale": 1e-8 * scale},
                          random_seed=2)),
            one_i.framework(hdf, t_steps=288, device=device, S=h0)),
        "e": ModelFramework(
            ODE=_gbm, diffusion=_gnoise, parameter_names=["mu"],
            state_names=["N"], dataframe=pd.DataFrame({
                "organism": "N", "time": t_obs,
                "abundance": np.exp(log_o), "log_sigma": S_OBS}),
            t_steps=41, N=2.0,
            mu=parameter(scipy.stats.lognorm, {"s": PRI_SD,
                                               "scale": PRI_MU}),
            obs_model="student_t", obs_param=4.0,
            dose_events=[(2.0, "N", 1.5)], device=device)}


def fw_scoring(fw):
    """The scoring (``cuda_mh.scoring``) of a framework's plan."""
    from odelib_tpu_torch.ops import cuda_mh
    return cuda_mh.scoring(cuda_mh._build_plan(
        fw._spec, fw._obsdata_fit_host, fw._times_fit, 1))


def path_builds(paths):
    """load_kernels arguments of the libraries paths (a)-(e) load."""
    sc = fw_scoring
    pois, cens = paths["d"]
    return [(paths[k]._spec, (), False, [sc(paths[k])]) for k in "abc"] + [
        (pois._spec, (cens._spec,), False, [sc(pois), sc(cens)]),
        (paths["e"]._spec, (), True, [sc(paths["e"])])]


def scoring_phases(paths, calls, pf_call):
    """The phases of every observation model, censoring and doses (see
    the module docstring): ``paths`` from :func:`slice_paths`, ``calls``
    the demo MH, PT and ensemble paths' captured wrapper calls,
    ``pf_call`` the PMMH path's. Returns each kernel's max abs error of
    chi against its twin."""
    import numpy as np
    import scipy.special
    import scipy.stats
    import torch
    from odelib_tpu_torch import JointFit
    from odelib_tpu_torch.models import pk_oral, zero_i
    from odelib_tpu_torch.ops import (build, cuda_joint, cuda_mh, cuda_pf,
                                      cuda_pt, plain_launchers)
    from scoring_cases import SCORING, scoring_id
    dev = torch.device("cuda")
    errs = dict.fromkeys(cuda_mh.LAUNCHES, 0.0)

    phase("scoring (1): the Tobit device functions against float64")
    spec, obs, tf, _, _ = scoring_inputs(SCORING[0])
    lib = build.load_kernels(spec, scoring=[cuda_mh.scoring(
        cuda_mh._build_plan(spec, obs, tf, 1))])

    def probe(z, which, tc):
        zt = torch.as_tensor(z, device=dev)
        out = torch.empty_like(zt)
        build.check(lib, lib.odelib_tobit(
            zt.data_ptr(), zt.numel(), which, tc["nu"], tc["a"],
            tc["thresh"], tc["ka"], tc["kb"], out.data_ptr(),
            build.stream(dev)), "tobit")
        return out.cpu().numpy().astype(np.float64)
    z = np.linspace(-37.0, 8.0, 45001).astype(np.float32)
    want = scipy.special.log_ndtr(z.astype(np.float64))
    rel = np.abs(probe(z, 0, cuda_mh.t_constants(1.0)) - want) / np.abs(want)
    print(f"log Phi on z in [-37, 8] (45,001 points): max rel err "
          f"{rel.max():.3g} at z = {z[rel.argmax()]:.4f} (bound 2e-6)")
    if not rel.max() <= 2e-6:
        fail(f"log Phi max rel err {rel.max():.3g} above 2e-6")
    z = np.linspace(-50.0, 50.0, 40001).astype(np.float32)
    for nu in (1.0, 2.0, 4.0, 10.0, 30.0, 100.0):
        want = scipy.stats.t.logcdf(z.astype(np.float64), nu)
        got = probe(z, 1, cuda_mh.t_constants(nu))
        normal = np.abs(want) >= np.finfo(np.float32).tiny
        rel = np.abs(got - want)[normal] / np.abs(want[normal])
        tail = np.abs(got - want)[~normal]
        print(f"t log-CDF, nu = {nu:g}: max rel err {rel.max():.3g} "
              f"(bound 1e-5) over {normal.sum()} points; below float32's "
              f"normals ({(~normal).sum()} points) max abs err "
              f"{tail.max() if tail.size else 0.0:.3g}")
        if not rel.max() <= 1e-5 or (tail.size and tail.max()
                                     >= np.finfo(np.float32).tiny):
            fail(f"t log-CDF nu = {nu}: max rel err {rel.max():.3g}")

    phase("scoring (2): each kernel vs its twin on each scoring branch")
    rng = np.random.default_rng(0)
    for case in SCORING:
        label = scoring_id(case)
        spec, obs, tf, y0, centre = scoring_inputs(case)

        def draws(n, sd):
            return torch.as_tensor((centre * np.exp(rng.normal(
                0, sd, (n, 3)))).astype(np.float32), device=dev)
        th = draws(1000, 0.2)
        chi_k = cuda_mh.survey_fused(spec, obs, tf, y0, th, substeps=1)
        chi_t = cuda_mh.survey_plain(spec, cuda_mh._build_plan(
            spec, obs, tf, 1), y0, th.t().contiguous())
        torch.cuda.synchronize()
        errs["survey_fused"] = max(errs["survey_fused"],
                                   _survey_held(label, case, chi_k, chi_t))
        # (run, chains, iterations) of each chain kernel's wrapper
        runs = {
            "metropolis_hastings_fused": (lambda th0, n: (
                cuda_mh.metropolis_hastings_fused(
                    spec, obs, tf, y0, th0, 11, nits=n, burnin=0,
                    substeps=1),), 512, 6),
            "ensemble_fused": (lambda th0, n: (cuda_mh.ensemble_fused(
                spec, obs, tf, y0, th0, 11, nits=n, burnin=0, substeps=1,
                tile_chains=256),), 512, 6),
            "parallel_tempering_fused": (lambda th0, n: cuda_pt.
                                         parallel_tempering_fused(
                spec, obs, tf, y0, th0, 11, nits=n, burnin=0, substeps=1,
                temperatures=(1.0, 2.0, 4.0)), 256, 6),
            # two experiments of the branch sharing phi and beta (one
            # model, so the branch's own library): D = 4
            "joint_metropolis_hastings_fused": (lambda th0, n: (
                cuda_joint.joint_metropolis_hastings_fused(
                    (spec, spec), ((0, 1, 2), (3, 1, 2)), (obs, obs),
                    (tf, tf), (y0, y0), torch.cat([th0, th0[:, :1]], 1),
                    11, nits=n, burnin=0, substeps_list=[1, 1]),), 128, 6)}
        for name, (run, n, nits) in runs.items():
            th0 = draws(n, 0.03)
            n0 = dict(cuda_mh.LAUNCHES)
            out_k = run(th0, nits)
            torch.cuda.synchronize()
            if cuda_mh.LAUNCHES[name] != n0[name] + 1:
                fail(f"{label} {name}: the kernel was not launched once")
            with plain_launchers():
                out_t = run(th0, nits)
            torch.cuda.synchronize()
            if sum(cuda_mh.LAUNCHES.values()) != sum(n0.values()) + 1:
                fail(f"{label} {name}: the twin run launched a kernel")
            (ok_, ot_) = out_k[0], out_t[0]
            if len(out_k) > 1 and not torch.equal(out_k[1], out_t[1]):
                fail(f"{label} {name}: swap counts differ")
            acc = float(ok_.acceptance_ratio[:, -1].mean())
            if not np.isfinite(ok_.chi.cpu().numpy()).all() or acc <= 0.0:
                fail(f"{label} {name}: non-finite chi or no accept ({acc})")
            errs[name] = max(errs[name], held(
                f"{label} {name}", bool(case[1]),
                [ok_.theta.movedim(0, -1), ok_.chi.t(),
                 ok_.acceptance_ratio.t()],
                [ot_.theta.movedim(0, -1), ot_.chi.t(),
                 ot_.acceptance_ratio.t()], nits, ("theta", "chi", "ar")))
    pspec, pobs, ptf, py0, pth0 = pf_call["args"]
    pkw = pf_call["kw"]
    for case in PF_SCORING:
        label = scoring_id(case)
        spec, obs, y0 = pf_variant(case, pspec, pobs, py0)
        th0 = pth0[:512].contiguous()
        kw = dict(nits=6, burnin=2, rwalk_std=0.4, n_particles=PF_K,
                  substeps=pkw["substeps"])
        n0 = cuda_mh.LAUNCHES["pmmh_fused"]
        out = cuda_pf.pmmh_fused(spec, obs, ptf, y0, th0, 3, **kw)
        torch.cuda.synchronize()
        if cuda_mh.LAUNCHES["pmmh_fused"] != n0 + 1:
            fail(f"{label} pmmh_fused: the kernel was not launched once")
        plan = cuda_mh._build_plan(spec, obs, ptf, pkw["substeps"])
        rec_t = cuda_pf.pmmh_plain(spec, plan, y0, th0.t().contiguous(), 3,
                                   K=PF_K, nits=6, burnin=2, walk=(1.0,),
                                   walked=(True,), rwalk_std=0.4)
        torch.cuda.synchronize()
        if not np.isfinite(out.chi.cpu().numpy()).all():
            fail(f"{label} pmmh_fused: non-finite chi")
        errs["pmmh_fused"] = max(errs["pmmh_fused"], held(
            f"{label} pmmh_fused (GBM, {th0.shape[0]} chains x {PF_K})",
            bool(case[1]), [out.theta.permute(1, 2, 0), out.chi.t(),
                   out.acceptance_ratio.t()], rec_t, 6,
            ("theta", "chi", "ar"), burnin=2))

    phase("scoring (3): the slice's paths at full width")
    captured = {}
    with recording(cuda_mh, "metropolis_hastings_fused",
                   captured.setdefault("a", {})):
        drive("(a) MCMC(sampler='mh', use_priors=True) on pk_oral, six "
              "doses, Tobit lognormal", paths["a"],
              "metropolis_hastings_fused", pk_oral.pnames, CHAINS,
              chain_inits=CHAINS, fitsurvey_samples=1000,
              sd_fitdistance=6.0, use_priors=True)
    with recording(cuda_pt, "parallel_tempering_fused",
                   captured.setdefault("b", {})):
        drive("(b) MCMC(sampler='pt') on zero_i, student_t nu = 4, four "
              "host points left-censored at 1.5e6", paths["b"],
              "parallel_tempering_fused", zero_i.pnames, CHAINS,
              chain_inits=CHAINS, fitsurvey_samples=1000,
              sd_fitdistance=6.0, sampler="pt", temperatures=TEMPS)
    with recording(cuda_mh, "ensemble_fused", captured.setdefault("c", {})):
        drive("(c) MCMC(sampler='ensemble') on zero_i, the demo as "
              "counts, negbinom r = 10", paths["c"], "ensemble_fused",
              zero_i.pnames, 12288, chain_inits=12288,
              fitsurvey_samples=1000, sd_fitdistance=6.0,
              sampler="ensemble")
    with recording(cuda_joint, "joint_metropolis_hastings_fused",
                   captured.setdefault("d", {})):
        drive("(d) JointFit({'a': zero_i poisson (counts / 1e5), 'b': "
              "one_i lognormal, host left-censored}, shared=['mu', "
              "'beta']).MCMC()",
              JointFit(dict(zip("ab", paths["d"])), shared=["mu", "beta"],
                       random_seed=0), "joint_metropolis_hastings_fused",
              (), CHAINS, survey=False, chain_inits=CHAINS,
              fitsurvey_samples=1000)
    with recording(cuda_pf, "pmmh_fused", captured.setdefault("e", {})):
        drive("(e) MCMC(sampler='pmmh') on the GBM SDE, student_t nu = 4, "
              "a dose of 1.5 at t = 2", paths["e"], "pmmh_fused", ["mu"],
              PF_CHAINS, survey=False, nits=PF_NITS, sampler="pmmh",
              chain_inits=PF_CHAINS, fitsurvey_samples=1000,
              n_particles=PF_K, sde_substeps=PF_SUB, rwalk_std=0.4,
              use_priors=True, adapt_proposal=True, target_accept=0.3,
              adapt_rate=0.15)

    phase("scoring (4): paths (a)-(e)'s kernels vs their twins at the "
          "paths' own inputs (all chains)")
    for key, wrapper, tobit, its in (
            ("a", cuda_mh.metropolis_hastings_fused, True, 11),
            ("b", cuda_pt.parallel_tempering_fused, True, 11),
            ("c", cuda_mh.ensemble_fused, False, 11),
            ("d", cuda_joint.joint_metropolis_hastings_fused, True, 11)):
        call = captured[key]
        err, out = kernel_vs_twin_at(f"path ({key}) {wrapper.__name__}",
                                     wrapper, call, its, tobit=tobit)
        errs[wrapper.__name__] = max(errs[wrapper.__name__], err)
        print(f"path ({key}) {wrapper.__name__} at its own inputs: "
              f"{out.chi.shape[0]} chains x {its - 1} iterations, seed "
              f"{call['kw']['seed']}, mean acceptance "
              f"{float(out.acceptance_ratio[:, -1].mean()):.4f}", flush=True)
    err, out = pmmh_vs_twin("path (e) pmmh_fused", captured["e"], 21, 10)
    errs["pmmh_fused"] = max(errs["pmmh_fused"], err)
    print(f"path (e) pmmh_fused at its own inputs: {out.chi.shape[0]} "
          f"chains x {captured['e']['kw']['n_particles']} particles x 20 "
          f"proposals (10 adapting), mean acceptance "
          f"{float(out.acceptance_ratio[:, -1].mean()):.4f}", flush=True)

    phase("scoring (5): each kernel's time on each scoring branch at the "
          "main paths' shapes, and paths (a)-(c)'s wrapper calls against "
          "the demo's")
    for key, wrapper, demo in (
            ("a", cuda_mh.metropolis_hastings_fused, calls["mh"]),
            ("b", cuda_pt.parallel_tempering_fused, calls["pt"]),
            ("c", cuda_mh.ensemble_fused, calls["ensemble"])):
        ms = [events_ms(lambda c=c: wrapper(*c["args"], **c["kw"]))
              for c in (captured[key], demo)]
        print(f"path ({key}) {wrapper.__name__}: {ms[0]:.3f} ms a call "
              f"against the demo path's {ms[1]:.3f} ms (CUDA events around "
              "the wrapper call, host part included)", flush=True)
    seeds = np.random.default_rng(5).normal(0, 0.05, (CHAINS, 3))
    walk, walked = (0.05,) * 3, (True,) * 3
    sc, bt, db = cuda_pt.ladder_constants(TEMPS, 0.05, [1.0] * 3)
    base = {}
    print("branch | survey (1,000) | MH | ensemble (12,288) | PT (4 rungs) "
          "| joint (two experiments of the branch, D = 4) ms")
    for case in (("lognormal", (), False),) + SCORING:
        spec, obs, tf, y0, centre = scoring_inputs(case)
        plan = cuda_mh._build_plan(spec, obs, tf, 4)
        th = (centre * np.exp(seeds)).astype(np.float32)
        th_t = torch.as_tensor(th.T.copy(), device=dev)
        th_j = torch.cat([th_t, th_t[:1]]).contiguous()
        th_e = torch.as_tensor(cuda_mh.ensemble_init(
            th, 5, 4096, (1.0,) * 3, 0.01).T.copy(), device=dev)
        ms = (
            events_ms(cuda_mh.survey_launcher(spec, plan, y0, "dopri5",
                                              th_t[:, :1000].contiguous()),
                      reps=20),
            events_ms(cuda_mh.mh_launcher(
                spec, plan, y0, "dopri5", th_t, 5, nits=NITS, burnin=BURNIN,
                walk=walk, walked=walked, num=3)),
            events_ms(cuda_mh.ensemble_launcher(
                spec, plan, y0, "dopri5", th_e, 5, tile=4096, nits=NITS,
                burnin=BURNIN, a=2.0, walk=(1.0,) * 3, walked=walked, num=3,
                W0=CHAINS)),
            events_ms(cuda_pt.pt_launcher(
                spec, plan, y0, "dopri5", th_t, 5, nits=NITS, burnin=BURNIN,
                scales=sc, walked=walked, betas=bt, dbetas=db, swap_every=1,
                num=3)),
            events_ms(cuda_joint.joint_launcher(
                (spec, spec), (plan, plan), (y0, y0),
                ((0, 1, 2), (3, 1, 2)), "dopri5", th_j, 5, nits=NITS,
                burnin=BURNIN, walk=walk + walk[:1],
                walked=walked + walked[:1])))
        base.setdefault("demo", ms)
        rel = " ".join(f"({100 * (m / b - 1):+.1f} %)"
                       for m, b in zip(ms, base["demo"]))
        print(f"{scoring_id(case)} | " + " | ".join(
            f"{m:.4f}" for m in ms) + f" | vs demo {rel}", flush=True)
    pf_plan0 = cuda_mh._build_plan(pspec, pobs, ptf, pkw["substeps"])
    pf_run = pmmh_twin_kw(pkw)
    pth_all = pth0.t().contiguous()
    for case in (("lognormal", (), False),) + PF_SCORING:
        spec, obs, y0 = pf_variant(case, pspec, pobs, py0)
        plan = pf_plan0 if case[0] == "lognormal" and not case[1] else \
            cuda_mh._build_plan(spec, obs, ptf, pkw["substeps"])
        ms = events_ms(cuda_pf.pmmh_launcher(
            spec, plan, y0, pth_all, pkw["seed"], nits=PF_NITS,
            burnin=PF_NITS // 2, **pf_run))
        print(f"pf_kernel {scoring_id(case)}: {ms:.3f} ms "
              f"({PF_CHAINS} x {PF_K} particles x {PF_NITS})", flush=True)
    return errs


# -- the stiff path: the kernels' kvaerno3 instantiations -------------------

def robertson_framework(device="cuda"):
    """The Robertson fit: ``models.get('robertson').framework`` on
    ``scoring_cases.robertson_frame`` (y1 at bench/suite.py config 5's
    grid, numpy seed 5), its grid spaced 1e-3 (``ROBERTSON_T_STEPS``; on
    the default grid, spaced ~1, no draw's chi is finite, in odelib_tpu's
    kernels as in the port's: tools/robertson_default_grid.py) and the
    solver's atol 1e-12: y2 stays below 4e-5, so the default 1e-4 leaves
    it unresolved, and schedules calibrated at looser tolerances left some
    prescreened draws' chi non-finite. Each observation time moves to the
    nearest grid point, by at most 4.9e-4: the seven below 5e-4 to t = 0,
    7.4e-4 and 1.4e-3 both to 1e-3, 2.5e-3 to 3e-3 (19 % relative), 4.6e-3
    and 8.6e-3 by 8 and 5 %, the times from 0.016 on by under 1 %."""
    from odelib_tpu_torch.models import get
    from scoring_cases import ROBERTSON_T_STEPS, robertson_frame
    return get("robertson").framework(robertson_frame(),
                                      t_steps=ROBERTSON_T_STEPS, atol=1e-12,
                                      device=device)


def lsoda_robertson(times, rates=(0.04, 3e7, 1e4)):
    """Robertson from (1, 0, 0) by scipy's LSODA at rtol 1e-10, atol 1e-14
    (bench/suite.py's reference)."""
    from scipy.integrate import odeint
    k1, k2, k3 = rates
    return odeint(lambda y, t: [-k1 * y[0] + k3 * y[1] * y[2],
                                k1 * y[0] - k2 * y[1] ** 2
                                - k3 * y[1] * y[2], k2 * y[1] ** 2],
                  [1.0, 0.0, 0.0], times, rtol=1e-10, atol=1e-14,
                  mxstep=1000000)


def max_rel(got, ref):
    """bench/suite.py's final-state error: max |got - ref| / max(|ref|,
    1e-10)."""
    import numpy as np
    return float(np.max(np.abs(np.asarray(got, np.float64) - ref)
                        / np.maximum(np.abs(ref), 1e-10)))


def launch_args(call, sampler):
    """A captured wrapper call's arguments (or a ``survey_fused`` call's,
    ``sampler`` 'survey') as its launcher and its twin take them: (spec,
    plan, y0, theta (P, C), seed, run keywords); the ensemble's theta is
    its walkers' start (P, W), prior-free."""
    import numpy as np
    import torch
    from odelib_tpu_torch.ops import cuda_mh, cuda_pt
    spec, obs, tf, y0, th = call["args"][:5]
    kw = call["kw"]
    plan = cuda_mh._build_plan(spec, obs, tf, cuda_mh._normalize_substeps(
        kw["substeps"], len(tf) - 1))
    if sampler == "survey":
        return spec, plan, y0, th.t().contiguous(), None, {}
    seed = call["args"][5] if len(call["args"]) > 5 else kw["seed"]
    mask = kw.get("walk_mask")
    mask = [1.0] * spec.theta_size if mask is None \
        else [float(w) for w in mask]
    walked = tuple(w != 0.0 for w in mask)
    if sampler == "ensemble":
        th_np = th.cpu().numpy()
        tile = kw.get("tile_chains") or cuda_mh.pick_tile_chains(len(th_np))
        start = torch.as_tensor(np.ascontiguousarray(cuda_mh.ensemble_init(
            th_np, seed, tile, tuple(mask), 0.01).T), device=th.device)
        return spec, plan, y0, start, seed, dict(
            tile=tile, a=float(kw.get("a", 2.0)), walk=tuple(mask),
            walked=walked, num=int(np.count_nonzero(th_np[0])),
            W0=len(th_np))
    num = int(torch.count_nonzero(th[0]))
    if sampler == "pt":
        sc, bt, db = cuda_pt.ladder_constants(
            tuple(kw["temperatures"]), kw["rwalk_std"], mask)
        run = dict(scales=sc, walked=walked, betas=bt, dbetas=db,
                   swap_every=int(kw["swap_every"]), num=num)
    else:
        run = dict(walk=tuple(float(kw["rwalk_std"]) * w for w in mask),
                   walked=walked, num=num)
    return spec, plan, y0, th.t().contiguous(), seed, run


def kernel_costs(sampler, stepper, args, reps=1, short=None):
    """The survey's or a chain kernel's (``sampler``) ``stepper``
    instantiation on ``args`` (``launch_args``'s tuple): the card time of
    its launcher (CUDA events; a chain kernel's whole run of ``NITS``
    iterations, ``BURNIN`` of them unrecorded), and with ``short`` its
    twin's on the card (a chain kernel's over ``short - 1`` proposals,
    scaled to ``NITS - 1``), its bound and the float32 operations behind
    it (the twin counted on the CPU, on one chain or one ensemble of 256
    walkers, ``per_iteration_ops``): (ms, plain_ms, (bound_ms, bound_by),
    ops), the last three None without ``short``."""
    import torch
    from odelib_tpu_torch.ops import cuda_mh, cuda_pt
    spec, plan, y0, th, seed, run = args
    if sampler == "survey":
        ms = events_ms(cuda_mh.survey_launcher(spec, plan, y0, stepper, th),
                       reps=reps)
    else:
        launcher = {"mh": cuda_mh.mh_launcher,
                    "ensemble": cuda_mh.ensemble_launcher,
                    "pt": cuda_pt.pt_launcher}[sampler]
        ms = events_ms(launcher(spec, plan, y0, stepper, th, seed, nits=NITS,
                                burnin=BURNIN, **run), reps=reps)
    if short is None:
        return ms, None, None, None
    twin = {"survey": cuda_mh.survey_plain, "mh": cuda_mh.mh_plain,
            "ensemble": cuda_mh.ensemble_plain,
            "pt": cuda_pt.pt_plain}[sampler]
    nbytes = th.numel() * 4 + sum(a.nbytes for a in cuda_mh.plan_tables(
        spec, plan, y0, stepper))
    C = th.shape[1]
    if sampler == "survey":
        plain_ms = events_ms(lambda: twin(spec, plan, y0, th, stepper))
        ops = C * fp32_ops(lambda: twin(spec, plan, y0,
                                        th[:, :1].cpu().contiguous(), stepper))
        return ms, plain_ms, bound(ops, nbytes + C * 4), ops
    plain_ms = events_ms(lambda: twin(
        spec, plan, y0, th, seed, nits=short, burnin=0, stepper=stepper,
        **run)) / (short - 1) * (NITS - 1)
    R = NITS - 1 - BURNIN
    if sampler == "ensemble":
        one_run = dict(run, tile=256, W0=256)
        one = torch.as_tensor(cuda_mh.ensemble_init(
            th[:, :256].t().cpu().numpy(), seed, 256, run["walk"], 0.01).T
            .copy())
        init, step, rec = per_iteration_ops(lambda n, b: twin(
            spec, plan, y0, one, seed, nits=n, burnin=b, stepper=stepper,
            **one_run))
        C = run["W0"]            # walkers recorded; th holds the padded
        ops = (th.shape[1] * (init + (NITS - 1) * step) + C * R * rec) / 256
    else:
        one = th[:, :1].cpu().contiguous()
        init, step, rec = per_iteration_ops(lambda n, b: twin(
            spec, plan, y0, one, seed, nits=n, burnin=b, stepper=stepper,
            **run))
        ops = C * (init + (NITS - 1) * step + R * rec)
    nbytes += R * C * (th.shape[0] + 4 + (sampler == "pt")) * 4
    return ms, plain_ms, bound(ops, nbytes), ops


def survey_vs_twin(label, call):
    """A captured ``survey_fused`` call through its kernel and its twin on
    the card: every chi bitwise (``compare_chi``); returns its error."""
    import torch
    from odelib_tpu_torch.ops import cuda_mh
    chi_k = cuda_mh.survey_fused(*call["args"], **call["kw"])
    torch.cuda.synchronize()
    spec, plan, y0, th, _, _ = launch_args(call, "survey")
    chi_t = cuda_mh.survey_plain(spec, plan, y0, th, call["kw"]["stepper"])
    torch.cuda.synchronize()
    return compare_chi(label, chi_k.cpu().numpy(), chi_t.cpu().numpy())


def stiff_phases(framework, rfw, smi_line):
    """The stiff path (the module docstring's phase stiff) on ``rfw``, the
    Robertson fit's framework: (b) config 6 and the ensemble and PT on it
    through the user API, with 'auto'; (c) the Robertson fit and its two
    gates; (a) each kvaerno3 kernel against its twin at the wrapper calls
    (b) and (c) made, and MH chunked against its whole run; (d) config 5's
    batch through the torch solvers; (e) each kvaerno3 kernel's time
    against its dopri5 instantiation. Returns the four kernels' rows of
    the JSON line."""
    import numpy as np
    import torch
    from odelib_tpu_torch.data import nearest_grid_indices
    from odelib_tpu_torch.model import state_func, state_jac
    from odelib_tpu_torch.models import robertson
    from odelib_tpu_torch.ops import cuda_mh, cuda_pt, schedule
    from odelib_tpu_torch.ops.integrate import (odeint_fixed, odeint_grid,
                                                odeint_grid_batch)
    from scoring_cases import ROBERTSON_TIMES
    dev = rfw.device
    pnames = ("mu", "phi", "beta")
    wrapper = {"mh": (cuda_mh, "metropolis_hastings_fused"),
               "ensemble": (cuda_mh, "ensemble_fused"),
               "pt": (cuda_pt, "parallel_tempering_fused")}
    calls, launches = {}, {}

    @contextlib.contextmanager
    def recorded(key, sampler="mh"):
        """Record ``sampler``'s and the survey's wrapper calls under
        ``key`` and ``'survey ' + key``."""
        mod, name = wrapper[sampler]
        with recording(mod, name, calls.setdefault(key, {})), \
                recording(cuda_mh, "survey_fused",
                          calls.setdefault(f"survey {key}", {})):
            yield

    phase("stiff (b): bench/suite.py's config 6 through the user API, "
          "MCMC(method='kvaerno3', substeps=4) on zero_i and the demo, "
          "10,240 chains x 1,000; the ensemble (12,288 walkers) and PT "
          "(10,000 x 4 rungs) on it")
    for sampler, n_chains in (("mh", STIFF_CHAINS),
                              ("ensemble", STIFF_WALKERS), ("pt", CHAINS)):
        extra = dict(temperatures=TEMPS) if sampler == "pt" else {}
        with recorded(sampler, sampler):
            post, launches[sampler] = drive(
                f"stiff (b) MCMC(sampler={sampler!r}, method='kvaerno3', "
                "substeps=4)", framework(), wrapper[sampler][1], pnames,
                n_chains, chain_inits=n_chains, fitsurvey_samples=1000,
                sd_fitdistance=6.0, sampler=sampler, method="kvaerno3",
                substeps=4, **extra)
        steppers = (calls[sampler]["kw"]["stepper"],
                    calls[f"survey {sampler}"]["kw"]["stepper"])
        last = post[post.iteration == post.iteration.max()]
        acc = float(last.acceptance_ratio.mean())
        lo, hi = BANDS[sampler]
        if steppers != ("kvaerno3", "kvaerno3") or not lo <= acc <= hi:
            fail(f"stiff (b) {sampler}: steppers {steppers}, mean final "
                 f"acceptance {acc} outside [{lo}, {hi}]")
    fw = framework()
    t0 = time.perf_counter()
    with recorded("auto"):
        drive("stiff (b) MCMC(sampler='mh', method='kvaerno3', "
              "substeps='auto')", fw, "metropolis_hastings_fused", pnames,
              STIFF_CHAINS, chain_inits=STIFF_CHAINS, fitsurvey_samples=1000,
              sd_fitdistance=6.0, method="kvaerno3", substeps="auto")
    sched = fw._auto_schedule
    print(f"stiff (b) substeps='auto' (Kvaerno5 calibration): schedule "
          f"{list(sched)}, {schedule.schedule_cost(sched)} Kvaerno3 steps a "
          f"solve against substeps=4's {4 * len(sched)}; calibration "
          f"{fw.last_profile['calibration']:.3f} s of "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    phase("stiff (c): Robertson, a stiff fit: models.get('robertson')"
          ".framework(df).MCMC(sampler='mh', method='kvaerno3', "
          "substeps='auto', 10,240 chains x 1,000)")
    snapped = rfw.times[nearest_grid_indices(ROBERTSON_TIMES, rfw.times)]
    moved = snapped != ROBERTSON_TIMES
    print(f"Robertson framework: {len(rfw.times)} grid points, compact "
          f"grid {len(rfw._times_fit)} points, y0 "
          f"{[float(v) for v in rfw.get_inits()]}; {int(moved.sum())} of "
          f"{len(ROBERTSON_TIMES)} observation times snapped to the grid: "
          + ", ".join(f"{t:.3g} -> {g:.3g}" for t, g in
                      zip(ROBERTSON_TIMES[moved], snapped[moved])),
          flush=True)
    with recorded("robertson"):
        drive("stiff (c) Robertson MCMC(sampler='mh', method='kvaerno3', "
              "substeps='auto'; no report: its adaptive solve steps to each "
              "of 1,000,001 grid points)", rfw, "metropolis_hastings_fused",
              robertson.pnames, STIFF_CHAINS, report=False,
              chain_inits=STIFF_CHAINS,
              method="kvaerno3", substeps="auto")
    rsched = rfw._auto_schedule
    print(f"stiff (c) calibrated schedule {list(rsched)}: "
          f"{schedule.schedule_cost(rsched)} Kvaerno3 steps a solve",
          flush=True)
    rspec = rfw._spec
    f_s, jac_s = state_func(rspec), state_jac(rspec)
    ref = lsoda_robertson(ROBERTSON_TIMES)[-1]

    def default_lane(n=1):
        return ([torch.full((n,), v, dtype=torch.float32, device=dev)
                 for v in robertson.default_theta],
                torch.tensor([[1.0], [0.0], [0.0]], dtype=torch.float32,
                             device=dev).expand(-1, n).contiguous())
    k1, y01 = default_lane()
    kv = odeint_fixed(f_s, y01, ROBERTSON_TIMES, k1, substeps=8,
                      method="kvaerno3", jac=jac_s)
    dp = odeint_fixed(f_s, y01, ROBERTSON_TIMES, k1, substeps=8,
                      method="dopri5")
    err1 = max_rel(kv.ys[-1, :, 0].cpu().numpy(), ref)
    dp_fin = bool(dp.ok.all())
    print(f"stiff (c) gate 1: odeint_fixed(method='kvaerno3', substeps=8) "
          f"on the card, float32, final state {kv.ys[-1, :, 0].tolist()} "
          f"against LSODA {ref.tolist()}: max rel err {err1:.3e} (bound "
          f"1e-3); gate 2: dopri5 at the same steps finite: {dp_fin}",
          flush=True)
    if not err1 < 1e-3 or dp_fin:
        fail(f"stiff (c): gate 1 err {err1}, gate 2 dopri5 finite {dp_fin}")

    phase("stiff (a): each kvaerno3 kernel against its twin at the wrapper "
          "calls (b) and (c) made (zero_i at substeps 4 and on its 'auto' "
          "schedule, Robertson on its), and MH in 4 chunks against its "
          "whole run")
    errs = {name: 0.0 for _, name in wrapper.values()}
    errs["survey_fused"] = 0.0
    for key, what in (("mh", "zero_i, substeps 4"),
                      ("auto", f"zero_i, {schedule.schedule_cost(sched)} "
                               "steps"),
                      ("robertson", f"Robertson, "
                                    f"{schedule.schedule_cost(rsched)} "
                                    "steps")):
        call = calls[f"survey {key}"]
        if call["kw"]["stepper"] != "kvaerno3":
            fail(f"stiff (a): the {what} survey ran {call['kw']['stepper']}")
        errs["survey_fused"] = max(errs["survey_fused"], survey_vs_twin(
            f"stiff survey ({what}, {call['args'][4].shape[0]} draws)",
            call))
    for key, sampler, nits, what in (
            ("mh", "mh", 11, "zero_i, substeps 4"),
            ("auto", "mh", 11, "zero_i, 'auto'"),
            ("robertson", "mh", 11, "Robertson, 'auto'"),
            ("ensemble", "ensemble", 6, "zero_i, substeps 4"),
            ("pt", "pt", 6, "zero_i, substeps 4")):
        mod, name = wrapper[sampler]
        call = calls[key]
        if call["kw"]["stepper"] != "kvaerno3":
            fail(f"stiff (a): {key} ran {call['kw']['stepper']}")
        err, _ = kernel_vs_twin_at(
            f"stiff {sampler} ({what}, kvaerno3, all "
            f"{call['args'][4].shape[0]} chains, {nits - 1} proposals)",
            getattr(mod, name), call, nits)
        errs[name] = max(errs[name], err)
    args, kw = calls["mh"]["args"], calls["mh"]["kw"]
    n0 = cuda_mh.LAUNCHES["metropolis_hastings_fused"]
    whole = cuda_mh.metropolis_hastings_fused(*args, **kw)
    chunk = cuda_mh.metropolis_hastings_fused(*args, **{
        **kw, "checkpoint_every": 250})
    torch.cuda.synchronize()
    n_chunks = -(-(kw["nits"] - 1) // 250)
    if cuda_mh.LAUNCHES["metropolis_hastings_fused"] - n0 != 1 + n_chunks:
        fail(f"stiff MH chunked: not 1 + {n_chunks} launches")
    same_bits(f"stiff MH (kvaerno3) in {n_chunks} chunks of 250", chunk,
              whole)
    print(f"stiff MH (kvaerno3): {args[4].shape[0]} chains x {kw['nits']} in "
          f"{n_chunks} chunks of 250: bitwise the whole run", flush=True)

    phase("stiff (d): bench/suite.py's config 5 on the card: 4,096 "
          "Robertson solves through the port's torch solvers (float32)")
    N = CONFIG5_N
    ks_np = (np.array(robertson.default_theta) * np.exp(
        np.random.default_rng(0).normal(0, 0.1, (N, 3)))).astype(np.float32)
    ks = list(torch.as_tensor(ks_np.T.copy(), device=dev))
    y0 = torch.tensor([[1.0], [0.0], [0.0]], dtype=torch.float32,
                      device=dev).expand(-1, N).contiguous()

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t
    sol, s_fix = timed(lambda: odeint_fixed(f_s, y0, ROBERTSON_TIMES, ks,
                                            substeps=8, method="kvaerno3",
                                            jac=jac_s))
    sol_a, s_ad = timed(lambda: odeint_grid(
        f_s, y0, ROBERTSON_TIMES, ks, rtol=1e-5, atol=1e-8,
        method="kvaerno5", max_steps=4096, jac=jac_s))
    ad1 = odeint_grid(f_s, y01, ROBERTSON_TIMES, k1, rtol=1e-5, atol=1e-8,
                      method="kvaerno5", max_steps=4096, jac=jac_s)
    err_ad = max_rel(ad1.ys[-1, :, 0].cpu().numpy(), ref)
    naive = np.linspace(0.0, 1e3, 32)
    # the grid's adaptive pilot over 8 lanes runs on the host CPU, where
    # its step loop's small operations cost no launch (9.6 s on the card,
    # PR 10); the 4,096 solves on that grid run on the card
    (grid, gsched, oidx), s_cal = timed(lambda: schedule.auto_stiff_grid(
        f_s, [1.0, 0.0, 0.0], naive, [k[:8].cpu() for k in ks], rtol=1e-5,
        atol=1e-8, max_steps=4096))
    sol_g, s_grid = timed(lambda: odeint_fixed(
        f_s, y0, grid, ks, substeps=gsched, method="kvaerno3", jac=jac_s))
    g1 = odeint_fixed(f_s, y01, grid, k1, substeps=gsched,
                      method="kvaerno3", jac=jac_s)
    err_g = max_rel(g1.ys[oidx[-1], :, 0].cpu().numpy(),
                    lsoda_robertson(naive)[-1])
    sol_b, s_b = timed(lambda: odeint_grid_batch(
        f_s, [1.0, 0.0, 0.0], naive, ks, rtol=1e-5, atol=1e-8,
        max_steps=4096, jac=jac_s))
    ok_b = float(sol_b.ok.float().mean())
    print(f"stiff (d) fixed Kvaerno3 x 8 on the geomspace grid: {s_fix:.3f} "
          f"s for {N} solves, finite {float(sol.ok.float().mean())}; "
          f"adaptive Kvaerno5 (rtol 1e-5, atol 1e-8): {s_ad:.3f} s, ok "
          f"{float(sol_a.ok.float().mean())}, steps max "
          f"{int(sol_a.num_steps.max())}, default lane's final state max "
          f"rel err {err_ad:.3e} against LSODA; auto_stiff_grid on "
          f"linspace(0, 1e3, 32) from 8 pilot lanes on the host CPU: "
          f"{s_cal:.3f} s, "
          f"{len(grid)} nodes, {schedule.schedule_cost(gsched)} steps, then "
          f"{s_grid:.3f} s for {N} solves, default lane's max rel err "
          f"{err_g:.3e}; odeint_grid_batch (Dopri5 probe, Kvaerno5 for the "
          f"failed lanes): {s_b:.3f} s, ok fraction {ok_b}", flush=True)
    if not (err_ad < 1e-3 and err_g < 1e-3 and ok_b > 0.99):
        fail(f"stiff (d): adaptive err {err_ad}, auto grid err {err_g}, "
             f"batch ok {ok_b}")

    phase("stiff (e): each kvaerno3 kernel's time against its dopri5 "
          "instantiation at config 6's shapes, substeps 4 (CUDA "
          f"events; {smi_line})")
    rows = []
    for sampler, name, src, replaces in (
            ("survey", "survey_fused", "mh.cu",
             "odelib_tpu/ops/pallas_mh.py:1765"),
            ("mh", "metropolis_hastings_fused", "mh.cu",
             "odelib_tpu/ops/pallas_mh.py:1017"),
            ("ensemble", "ensemble_fused", "ensemble.cu",
             "odelib_tpu/ops/pallas_mh.py:1514"),
            ("pt", "parallel_tempering_fused", "pt.cu",
             "odelib_tpu/ops/pallas_pt.py:49")):
        args = launch_args(calls["survey mh" if sampler == "survey"
                                 else sampler], sampler)
        reps = 20 if sampler == "survey" else 1
        dp_ms = kernel_costs(sampler, "dopri5", args, reps)[0]
        # the twin over 1 proposal (and its initial scoring), scaled
        ms, plain_ms, b, ops = kernel_costs(sampler, "kvaerno3", args, reps,
                                            short=2)
        print(f"{name} kvaerno3 {ms:.4f} ms, dopri5 {dp_ms:.4f} ms "
              f"({ms / dp_ms:.2f} x); twin {plain_ms:.1f} ms; bound "
              f"{b[0]:.4f} ms by {b[1]} ({ops:.3g} ops)", flush=True)
        launch_of = launches["mh" if sampler == "survey" else sampler]
        rows.append({
            "name": f"{name}:kvaerno3", "route": "cuda",
            "source": "odelib_tpu_torch/ops/csrc/" + src,
            "replaces": replaces, "launches": launch_of[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b[0], "bound_by": b[1], "library_ms": None})
    return rows


# -- forcings and array parameters --------------------------------------------

# the forcing of the forced paths: zero_i's growth scaled by g(t)
G_TABLE = ((0.0, 1.5, 3.2), (0.8, 1.4, 0.9))
G_ONE = ((0.0, 3.2), (1.0, 1.0))          # g = 1: the unforced model
A_TABLE = ((0.0, 2.0, 4.0), (1.2, 0.6, 1.0))   # the PMMH drift's scale


def _forced_zero_i(t, y, ps, u):
    mu, phi, beta = ps
    S, V = y
    return [mu * u["g"] * S - phi * S * V, beta * phi * S * V - phi * S * V]


def _forced_gbm(y, t, ps, u):
    import numpy as np
    return np.array([ps[0] * u["a"] * y[0]])


def _vec_zero_i(t, y, ps):
    """zero_i with a 2-vector mu: mu[0] grows S, mu[1] clears V (the
    reference's tests/test_array_params.py vec_model)."""
    mu, phi, beta = ps
    S, V = y
    return [mu[0] * S - phi * S * V,
            beta * phi * S * V - phi * S * V - mu[1] * V]


def forcing_frameworks(framework, pmmh_framework):
    """The forced paths' frameworks: zero_i with g in each mode on the
    demo data, g = 1, the forced GBM (and a = 1), and the array
    parameter's two templates; their specs feed the build phase."""
    import numpy as np
    import scipy.stats
    from odelib_tpu_torch import parameter

    def forced(mode, table=G_TABLE, df=None, **kw):
        return framework(df, ode=_forced_zero_i,
                         forcings={"g": table + (mode,)}, **kw)

    def forced_gbm(table):
        return pmmh_framework(ode=_forced_gbm,
                              forcings={"a": table + ("linear",)})

    def vec(template):
        return framework(ode=_vec_zero_i, mu=parameter(
            scipy.stats.lognorm, {"s": 3, "scale": 1e-8},
            init_value=np.array(template), random_seed=1))
    return forced, forced_gbm, vec


def forcing_builds(fa, spec, demo_sc, pf_sc):
    """load_kernels arguments of the libraries the forcing and array
    phases load (``fa``: :func:`forcing_frameworks`; ``spec``: zero_i's):
    the forced zero_i (explicit and kvaerno3; every mode and g = 1 share
    one library, the tables being plan data), the joint fit of zero_i and
    forced zero_i, the forced GBM's SDE library and the array model's."""
    forced, forced_gbm, vec = fa
    f = forced("linear")._spec
    return [(f, (), False, [demo_sc]), (f, (), False, [demo_sc], True),
            (spec, (f,), False, [demo_sc, demo_sc]),
            (forced_gbm(A_TABLE)._spec, (), True, [pf_sc]),
            (vec([0.5, 0.1])._spec, (), False, [demo_sc])]


def forced_costs(sampler, stepper, call, plain_spec, keep=None):
    """A forced (or array) path's captured wrapper call, timed through its
    kernel beside the plain model's kernel on the same chains and plan
    (``plain_spec``: the same grid and observations, no forcing table; for
    an array parameter zero_i on the slots ``keep``), in one call: (ms,
    plain model's ms, twin ms, (bound_ms, bound_by)) by ``kernel_costs``
    (the twin over 1 proposal and its initial scoring, scaled)."""
    import torch
    args = launch_args(call, sampler)
    reps = 20 if sampler == "survey" else 1
    ms, plain_ms, b, _ = kernel_costs(sampler, stepper, args, reps, short=2)
    spec, plan, y0, th, seed, run = args
    if keep is not None:
        th = th[list(keep)].contiguous()
        run = dict(run, walk=tuple(run["walk"][k] for k in keep),
                   walked=tuple(run["walked"][k] for k in keep),
                   num=int(torch.count_nonzero(th[:, 0])))
    u_ms = kernel_costs(sampler, stepper,
                        (plain_spec, plan, y0, th, seed, run), reps)[0]
    return ms, u_ms, plain_ms, b


def joint_costs(call, plain_specs):
    """The joint path's captured call through its kernel (whole run) and
    with the experiments' specs swapped for ``plain_specs`` (the same
    plans' unforced models), its twin over 1 proposal (scaled) and its
    bound (float32 operations of one chain's twin on the CPU)."""
    from odelib_tpu_torch.ops import cuda_joint, cuda_mh
    specs, idx, obs, times, y0s, th0 = call["args"][:6]
    kw = call["kw"]
    plans = [cuda_mh._build_plan(sp, ob, tm, cuda_mh._normalize_substeps(
        sub, len(tm) - 1)) for sp, ob, tm, sub in
        zip(specs, obs, times, kw["substeps_list"])]
    run = dict(walk=tuple(float(kw["rwalk_std"]) * float(w)
                          for w in kw["walk_mask"]),
               walked=tuple(float(w) != 0.0 for w in kw["walk_mask"]))
    th = th0.t().contiguous()
    seed, step = kw["seed"], kw["stepper"]
    ms = events_ms(cuda_joint.joint_launcher(
        specs, plans, y0s, idx, step, th, seed, nits=NITS, burnin=BURNIN,
        **run))
    u_ms = events_ms(cuda_joint.joint_launcher(
        plain_specs, plans, y0s, idx, step, th, seed, nits=NITS,
        burnin=BURNIN, **run))
    plain_ms = events_ms(lambda: cuda_joint.joint_plain(
        specs, plans, y0s, idx, th, seed, nits=2, burnin=0, stepper=step,
        **run)) * (NITS - 1)
    one = th[:, :1].cpu().contiguous()
    init, walk, rec = per_iteration_ops(lambda n, b: cuda_joint.joint_plain(
        specs, plans, y0s, idx, one, seed, nits=n, burnin=b, stepper=step,
        **run))
    C, D, K = th.shape[1], th.shape[0], len(specs)
    R = NITS - 1 - BURNIN
    nbytes = sum(a.nbytes for a in cuda_joint.joint_tables(
        specs, plans, y0s, idx, step)[:3]) + C * D * 4 \
        + R * C * (D + K + 2) * 4
    return ms, u_ms, plain_ms, bound(
        C * (init + (NITS - 1) * walk + R * rec), nbytes)


def pf_costs(call, plain_spec, chains=2):
    """The forced PMMH path's captured call through its kernel (whole
    run) and with the plain GBM's spec on the same chains, its twin over 1
    proposal (scaled) and its bound (float32 operations of ``chains``
    chains' twins on the CPU, averaged: the selection's work depends on
    the data)."""
    from odelib_tpu_torch.ops import cuda_mh, cuda_pf
    spec, obs, tf, y0, th0 = call["args"]
    kw = call["kw"]
    plan = cuda_mh._build_plan(spec, obs, tf, cuda_mh._normalize_substeps(
        kw["substeps"], len(tf) - 1))
    run = pmmh_twin_kw(kw)
    th = th0.t().contiguous()
    burn = PF_NITS // 2
    ms = events_ms(cuda_pf.pmmh_launcher(spec, plan, y0, th, kw["seed"],
                                         nits=PF_NITS, burnin=burn, **run))
    u_ms = events_ms(cuda_pf.pmmh_launcher(plain_spec, plan, y0, th,
                                           kw["seed"], nits=PF_NITS,
                                           burnin=burn, **run))
    plain_ms = events_ms(lambda: cuda_pf.pmmh_plain(
        spec, plan, y0, th, kw["seed"], nits=2, burnin=0, **run)) \
        * (PF_NITS - 1)
    counts = [per_iteration_ops(lambda n, b, c=c: cuda_pf.pmmh_plain(
        spec, plan, y0, th[:, c:c + 1].cpu().contiguous(), kw["seed"],
        nits=n, burnin=b, **run)) for c in range(chains)]
    init, walk, rec = (sum(v) / len(counts) for v in zip(*counts))
    C, P = th.shape[1], th.shape[0]
    R = PF_NITS - 1 - burn
    nbytes = sum(a.nbytes for a in cuda_mh.plan_tables(
        spec, plan, y0, "euler")) + (C + 7) * P * 4 + R * C * (P + 2) * 4
    return ms, u_ms, plain_ms, bound(
        C * (init + (PF_NITS - 1) * walk + R * rec), nbytes)


def frozen_acceptance(post):
    """PMMH's mean acceptance after burn-in's adaptation, from a path's
    posterior (the running ratios at its first and last records)."""
    import numpy as np
    pf_R = PF_NITS - 1 - PF_NITS // 2
    ar = post.acceptance_ratio.to_numpy().reshape(-1, pf_R)
    its = np.arange(1, PF_NITS)[PF_NITS // 2:].astype(float)
    return float(np.mean((ar[:, -1] * its[-1] - ar[:, 0] * its[0])
                         / (its[-1] - its[0])))


def forcing_phases(fa, joint_pair, plain, mh_in, pf_in, smi_line):
    """The forcing phases (a)-(e), g = 1 and the array phases (the module
    docstring), on ``fa`` (:func:`forcing_frameworks`), ``joint_pair(fw)``
    (the joint path's pair with ``fw`` as its perturbed experiment),
    ``plain`` (the unforced zero_i and GBM specs) and the unforced MH and
    PMMH main paths' captured calls. Returns the forced instantiations'
    rows of the JSON line."""
    import numpy as np
    import torch
    from odelib_tpu_torch import JointFit
    from odelib_tpu_torch.ops import cuda_joint, cuda_mh, cuda_pf, cuda_pt
    forced, forced_gbm, vec = fa
    pnames = ("mu", "phi", "beta")
    wrapper = {"mh": (cuda_mh, "metropolis_hastings_fused"),
               "ensemble": (cuda_mh, "ensemble_fused"),
               "pt": (cuda_pt, "parallel_tempering_fused"),
               "joint": (cuda_joint, "joint_metropolis_hastings_fused"),
               "pmmh": (cuda_pf, "pmmh_fused")}
    calls, launches, errs = {}, {}, {}

    def path(key, sampler, model, n_chains, label, survey=True, **kw):
        """Drive one forced path through ``MCMC(sampler=...)``, recording
        its chain wrapper's call (and the survey's) under ``key``; checks
        its sampler's band."""
        mod, name = wrapper[sampler]
        if sampler in ("ensemble", "pt", "pmmh"):
            kw["sampler"] = sampler
        with recording(mod, name, calls.setdefault(key, {})), \
                recording(cuda_mh, "survey_fused",
                          calls.setdefault(f"survey {key}", {})):
            post, launches[key] = drive(
                label, model, name, () if sampler == "joint" else
                model._pnames, n_chains, survey=survey,
                chain_inits=n_chains, fitsurvey_samples=1000, **kw)
        if sampler == "pmmh":
            acc, (lo, hi) = frozen_acceptance(post), (0.15, 0.5)
        else:
            last = post[post.iteration == post.iteration.max()]
            acc, (lo, hi) = (float(last.acceptance_ratio.mean()),
                             BANDS[sampler])
        if not lo <= acc <= hi:
            fail(f"{label}: acceptance {acc} outside [{lo}, {hi}]")
        print(f"{label}: {'frozen-phase' if sampler == 'pmmh' else 'mean'}"
              f" acceptance {acc:.4f} in [{lo}, {hi}]", flush=True)
        return post

    def held_at(key, sampler, nits=21, burnin=10):
        """The path's wrapper call through kernel and twin at all chains
        (bitwise); keeps chi's max abs error per wrapper."""
        mod, name = wrapper[sampler]
        call = calls[key]
        n = call["args"][4 if sampler != "joint" else 5].shape[0]
        if sampler == "pmmh":
            err, _ = pmmh_vs_twin(f"{key}: pmmh_fused (all {n} chains, "
                                  f"{nits - 1} proposals, {burnin} "
                                  "adapting)", call, nits, burnin)
        else:
            err, _ = kernel_vs_twin_at(f"{key}: {name} (all {n} chains, "
                                       f"{nits - 1} proposals)",
                                       getattr(mod, name), call, nits)
        errs[key] = err

    phase("forcings (a): MCMC(sampler='mh') on forced zero_i (g linear), "
          "10,000 chains x 1,000, the demo data")
    path("a", "mh", forced("linear"), CHAINS, "forcings (a) MH, linear",
         sd_fitdistance=6.0)
    errs["survey a"] = survey_vs_twin("forcings (a) survey (1,000 draws)",
                                      calls["survey a"])
    held_at("a", "mh")

    phase("forcings (b): MCMC(sampler='ensemble') on forced zero_i (g "
          "cubic), 12,288 walkers")
    path("b", "ensemble", forced("cubic"), STIFF_WALKERS,
         "forcings (b) ensemble, cubic", sd_fitdistance=6.0)
    held_at("b", "ensemble")

    phase("forcings (c): MCMC(sampler='pt') on forced zero_i (g hold), "
          "10,000 chains x 4 rungs, and MCMC(method='kvaerno3') MH, 10,240 "
          "chains")
    path("c", "pt", forced("hold"), CHAINS, "forcings (c) PT, hold",
         sd_fitdistance=6.0, temperatures=TEMPS)
    held_at("c", "pt")
    path("c kv3", "mh", forced("hold"), STIFF_CHAINS,
         "forcings (c) MH, hold, kvaerno3", sd_fitdistance=6.0,
         method="kvaerno3")
    if calls["c kv3"]["kw"]["stepper"] != "kvaerno3":
        fail("forcings (c): the kvaerno3 path ran another stepper")
    errs["survey c kv3"] = survey_vs_twin(
        "forcings (c) survey, kvaerno3 (1,000 draws)", calls["survey c kv3"])
    held_at("c kv3", "mh")

    phase("forcings (d): JointFit.MCMC of zero_i on the demo and forced "
          "zero_i (g linear) on it perturbed, 10,000 chains x 1,000")
    path("d", "joint", JointFit(joint_pair(lambda df, **kw: forced(
        "linear", df=df, **kw)), shared=["phi", "beta"], random_seed=0),
        CHAINS, "forcings (d) JointFit, zero_i + forced zero_i",
        survey=False)
    held_at("d", "joint")

    phase("forcings (e): MCMC(sampler='pmmh') on config 14's GBM, its "
          "drift scaled by a linear forcing, 10,240 chains x 128 particles "
          "x 200")
    pf_kw = dict(nits=PF_NITS, n_particles=PF_K,
                 sde_substeps=PF_SUB, rwalk_std=0.4, use_priors=True,
                 adapt_proposal=True, target_accept=0.3, adapt_rate=0.15)
    path("e", "pmmh", forced_gbm(A_TABLE), PF_CHAINS,
         "forcings (e) PMMH, forced GBM drift", survey=False, **pf_kw)
    held_at("e", "pmmh")

    phase("forcings: g = 1, the MH and PMMH paths against the unforced "
          "main paths, bitwise")
    for key, sampler, model, main_in, kw in (
            ("g1 mh", "mh", forced("linear", G_ONE), mh_in,
             dict(sd_fitdistance=6.0)),
            ("g1 pmmh", "pmmh", forced_gbm(G_ONE), pf_in, pf_kw)):
        path(key, sampler, model, PF_CHAINS if sampler == "pmmh" else
             CHAINS, f"g = 1: {sampler}", survey=sampler != "pmmh", **kw)
        mod, name = wrapper[sampler]
        call, fn = calls[key], getattr(mod, name)
        th_g1, th_main = call["args"][4], main_in["args"][4]
        if not torch.equal(th_g1, th_main):
            fail(f"g = 1 {sampler}: the seeds differ from the unforced "
                 "main path's")
        out_g1 = fn(*call["args"], **call["kw"])
        out_main = fn(*main_in["args"], **main_in["kw"])
        torch.cuda.synchronize()
        same_bits(f"g = 1 {sampler}: records against the unforced main "
                  "path's", out_g1, out_main)
        print(f"g = 1 {sampler}: seeds and every record bitwise the "
              "unforced main path's", flush=True)

    phase("array parameters (a): MCMC(sampler='mh', use_priors=True) on "
          "zero_i with mu a 2-vector, 10,000 chains x 1,000")
    post = path("array a", "mh", vec([0.5, 0.1]), CHAINS,
                "array (a) MH, mu = [mu0, mu1], priors", sd_fitdistance=6.0,
                use_priors=True)
    mu = np.stack(post["mu"].to_numpy())
    if mu.shape != (len(post), 2) or not (np.std(mu, axis=0) > 0).all():
        fail(f"array (a): mu cells of shape {mu.shape}, not walked")
    held_at("array a", "mh")
    phase("array parameters (b): the same with mu = [mu0, 0], the zero "
          "entry pinned")
    post = path("array b", "mh", vec([0.5, 0.0]), CHAINS,
                "array (b) MH, mu = [mu0, 0], priors", sd_fitdistance=6.0,
                use_priors=True)
    mu = np.stack(post["mu"].to_numpy())
    if not (mu[:, 1] == 0.0).all():
        fail("array (b): the pinned entry moved")
    print(f"array (b): mu[1] is exactly 0 in all {len(mu)} rows", flush=True)
    held_at("array b", "mh")

    phase("forcings: each forced kernel's time beside the unforced one on "
          f"the same chains (CUDA events; {smi_line})")
    rows = []
    csrc = "odelib_tpu_torch/ops/csrc/"
    spec_u, gbm_u = plain
    for name, key, sampler, stepper, src, replaces, what in (
            ("survey_fused", "survey a", "survey", "dopri5", "mh.cu",
             "odelib_tpu/ops/pallas_mh.py:1765", "1,000 draws"),
            ("metropolis_hastings_fused", "a", "mh", "dopri5", "mh.cu",
             "odelib_tpu/ops/pallas_mh.py:1017", "10,000 x 1,000"),
            ("ensemble_fused", "b", "ensemble", "dopri5", "ensemble.cu",
             "odelib_tpu/ops/pallas_mh.py:1514", "12,288 x 1,000"),
            ("parallel_tempering_fused", "c", "pt", "dopri5", "pt.cu",
             "odelib_tpu/ops/pallas_pt.py:49", "10,000 x 4 x 1,000"),
            ("metropolis_hastings_fused", "c kv3", "mh", "kvaerno3", "mh.cu",
             "odelib_tpu/ops/pallas_mh.py:1017", "10,240 x 1,000"),
            ("joint_metropolis_hastings_fused", "d", "joint", "dopri5",
             "joint.cu", "odelib_tpu/ops/pallas_joint.py:347",
             "10,000 x 1,000, K = 2"),
            ("pmmh_fused", "e", "pmmh", "euler", "pf.cu",
             "odelib_tpu/ops/pallas_pf.py:130", "10,240 x 128 x 200"),
            ("metropolis_hastings_fused", "array a", "mh", "dopri5", "mh.cu",
             "odelib_tpu/ops/pallas_mh.py:1017", "10,000 x 1,000, P = 4")):
        if sampler == "joint":
            ms, u_ms, plain_ms, b = joint_costs(calls[key], (spec_u, spec_u))
        elif sampler == "pmmh":
            ms, u_ms, plain_ms, b = pf_costs(calls[key], gbm_u)
        else:
            ms, u_ms, plain_ms, b = forced_costs(
                sampler, stepper, calls[key], spec_u,
                (0, 2, 3) if key.startswith("array") else None)
        tag = "array" if key.startswith("array") else "forced" + (
            "-kvaerno3" if stepper == "kvaerno3" else "")
        print(f"{name} {tag} ({what}): {ms:.4f} ms, unforced scalar zero_i "
              f"{u_ms:.4f} ms on the same chains ({100 * (ms / u_ms - 1):+.2f}"
              f" %); twin {plain_ms:.1f} ms; bound {b[0]:.4f} ms by {b[1]}",
              flush=True)
        lkey = key.split()[-1] if sampler == "survey" else key
        rows.append({
            "name": f"{name}:{tag}", "route": "cuda",
            "source": csrc + src, "replaces": replaces,
            "launches": launches[lkey if lkey in launches else key][name],
            "max_abs_err": errs[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b[0], "bound_by": b[1], "library_ms": None})
    return rows


# -- the lifted limits: long ladders, many experiments, many states -----------

LV_LADDER = tuple(float(t) for t in __import__("numpy").geomspace(
    1.0, 1000.0, 16))
LV_WIDE = tuple(float(t) for t in __import__("numpy").geomspace(
    1.0, 1000.0, 40))
FEW = 256                   # chains of the wide arms (40 rungs, K = 40)
CHEMOSTAT_D = tuple(round(0.05 * (k + 1), 2) for k in range(12))
CHEMOSTAT_D40 = tuple(round(0.015 * (k + 1), 3) for k in range(40))
CHAIN_N = 40                # two_i's latent classes: 42 states


def limits_frameworks(device="cuda"):
    """(a) Lotka-Volterra on ``scoring_cases.lv_frame`` (t_steps 49: the
    25 observation times on the grid), (b) ``chemostats(ds)``: one
    chemostat framework per dilution rate d (feed 5, t_steps 16: the 16
    times on the grid, ``chemostat_frames``), (c) the 42-state chain on
    the demo data (host H = S + I1 + ... + I40, two_i's priors with tau's
    scale x 39, S0 the host's first point), all on ``device``."""
    from odelib_tpu_torch import ModelFramework, parameter
    from odelib_tpu_torch.data import load_demo_dataframe
    from odelib_tpu_torch.models import chemostat, lotka_volterra
    from scoring_cases import (CHAIN_PNAMES, chain_priors, chain_rhs,
                               chain_snames, chain_summations,
                               chemostat_frames, lv_frame)
    lv = lotka_volterra.framework(lv_frame(), t_steps=49, device=device)

    def chemostats(ds):
        return {f"d{k}": chemostat.framework(df, d=float(d), Rin=5.0,
                                             t_steps=16, device=device)
                for k, (d, df) in enumerate(zip(ds, chemostat_frames(ds)))}
    df = load_demo_dataframe(host="H", virus="V")
    pri = chain_priors(CHAIN_N)
    chain = ModelFramework(
        ODE=chain_rhs(CHAIN_N), parameter_names=list(CHAIN_PNAMES),
        state_names=list(chain_snames(CHAIN_N)), dataframe=df,
        state_summations=chain_summations(CHAIN_N), t_steps=288,
        S=float(df[df.organism == "H"].abundance.iloc[0]), device=device,
        ode_style="jax", **{p: parameter(stats_gen=pri[p], name=p,
                                         random_seed=i)
                            for i, p in enumerate(CHAIN_PNAMES)})
    return lv, chemostats, chain


def limits_builds(lf):
    """load_kernels arguments of the libraries the limits phases load:
    the 42-state chain's (kvaerno3 and dopri5),
    Lotka-Volterra's and its wide library (40 rungs), and the chemostat's
    wide library (12 and 40 experiments, one model)."""
    lv, chemostats, chain = lf
    one = next(iter(chemostats(CHEMOSTAT_D[:1]).values()))
    return [(chain._spec, (), False, [fw_scoring(chain)], True),
            (chain._spec, (), False, [fw_scoring(chain)]),
            (lv._spec, (), False, [fw_scoring(lv)]),
            (lv._spec, (), False, [fw_scoring(lv)], False, False, True),
            (one._spec, (), False, [fw_scoring(one)], False, False, True)]


def cut(call, n, index=4):
    """A captured wrapper call on its first ``n`` chains."""
    args = list(call["args"])
    args[index] = args[index][:n].contiguous()
    return {"args": tuple(args), "kw": dict(call["kw"])}


def limits_phases(lf, smi_line):
    """Phases limits (a)-(c) (the module docstring) on ``lf``
    (:func:`limits_frameworks`). Returns their rows of the JSON line."""
    import numpy as np
    import torch
    from odelib_tpu_torch import JointFit
    from odelib_tpu_torch.ops import cuda_joint, cuda_mh, cuda_pt
    lv, chemostats, chain = lf
    csrc = "odelib_tpu_torch/ops/csrc/"
    rows, errs, launches, calls, twin_s, counted = [], {}, {}, {}, {}, {}

    def add(name, src, replaces, n, err, ms, plain_ms, b, what):
        print(f"{name} ({what}): {ms:.4f} ms; twin {plain_ms:.1f} ms; bound "
              f"{b[0]:.4f} ms by {b[1]}; max abs err {err}; launches {n}",
              flush=True)
        rows.append({"name": name, "route": "cuda", "source": csrc + src,
                     "replaces": replaces, "launches": n,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b[0], "bound_by": b[1], "library_ms": None})

    def driven(key, label, model, mod, name, n_chains, pnames, samples=1000,
               **kw):
        # a JointFit's survey is its float64 fit_survey, not the kernel
        with recording(mod, name, calls.setdefault(key, {})), \
                recording(cuda_mh, "survey_fused",
                          calls.setdefault(f"survey {key}", {})):
            post, launches[key] = drive(
                label, model, name, pnames, n_chains,
                survey=not isinstance(model, JointFit),
                chain_inits=n_chains, fitsurvey_samples=samples, **kw)
        return post

    def hold(key, label, fn, call, nits):
        """kernel_vs_twin_at, keeping chi's error, the kernel run's
        launches and the twin's seconds a proposal (its initial scoring
        counted as one: the twins on the card are launch-bound, so their
        time hardly depends on the chains)."""
        errs[key], _ = kernel_vs_twin_at(label, fn, call, nits)
        counted[key] = kernel_vs_twin_at.launches
        twin_s[key] = kernel_vs_twin_at.twin_s / nits

    phase("limits (a): MCMC(sampler='pt') on Lotka-Volterra (25 times over "
          "[0, 50], numpy seed 13), a 16-rung geometric ladder from 1 to "
          "1,000, 10,000 chains x 1,000; and 40 rungs on 256 chains")
    # the oscillator's chi is rugged: of 1,000 LHS draws the best is a
    # wrong mode (chi ~1,900), and 9 pass the chi cut at sd_fitdistance=20
    post = driven("pt16", "limits (a) PT, 16 rungs", lv, cuda_pt,
                  "parallel_tempering_fused", CHAINS, lv._pnames,
                  sampler="pt", temperatures=LV_LADDER, sd_fitdistance=20.0)
    post40 = driven("pt40", "limits (a) PT, 40 rungs", lv, cuda_pt,
                    "parallel_tempering_fused", FEW, lv._pnames,
                    sampler="pt", temperatures=LV_WIDE, sd_fitdistance=20.0,
                    report=False)
    for lab, p in (("16 rungs", post), ("40 rungs", post40)):
        print(f"limits (a) {lab}: best chi {float(p.chi.min()):.4g}, "
              "posterior medians " + ", ".join(
                  f"{k} {float(np.median(p[k])):.4g}" for k in lv._pnames)
              + " (simulated at 1.1, 0.4, 0.1, 0.4)", flush=True)
    del post, post40
    for key, n, what in (("pt16", 1000, "10,000 x 16 rungs x 1,000"),
                         ("pt40", FEW, "256 x 40 rungs x 1,000")):
        hold(key, f"limits (a) {key[2:]} rungs: parallel_tempering_fused "
             f"({n} chains, 2 proposals)", cuda_pt.parallel_tempering_fused,
             cut(calls[key], n), 3)
        ms, _, b, _ = kernel_costs(
            "pt", "dopri5", launch_args(calls[key], "pt"), short=2)
        add(f"parallel_tempering_fused:{key[2:]}-rungs", "pt.cu",
            "odelib_tpu/ops/pallas_pt.py:49",
            launches[key]["parallel_tempering_fused"], errs[key], ms,
            1e3 * twin_s[key] * NITS, b, f"Lotka-Volterra, {what}")

    phase("limits (b): JointFit of 12 chemostat runs (d = 0.05, ..., 0.60, "
          "shared vmax, Ks and gamma), MCMC 10,000 chains x 1,000; and 40 "
          "runs (Ks and gamma per run) on 256 chains")
    for key, ds, shared, n_chains, samples, n, nits in (
            ("j12", CHEMOSTAT_D, ["vmax", "Ks", "gamma"], CHAINS, 1000,
             1000, 3),
            ("j40", CHEMOSTAT_D40, ["vmax"], FEW, 256, 64, 2)):
        fws = chemostats(ds)
        jf = JointFit(fws, shared=shared, random_seed=0)
        static = [f"{nm}:{p}" for nm in fws for p in ("d", "Rin")]
        post = driven(key, f"limits (b) JointFit, {len(ds)} chemostat runs "
                      f"(D = {jf.dim}, {jf.dim - len(static)} walked)", jf,
                      cuda_joint, "joint_metropolis_hastings_fused",
                      n_chains, (), samples=samples,
                      static_parameters=static, report=key == "j12")
        print(f"limits (b) {len(ds)} runs: posterior median vmax "
              f"{float(np.median(post['vmax'])):.4g} (simulated at 1)",
              flush=True)
        del post
        call = calls[key]
        hold(key, f"limits (b) {len(ds)} runs: joint_metropolis_hastings_"
             f"fused ({n} chains, {nits - 1} proposals)",
             cuda_joint.joint_metropolis_hastings_fused, cut(call, n, 5),
             nits)
        # the bound: one run's solve (the twin on one chain on the host
        # CPU) times the K runs, the chains and the iterations
        specs, idx, obs, times, y0s, th0 = call["args"][:6]
        kw = call["kw"]
        plans = [cuda_mh._build_plan(sp, ob, tm, sub) for sp, ob, tm, sub
                 in zip(specs, obs, times, kw["substeps_list"])]
        one = th0[:1, list(idx[0])].t().cpu().contiguous()
        ops = fp32_ops(lambda: cuda_mh.survey_plain(specs[0], plans[0],
                                                    y0s[0], one))
        run = dict(walk=tuple(float(kw["rwalk_std"]) * float(w)
                              for w in kw["walk_mask"]),
                   walked=tuple(float(w) != 0.0 for w in kw["walk_mask"]))
        th = th0.t().contiguous()
        ms = events_ms(cuda_joint.joint_launcher(
            specs, plans, y0s, idx, kw["stepper"], th, kw["seed"],
            nits=NITS, burnin=BURNIN, **run))
        C, D, K = th.shape[1], th.shape[0], len(specs)
        nbytes = (NITS - 1 - BURNIN) * C * (D + K + 2) * 4
        add(f"joint_metropolis_hastings_fused:wide-{len(ds)}", "joint.cu",
            "odelib_tpu/ops/pallas_joint.py:347",
            launches[key]["joint_metropolis_hastings_fused"], errs[key], ms,
            1e3 * twin_s[key] * NITS, bound(C * NITS * K * ops, nbytes),
            f"{n_chains:,} x 1,000, K = {len(ds)}, D = {jf.dim}")

    phase("limits (c): MCMC(sampler='mh', substeps=4) on two_i with 40 "
          "latent classes (42 states), the demo data, 10,000 chains x 1,000")
    post = driven("mh42", "limits (c) MH, 42 states", chain, cuda_mh,
                  "metropolis_hastings_fused", CHAINS, chain._pnames,
                  substeps=4, sd_fitdistance=6.0)
    del post
    spec, obs, tf, y0 = (chain._spec, chain._obsdata_fit_host,
                         chain._times_fit, chain.get_inits())
    seeds = calls["mh42"]["args"][4]
    t0 = time.perf_counter()
    errs["survey42"] = survey_vs_twin(
        "limits (c) survey_fused (the path's 1,000 draws)",
        calls["survey mh42"])
    twin_s["survey42"] = time.perf_counter() - t0
    hold("mh42", "limits (c) metropolis_hastings_fused (16 chains, 2 "
         "proposals)", cuda_mh.metropolis_hastings_fused,
         cut(calls["mh42"], 16), 3)
    # the 42-state ensemble, PT and kvaerno3 MH kernels at a few chains
    # from the path's seeds; kvaerno3 on the data's first three sampling
    # times (two steps: its twin takes ~100,000 launches a step), in the
    # path's library (the same RHS and scoring)
    from scoring_cases import chain_case
    _, obs3, tf3, _ = chain_case(CHAIN_N, first=3)
    small = {"ens42": (cuda_mh.ensemble_fused, seeds[:256],
                       dict(tile_chains=256, a=2.0), 4, 2),
             "pt42": (cuda_pt.parallel_tempering_fused, seeds[:16],
                      dict(temperatures=(1.0, 2.0, 4.0), swap_every=1,
                           rwalk_std=0.05), 4, 3),
             "kv3": (cuda_mh.metropolis_hastings_fused, seeds[:4],
                     dict(stepper="kvaerno3", rwalk_std=0.05), 1, 2)}
    for key, (fn, th0, extra, sub, nits) in small.items():
        data = (obs3, tf3) if key == "kv3" else (obs, tf)
        calls[key] = {"args": (spec, *data, y0, th0, 11),
                      "kw": {"substeps": sub, "stepper": "dopri5",
                             "walk_mask": [1.0] * 5, **extra}}
        hold(key, f"limits (c) {fn.__name__} {key} ({th0.shape[0]} chains, "
             f"{nits - 1} proposals)", fn, calls[key], nits)

    phase(f"limits: each new instantiation's time (CUDA events; {smi_line})")
    # the bounds: one solve's float32 operations (the twin on one chain on
    # the host CPU; the kvaerno3 solve's from one step's, times its steps:
    # its elimination is ~25,000 operations a step, slow to count one by
    # one) times the run's solves
    from odelib_tpu_torch.ops.runge_kutta import kvaerno3_fixed_step
    from odelib_tpu_torch.rhs import jacobian_evaluator, torch_evaluator
    one = seeds[:1].t().cpu().contiguous()
    S = len(spec.snames)
    y1 = [torch.full((1,), float(v)) for v in y0]
    f = torch_evaluator(spec.rhs, S, spec.pshapes)
    jac = jacobian_evaluator(spec.rhs, S, spec.pshapes)
    ops = {"dopri5": fp32_ops(lambda: cuda_mh.survey_plain(
               spec, cuda_mh._build_plan(spec, obs, tf, 4), y0, one)),
           "kvaerno3": (len(tf3) - 1) * fp32_ops(
               lambda: kvaerno3_fixed_step(f, 0.0, y1, 0.1, list(one), jac))}
    ms = kernel_costs("survey", "dopri5", launch_args(
        calls["survey mh42"], "survey"), reps=5)[0]
    add("survey_fused:42-states", "mh.cu", "odelib_tpu/ops/pallas_mh.py:1765",
        launches["mh42"]["survey_fused"], errs["survey42"], ms,
        1e3 * twin_s["survey42"], bound(1000 * ops["dopri5"], 1000 * 9 * 4),
        "1,000 draws")
    for key, name, src, replaces, C, nits, solves, what in (
            ("mh42", "metropolis_hastings_fused", "mh.cu",
             "odelib_tpu/ops/pallas_mh.py:1017", CHAINS, NITS, NITS,
             "10,000 x 1,000"),
            ("ens42", "ensemble_fused", "ensemble.cu",
             "odelib_tpu/ops/pallas_mh.py:1514", 256, 100, 100,
             "256 walkers x 100"),
            ("pt42", "parallel_tempering_fused", "pt.cu",
             "odelib_tpu/ops/pallas_pt.py:49", 16, 100, 300,
             "16 x 3 rungs x 100"),
            ("kv3", "metropolis_hastings_fused", "mh.cu",
             "odelib_tpu/ops/pallas_mh.py:1017", 4, 20, 20,
             "kvaerno3, 4 x 20, substeps 1, 3 sampling times")):
        fn = small[key][0] if key in small else \
            cuda_mh.metropolis_hastings_fused
        call = calls[key]
        ms = events_ms(lambda: fn(*call["args"], **{
            **call["kw"], "nits": nits, "burnin": nits // 2}))
        b = bound(C * solves * ops["kvaerno3" if key == "kv3" else "dopri5"],
                  (nits - nits // 2 - 1) * C * (5 + 4) * 4)
        add(f"{name}:42-states" + ("-kvaerno3" if key == "kv3" else ""),
            src, replaces,
            launches["mh42"][name] if key == "mh42" else counted[key],
            errs[key], ms,
            1e3 * twin_s[key] * nits, b, what)
    return rows


def _survey_held(label, case, chi_k, chi_t):
    """The survey's chi, kernel against twin: bitwise (compare_chi), or
    for a Tobit case within rtol 1e-6."""
    import numpy as np
    a, b = chi_k.cpu().numpy(), chi_t.cpu().numpy()
    if not case[1]:
        return compare_chi(f"{label} survey", a, b)
    fin = np.isfinite(b)
    rel = np.abs(a[fin] - b[fin]) / np.abs(b[fin])
    print(f"{label} survey chi: max rel err {rel.max():.3g}, bitwise equal "
          f"{np.mean(a[fin] == b[fin]):.4f}")
    if not (np.isfinite(a) == fin).all() or rel.max() > 1e-6:
        fail(f"{label} survey: kernel and twin differ (max rel err "
             f"{rel.max():.3g})")
    return float(np.max(np.abs(a[fin] - b[fin])))


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, HERE)
    try:
        import odelib_tpu_torch
    except ImportError as e:
        fail(f"odelib_tpu_torch is not importable next to this script: {e}")
    if not os.path.abspath(odelib_tpu_torch.__file__).startswith(HERE):
        fail("odelib_tpu_torch was imported from outside this checkout")
    import numpy as np
    import pandas as pd
    import scipy.stats

    from odelib_tpu_torch import JointFit, ModelFramework, dispatch, parameter
    from odelib_tpu_torch import distributions as D
    from odelib_tpu_torch.data import (build_obsdata_host,
                                       compact_observation_grid,
                                       format_dataframe, load_demo_dataframe)
    from odelib_tpu_torch.models import one_i, zero_i
    from odelib_tpu_torch.ops import (build, cuda_joint, cuda_mh, cuda_pf,
                                      cuda_pt, schedule)
    from odelib_tpu_torch.model import chi_of_theta
    from odelib_tpu_torch.ops.priors import prior_table
    from scoring_cases import SCORING, scoring_id
    if "jax" in sys.modules:
        fail("jax was imported")
    import gc
    gc.callbacks.append(_gc_probe)

    # -- 1. device ----------------------------------------------------------
    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device: {kind}", flush=True)
    dev = torch.device("cuda")

    def framework(df=None, ode=None, **kw):
        """zero_i (or ``ode`` with its names) on the demo data with the
        main paths' priors (``kw`` may replace one)."""
        pri = dict(
            mu=parameter(scipy.stats.lognorm, {"s": 3, "scale": 1e-8},
                         random_seed=1),
            phi=parameter(scipy.stats.lognorm, {"s": 3, "scale": 1e-8},
                          random_seed=2),
            beta=parameter(scipy.stats.lognorm, {"s": 1, "scale": 25},
                           random_seed=3))
        pri.update(kw)
        return ModelFramework(
            ODE=zero_i.rhs if ode is None else ode,
            parameter_names=list(zero_i.pnames),
            state_names=list(zero_i.snames),
            dataframe=(load_demo_dataframe(host="S", virus="V")
                       if df is None else df),
            t_steps=288, device="cuda", ode_style="jax", **pri)

    def joint_pair(make_b=framework):
        """zero_i on the demo data (a) and ``make_b`` (zero_i) on the same
        frame with its log abundances perturbed (numpy seed 7, sd 0.1) and
        both initial abundances x 1.13 (b)."""
        fw_a = framework()
        df = load_demo_dataframe(host="S", virus="V")
        df["abundance"] = df["abundance"] * np.exp(
            np.random.default_rng(7).normal(0, 0.1, len(df)))
        y0_a = fw_a.get_inits(as_dict=True)
        return {"a": fw_a, "b": make_b(df, **{s: 1.13 * float(v)
                                              for s, v in y0_a.items()})}

    def joint_fit():
        """joint_pair() sharing phi and beta: D = 4."""
        return JointFit(joint_pair(), shared=["phi", "beta"],
                        random_seed=0)

    def gbm(y, t, ps):
        return np.array([ps[0] * y[0]])

    def gnoise(y, t, ps):
        return np.array([SIG * y[0]])

    def pmmh_framework(ode=gbm, **kw):
        t_obs, log_o = gbm_data()
        df = pd.DataFrame({"organism": "N", "time": t_obs,
                           "abundance": np.exp(log_o), "log_sigma": S_OBS})
        return ModelFramework(
            ODE=ode, diffusion=gnoise, parameter_names=["mu"],
            state_names=["N"], dataframe=df, t_steps=41, N=2.0,
            mu=parameter(scipy.stats.lognorm, {"s": PRI_SD,
                                               "scale": PRI_MU}),
            device="cuda", **kw)

    fw = framework()
    spec, obs, tf, y0 = (fw._spec, fw._obsdata_fit_host, fw._times_fit,
                         fw.get_inits())
    print(f"compact grid: {len(tf)} points, {len(obs.log_abundance)} "
          "observations", flush=True)
    # the heterogeneous joint check's second model: one_i, host H = S + I1
    df1 = format_dataframe(load_demo_dataframe(host="H", virus="V"),
                           one_i.snames)
    spec1 = one_i.spec()
    obs1, _ = build_obsdata_host(df1, np.linspace(0, df1["time"].max(), 288),
                                 spec1.post_snames)
    tf1, obs1 = compact_observation_grid(
        obs1, np.linspace(0, df1["time"].max(), 288))
    y01 = np.array([df1.loc["H"].iloc[0]["abundance"], 0.0,
                    df1.loc["V"].iloc[0]["abundance"]])
    pf_fw0 = pmmh_framework()
    pf_spec = pf_fw0._spec
    paths = slice_paths(framework)
    rob_fw = robertson_framework()
    fa = forcing_frameworks(framework, pmmh_framework)
    lf = limits_frameworks()

    # -- 2. build -------------------------------------------------------------
    phase("build")
    from concurrent.futures import ThreadPoolExecutor
    shutil.rmtree(build.BUILD_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    demo_sc = fw_scoring(fw)
    # the limits phases' libraries first: the 42-state chain's (its
    # kvaerno3 library takes minutes) and the SDE libraries
    builds = (limits_builds(lf) + [(spec, (), False, [demo_sc]),
               (spec, (spec1,), False, [demo_sc, cuda_mh.scoring(
                   cuda_mh._build_plan(spec1, obs1, tf1, 1))]),
               (pf_spec, (), True, [fw_scoring(pf_fw0)])]
              + scoring_builds(pf_fw0) + path_builds(paths)
              # the stiff path's libraries: the kvaerno3 instantiations
              + [(spec, (), False, [demo_sc], True),
                 (rob_fw._spec, (), False, [fw_scoring(rob_fw)], True),
                 # the PMMH path's Milstein instantiations
                 (pf_spec, (), True, [fw_scoring(pf_fw0)], False, True)]
              + forcing_builds(fa, spec, demo_sc, fw_scoring(pf_fw0)))
    # eight nvcc processes at once, the SDE libraries (their five
    # pf_kernel instantiations take 1-2 minutes each) submitted first
    with ThreadPoolExecutor(8) as ex:
        futs = {i: ex.submit(build.load_kernels, *a[:3], scoring=a[3],
                             stiff=a[4] if len(a) > 4 else False,
                             milstein=a[5] if len(a) > 5 else False,
                             wide=a[6] if len(a) > 6 else False)
                for i, a in sorted(enumerate(builds),
                                   key=lambda x: (x[0] >= 5, not x[1][2]))}
        libs = [futs[i].result() for i in range(len(builds))]
    build_s = time.perf_counter() - t0
    logs = ""
    labels = (["42-state chain, stiff (kvaerno3)", "42-state chain",
               "Lotka-Volterra",
               "Lotka-Volterra (wide: over 32 rungs)",
               "chemostat (wide: over 8 experiments)"]
              + ["zero_i", "zero_i + one_i (joint)", "GBM SDE"]
              + [f"zero_i {scoring_id(c)}" for c in SCORING]
              + [f"GBM SDE {scoring_id(c)}" for c in PF_SCORING]
              + [f"path ({k})" for k in "abcde"]
              + ["zero_i, stiff (kvaerno3)", "Robertson, stiff (kvaerno3)",
                 "GBM SDE (Milstein)", "forced zero_i",
                 "forced zero_i, stiff (kvaerno3)",
                 "zero_i + forced zero_i (joint)", "forced GBM SDE",
                 "zero_i, mu a 2-vector"])
    for label, lib in zip(labels, libs):
        log = open(os.path.join(os.path.dirname(lib._name),
                                "nvcc.log")).read()
        logs += log
        print(f"library for {label}:")
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                print(f"kernel {m.group(1)}")
            elif "seconds" in line or "registers" in line \
                    or "stack" in line:
                print(line.strip())
    for name in ("survey_kernel", "mh_kernel", "ens_kernel", "pt_kernel",
                 "joint_kernel", "pf_kernel"):
        if name not in logs:
            fail(f"build: {name} is missing from nvcc.log")
    print(f"build seconds ({len(builds)} libraries, eight at a time): "
          f"{build_s:.3f}", flush=True)

    # -- 3. kernel versus twin --------------------------------------------
    phase("survey kernel vs twin")
    n_draws = 4096
    draws = fw._theta_from_df(fw._lhs_samples(n_draws)).astype(np.float32)
    th = torch.as_tensor(draws, device=dev)
    plan = cuda_mh._build_plan(spec, obs, tf, 4)
    chi_k = cuda_mh.survey_fused(spec, obs, tf, y0, th, substeps=4)
    torch.cuda.synchronize()
    chi_t = cuda_mh.survey_plain(spec, plan, y0, th.t().contiguous())
    torch.cuda.synchronize()
    ck, ct = chi_k.cpu().numpy(), chi_t.cpu().numpy()
    fin = np.isfinite(ct)
    compare_chi("survey", ck, ct)
    print(f"survey: {fin.sum()}/{n_draws} finite", flush=True)

    phase("MH kernel vs twin")
    C, nits = 1024, 200
    order = np.argsort(np.where(fin, ct, np.inf))
    seeds = draws[order[np.arange(CHAINS) % max(fin.sum(), 1)]]
    th0 = torch.as_tensor(seeds[:C], device=dev)
    seed = 11
    walk = (0.05,) * 3
    k = cuda_mh.metropolis_hastings_fused(spec, obs, tf, y0, th0, seed,
                                          nits=nits, burnin=0, substeps=4)
    torch.cuda.synchronize()
    tw = cuda_mh.mh_plain(spec, plan, y0, th0.t().contiguous(), seed,
                          nits=nits, burnin=0, walk=walk,
                          walked=(True,) * 3, num=3)
    torch.cuda.synchronize()
    rec_k = [k.theta.permute(1, 2, 0), k.chi.t(), k.rsquared.t(),
             k.aic.t(), k.acceptance_ratio.t()]
    compare_records("MH", rec_k, tw, nits)
    rounds = rounds_of(accept_steps(tw[4].cpu().numpy(), nits))
    print(f"MH: {C} chains x {nits} iterations, mean acceptance "
          f"{float(rec_k[4][-1].mean()):.4f}, the kernel's rounds by the "
          f"iterations they complete {dict(sorted(rounds.items()))}",
          flush=True)

    phase("ensemble kernel vs twin")
    W, tile, mask = 2048, 1024, (1.0, 1.0, 1.0)
    e_nits = 50
    start = torch.as_tensor(np.ascontiguousarray(cuda_mh.ensemble_init(
        seeds[:W], seed, tile, mask, 0.01).T), device=dev)
    ens_kw = dict(tile=tile, nits=e_nits, burnin=0, a=2.0, walk=mask,
                  walked=(True,) * 3, num=3, W0=W)
    rec_k = cuda_mh.ensemble_launcher(spec, plan, y0, "dopri5", start, seed,
                                      **ens_kw)()
    torch.cuda.synchronize()
    rec_t = cuda_mh.ensemble_plain(spec, plan, y0, start, seed, **ens_kw)
    torch.cuda.synchronize()
    compare_records("ensemble", rec_k, rec_t, e_nits)
    print(f"ensemble: {W} walkers ({W // tile} ensembles) x {e_nits} "
          f"iterations in one device launch, mean acceptance "
          f"{float(rec_k[4][-1].mean()):.4f}", flush=True)
    # the same run on 7 blocks of 32 threads: 1,024 columns, 4-5 a thread
    rec_k = cuda_mh.ensemble_launcher(spec, plan, y0, "dopri5", start, seed,
                                      blocks=7, **ens_kw)()
    torch.cuda.synchronize()
    compare_records("ensemble (7 blocks, columns looped)", rec_k, rec_t,
                    e_nits)

    phase("PT kernel vs twin")
    # the main path's ladder, then 3 rungs (an idle lane in each chain's
    # group of 4 lanes) and 8 (a full group), on 1000 chains so the last
    # block of 128 threads is part empty
    for temps, n_c, n_it in (
            (TEMPS, C, 100), ((1.0, 2.0, 4.0), 1000, 60),
            (tuple(2.0 ** (k / 2) for k in range(8)), 1000, 60)):
        th0 = torch.as_tensor(seeds[:n_c], device=dev).t().contiguous()
        sc, bt, db = cuda_pt.ladder_constants(temps, 0.05, mask)
        pt_kw = dict(nits=n_it, burnin=0, scales=sc, walked=(True,) * 3,
                     betas=bt, dbetas=db, swap_every=1, num=3)
        rec_k = cuda_pt.pt_launcher(spec, plan, y0, "dopri5", th0, seed,
                                    **pt_kw)()
        torch.cuda.synchronize()
        rec_t = cuda_pt.pt_plain(spec, plan, y0, th0, seed, **pt_kw)
        torch.cuda.synchronize()
        compare_records(f"PT {len(temps)} rungs", rec_k, rec_t, n_it)
        att = cuda_pt.swap_attempts(n_it, 1, 1)[0]
        print(f"PT: {n_c} chains x {len(temps)} rungs x {n_it} iterations, "
              f"mean cold acceptance {float(rec_k[4][-1].mean()):.4f}, mean "
              f"cold swap rate {float(rec_k[5][-1].mean()) / att:.4f}",
              flush=True)
    scales, betas, dbetas = cuda_pt.ladder_constants(TEMPS, 0.05, mask)

    phase("joint kernel vs twin: zero_i + one_i")
    hspecs, hidx = [spec, spec1], [(2, 0, 1), (3, 0, 1, 4)]
    hplans = [cuda_mh._build_plan(spec, obs, tf, 4),
              cuda_mh._build_plan(spec1, obs1, tf1, 4)]
    hth0 = torch.as_tensor((np.array([2.4e-8, 22.0, 0.6, 0.6, 1.2])
                            * np.exp(np.random.default_rng(3).normal(
                                0, 0.05, (256, 5)))).astype(np.float32).T
                           .copy(), device=dev)
    hkw = dict(nits=20, burnin=0, walk=(0.05,) * 5, walked=(True,) * 5)
    rec_k = cuda_joint.joint_launcher(hspecs, hplans, [y0, y01], hidx,
                                      "dopri5", hth0, seed, **hkw)()
    torch.cuda.synchronize()
    rec_t = cuda_joint.joint_plain(hspecs, hplans, [y0, y01], hidx, hth0,
                                   seed, **hkw)
    torch.cuda.synchronize()
    compare_records("joint (zero_i + one_i)", rec_k, rec_t, 20,
                    labels=("theta", "chi", "chi parts", "ar"))
    print(f"joint, two models: 256 chains x 20 iterations, mean acceptance "
          f"{float(rec_k[3][-1].mean()):.4f}", flush=True)
    pair_th0 = hth0
    # K = 3 (blocks of three warps) on 1,000 chains, so the last block of 32
    # holds 8: a third experiment, zero_i on the demo data with its own mu
    hspecs.append(spec)
    hidx.append((5, 0, 1))
    hplans.append(cuda_mh._build_plan(spec, obs, tf, 4))
    hth0 = torch.as_tensor((np.array([2.4e-8, 22.0, 0.6, 0.6, 1.2, 0.6])
                            * np.exp(np.random.default_rng(4).normal(
                                0, 0.05, (1000, 6)))).astype(np.float32).T
                           .copy(), device=dev)
    hkw = dict(nits=20, burnin=0, walk=(0.05,) * 6, walked=(True,) * 6)
    rec_k = cuda_joint.joint_launcher(hspecs, hplans, [y0, y01, y0], hidx,
                                      "dopri5", hth0, seed, **hkw)()
    torch.cuda.synchronize()
    rec_t = cuda_joint.joint_plain(hspecs, hplans, [y0, y01, y0], hidx, hth0,
                                   seed, **hkw)
    torch.cuda.synchronize()
    compare_records("joint (K = 3, 1,000 chains)", rec_k, rec_t, 20,
                    labels=("theta", "chi", "chi parts", "ar"))
    print(f"joint, three experiments: 1000 chains x 20 iterations, mean "
          f"acceptance {float(rec_k[3][-1].mean()):.4f}", flush=True)

    phase("ensemble and joint kernels vs twin: plans above 48 KB")
    # at substeps 100 (1,700 Dopri5 steps a solve) and 50 (850) the plan
    # tables outgrow the 48 KB that the kernels stage in shared memory, so
    # both read them from global memory
    big_plan = cuda_mh._build_plan(spec, obs, tf, 100)
    big_bytes = sum(a.nbytes for a in cuda_mh.plan_tables(spec, big_plan,
                                                          y0, "dopri5"))
    jbig_plans = [cuda_mh._build_plan(spec, obs, tf, 50),
                  cuda_mh._build_plan(spec1, obs1, tf1, 50)]
    jbig_bytes = sum(a.nbytes for a in cuda_joint.joint_tables(
        hspecs[:2], jbig_plans, [y0, y01], hidx[:2], "dopri5")[:2])
    if min(big_bytes, jbig_bytes) <= 48 * 1024:
        fail(f"plans of {big_bytes} and {jbig_bytes} bytes fit in 48 KB")
    start = torch.as_tensor(np.ascontiguousarray(cuda_mh.ensemble_init(
        seeds[:512], seed, 256, mask, 0.01).T), device=dev)
    big_kw = dict(tile=256, nits=3, burnin=0, a=2.0, walk=mask,
                  walked=(True,) * 3, num=3, W0=512)
    rec_k = cuda_mh.ensemble_launcher(spec, big_plan, y0, "dopri5", start,
                                      seed, **big_kw)()
    torch.cuda.synchronize()
    rec_t = cuda_mh.ensemble_plain(spec, big_plan, y0, start, seed, **big_kw)
    torch.cuda.synchronize()
    compare_records(f"ensemble (plan of {big_bytes} bytes)", rec_k, rec_t, 3)
    hkw = dict(nits=3, burnin=0, walk=(0.05,) * 5, walked=(True,) * 5)
    rec_k = cuda_joint.joint_launcher(hspecs[:2], jbig_plans, [y0, y01],
                                      hidx[:2], "dopri5", pair_th0, seed,
                                      **hkw)()
    torch.cuda.synchronize()
    rec_t = cuda_joint.joint_plain(hspecs[:2], jbig_plans, [y0, y01],
                                   hidx[:2], pair_th0, seed, **hkw)
    torch.cuda.synchronize()
    compare_records(f"joint (plans of {jbig_bytes} bytes)", rec_k, rec_t, 3,
                    labels=("theta", "chi", "chi parts", "ar"))
    print(f"plans above 48 KB: the ensemble on 512 walkers ({big_bytes} "
          f"bytes), the joint pair on 256 chains ({jbig_bytes} bytes), x 3 "
          "iterations each", flush=True)

    phase("priors: the MH, ensemble, PT and joint kernels vs twin, four "
          "assignments over the ten in-kernel families")
    # start points around the fit, so the tight priors let chains accept
    near = (np.array(CENTRE) * np.exp(np.random.default_rng(9).normal(
        0, 0.05, (2048, 3)))).astype(np.float32)
    near_t = torch.as_tensor(near.T.copy(), device=dev)
    jnear = torch.as_tensor((np.array([2.4e-8, 24.0, 0.6, 0.6, 1.2])
                             * np.exp(np.random.default_rng(10).normal(
                                 0, 0.05, (256, 5)))).astype(np.float32).T
                            .copy(), device=dev)
    P_NITS = 12      # iterations a kernel: the twins are launch-bound
    pri_walk = (0.1,) * 3
    for label, pri in prior_sets().items():
        table = prior_table(pri)
        mh_kw = dict(nits=P_NITS, burnin=0, walk=pri_walk,
                     walked=(True,) * 3, num=3, prior=table)
        rec_k = cuda_mh.mh_launcher(spec, plan, y0, "dopri5",
                                    near_t[:, :1024].contiguous(), seed,
                                    **mh_kw)()
        torch.cuda.synchronize()
        rec_t = cuda_mh.mh_plain(spec, plan, y0,
                                 near_t[:, :1024].contiguous(), seed, **mh_kw)
        torch.cuda.synchronize()
        compare_records(f"MH, priors {label}", rec_k, rec_t, P_NITS)
        acc_mh = float(rec_k[4][-1].mean())
        start = torch.as_tensor(np.ascontiguousarray(cuda_mh.ensemble_init(
            near, seed, 1024, mask, 0.01).T), device=dev)
        e_kw = dict(tile=1024, nits=10, burnin=0, a=2.0, walk=mask,
                    walked=(True,) * 3, num=3, W0=2048, prior=table)
        rec_k = cuda_mh.ensemble_launcher(spec, plan, y0, "dopri5", start,
                                          seed, **e_kw)()
        torch.cuda.synchronize()
        rec_t = cuda_mh.ensemble_plain(spec, plan, y0, start, seed, **e_kw)
        torch.cuda.synchronize()
        compare_records(f"ensemble, priors {label}", rec_k, rec_t, 10)
        acc_ens = float(rec_k[4][-1].mean())
        sc, bt, db = cuda_pt.ladder_constants(TEMPS, 0.1, mask)
        p_kw = dict(nits=P_NITS, burnin=0, scales=sc, walked=(True,) * 3,
                    betas=bt, dbetas=db, swap_every=1, num=3, prior=table)
        rec_k = cuda_pt.pt_launcher(spec, plan, y0, "dopri5",
                                    near_t[:, :1024].contiguous(), seed,
                                    **p_kw)()
        torch.cuda.synchronize()
        rec_t = cuda_pt.pt_plain(spec, plan, y0,
                                 near_t[:, :1024].contiguous(), seed, **p_kw)
        torch.cuda.synchronize()
        compare_records(f"PT 4 rungs, priors {label}", rec_k, rec_t,
                        P_NITS)
        acc_pt = float(rec_k[4][-1].mean())
        # the zero_i + one_i pair: joint slots phi, beta, mu (zero_i), mu
        # (one_i), one_i's fourth parameter (no prior)
        jtab = prior_table((pri[1], pri[2], pri[0], pri[0], None))
        j_kw = dict(nits=P_NITS, burnin=0, walk=(0.1,) * 5,
                    walked=(True,) * 5, prior=jtab)
        rec_k = cuda_joint.joint_launcher(hspecs[:2], hplans[:2], [y0, y01],
                                          hidx[:2], "dopri5", jnear, seed,
                                          **j_kw)()
        torch.cuda.synchronize()
        rec_t = cuda_joint.joint_plain(hspecs[:2], hplans[:2], [y0, y01],
                                       hidx[:2], jnear, seed, **j_kw)
        torch.cuda.synchronize()
        compare_records(f"joint (zero_i + one_i), priors {label}", rec_k,
                        rec_t, P_NITS,
                        labels=("theta", "chi", "chi parts", "ar"))
        print(f"priors {label}: MH 1024 chains x {P_NITS}, ensemble 2048 "
              f"walkers x 10, PT 1024 x 4 rungs x {P_NITS}, joint 256 x "
              f"{P_NITS}: mean "
              f"acceptance {acc_mh:.4f}, {acc_ens:.4f}, {acc_pt:.4f}, "
              f"{float(rec_k[3][-1].mean()):.4f}", flush=True)
        if min(acc_mh, acc_ens, acc_pt) <= 0.0:
            fail(f"priors {label}: a kernel's chains never accepted")

    # -- 4. the main paths --------------------------------------------------
    swap_log = io.StringIO()
    handler = logging.StreamHandler(swap_log)
    pkg_log = logging.getLogger("odelib_tpu_torch")
    pkg_log.addHandler(handler)
    pkg_log.setLevel(logging.INFO)
    kernel_of = {"mh": "metropolis_hastings_fused",
                 "ensemble": "ensemble_fused",
                 "pt": "parallel_tempering_fused"}
    runs = {}
    # the ensemble main path's own inputs, for the comparison after it
    ens_in = {}
    ens_arm = dispatch._ARMS["cuda:ensemble"]

    def recording_arm(fw_, theta0, cfg):
        ens_in.update(theta0=np.asarray(theta0, np.float32), cfg=cfg,
                      seed=int(fw_.random_seed) + cfg.seed_offset)
        return ens_arm(fw_, theta0, cfg)
    dispatch._ARMS["cuda:ensemble"] = recording_arm
    # and the PT main path's, captured where the PT arm calls the wrapper
    pt_in = {}
    pt_fused = cuda_pt.parallel_tempering_fused

    def recording_pt(*args, **kw):
        pt_in.update(args=args, kw=kw)
        return pt_fused(*args, **kw)
    cuda_pt.parallel_tempering_fused = recording_pt
    # and the MH path's survey and MH calls; the MH call's host part, its
    # kernel's device time and the allocations it made (the chains stage)
    sv_in, mh_in, mh_probe = {}, {}, {}
    sv_fused = cuda_mh.survey_fused
    mh_fused = cuda_mh.metropolis_hastings_fused
    current = [None]

    def recording_survey(*args, **kw):
        sv_in[current[0]] = (args, kw)
        return sv_fused(*args, **kw)

    def recording_mh(*args, **kw):
        """The MH path's call, with its host part split at the library
        load, the plan upload and the launch (times on the host clock from
        the call's entry) and its process CPU time."""
        mh_in.update(args=args, kw=kw)
        marks = {}
        real_load, real_plan = build.load_kernels, cuda_mh._device_plan
        patched = []

        def timed(name, fn):
            def run(*a, **k):
                marks[name] = time.perf_counter()
                res = fn(*a, **k)
                marks[name + " done"] = time.perf_counter()
                return res
            return run

        def load(*a, **k):
            lib = timed("library", real_load)(*a, **k)
            patched.append((lib, lib.odelib_mh))
            lib.odelib_mh = timed("launch", lib.odelib_mh)
            return lib
        build.load_kernels = load
        cuda_mh._device_plan = timed("plan", real_plan)
        m0 = torch.cuda.memory_stats()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        cpu0, t0 = time.process_time(), time.perf_counter()
        e0.record()
        try:
            res = mh_fused(*args, **kw)
        finally:
            build.load_kernels, cuda_mh._device_plan = real_load, real_plan
            for lib, fn in patched:
                lib.odelib_mh = fn
        e1.record()
        t1, cpu1 = time.perf_counter(), time.process_time()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        m1 = torch.cuda.memory_stats()
        points = [t0] + [marks.get(k) for k in (
            "library", "library done", "plan", "plan done", "launch",
            "launch done")] + [t1]
        names = ("checks and RHS trace", "library", "to the plan", "plan",
                 "walk table and record allocation", "launch", "return")
        split = ("not split: the call did not load the library, upload the "
                 "plan and launch" if None in points else ", ".join(
                     f"{k} {b - a:.6f} s"
                     for k, a, b in zip(names, points, points[1:])))
        mh_probe.update(
            host_s=t1 - t0, cpu_s=cpu1 - cpu0, wait_s=t2 - t1,
            device_s=e0.elapsed_time(e1) / 1e3, split=split,
            cuda_mallocs=m1.get("num_device_alloc", 0)
            - m0.get("num_device_alloc", 0),
            reserved_mb=(m1["reserved_bytes.all.current"]
                         - m0["reserved_bytes.all.current"]) / 2 ** 20)
        return res
    cuda_mh.survey_fused = recording_survey
    cuda_mh.metropolis_hastings_fused = recording_mh
    for sampler in ("mh", "ensemble", "pt"):
        phase(f"main path: ModelFramework(...).MCMC(sampler={sampler!r})")
        fw = framework()
        out = io.StringIO()
        extra = dict(temperatures=TEMPS) if sampler == "pt" else {}
        current[0] = sampler
        cuda_mh.reset_launch_counts()
        torch.cuda.synchronize()
        GC_SPANS.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            post = fw.MCMC(chain_inits=CHAINS, iterations_per_chain=NITS,
                           fitsurvey_samples=1000, sd_fitdistance=6.0,
                           sampler=sampler, print_report=True, profile=True,
                           **extra)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(cuda_mh.LAUNCHES)
        print(out.getvalue())
        print(f"MCMC({sampler}) wall seconds: {wall_s:.3f}; launches "
              f"{launches}; stages " + ", ".join(
                  f"{k} {v:.3f} s" for k, v in fw.last_profile.items()))
        print(f"MCMC({sampler}) " + gc_report(t0, fw.last_profile))
        if sampler == "mh":
            print("MCMC(mh) chains stage: metropolis_hastings_fused's host "
                  f"part {mh_probe['host_s']:.6f} s ({mh_probe['split']}; "
                  f"process CPU time {mh_probe['cpu_s']:.6f} s), the "
                  f"device's {mh_probe['device_s']:.6f} s from its entry to "
                  f"its kernel's end, waited {mh_probe['wait_s']:.6f} s after "
                  f"it returned; {mh_probe['cuda_mallocs']} cudaMalloc "
                  f"calls, {mh_probe['reserved_mb']:.1f} MB more reserved")
        cols = ["mu", "phi", "beta", "chi", "rsquared", "aic", "iteration",
                "acceptance_ratio", "chain#", "all_rejected"]
        if list(post.columns) != cols:
            fail(f"{sampler}: posterior columns {list(post.columns)}")
        if len(post) != CHAINS * (NITS - 1 - BURNIN) \
                or post["chain#"].nunique() != CHAINS:
            fail(f"{sampler}: posterior has {len(post)} rows")
        finite = float(np.isfinite(post.chi.to_numpy()).mean())
        last = post[post.iteration == post.iteration.max()]
        mean_acc = float(last.acceptance_ratio.mean())
        zeros = {c: float((last[c] == 0.0).mean()) for c in cols[:3]}
        print(f"{sampler}: finite chi fraction {finite}, mean final "
              f"acceptance {mean_acc:.4f}, final rows exactly 0: {zeros}")
        if finite != 1.0:
            fail(f"{sampler}: finite chi fraction {finite}")
        lo, hi = BANDS[sampler]
        if not lo <= mean_acc <= hi:
            fail(f"{sampler}: mean final acceptance {mean_acc} outside "
                 f"[{lo}, {hi}]")
        if "Fitting Report" not in out.getvalue():
            fail(f"{sampler}: the Fitting Report did not print")
        if launches["survey_fused"] != 1:
            fail(f"{sampler}: survey_fused was not launched once: "
                 f"{launches}")
        if launches[kernel_of[sampler]] != 1:
            fail(f"{sampler}: {kernel_of[sampler]} was not launched once: "
                 f"{launches}")
        if not isinstance(post, pd.DataFrame):
            fail(f"{sampler}: MCMC did not return a DataFrame")
        if sampler == "pt":
            m = re.findall(r"swap acceptance ([0-9.]+)", swap_log.getvalue())
            rate = float(m[-1]) if m else float("nan")
            print(f"pt: mean cold-pair swap acceptance {rate}")
            if not 0.0 < rate <= 1.0:
                fail(f"pt: swap rate {rate} not in (0, 1]")
        runs[sampler] = (wall_s, launches, dict(fw.last_profile))
    pkg_log.removeHandler(handler)
    dispatch._ARMS["cuda:ensemble"] = ens_arm
    cuda_pt.parallel_tempering_fused = pt_fused
    cuda_mh.survey_fused = sv_fused
    cuda_mh.metropolis_hastings_fused = mh_fused

    phase("main path: JointFit({'a': zero_i, 'b': zero_i perturbed}, "
          "shared=['phi', 'beta']).MCMC()")
    jf = joint_fit()
    joint_in = {}
    joint_fused = cuda_joint.joint_metropolis_hastings_fused

    def recording_joint(*args, **kw):
        joint_in.update(args=args, kw=kw)
        return joint_fused(*args, **kw)
    cuda_joint.joint_metropolis_hastings_fused = recording_joint
    out = io.StringIO()
    cuda_mh.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        jpost = jf.MCMC(chain_inits=CHAINS, iterations_per_chain=NITS,
                        fitsurvey_samples=1000, substeps=4,
                        backend="pallas", profile=True)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(cuda_mh.LAUNCHES)
    cuda_joint.joint_metropolis_hastings_fused = joint_fused
    print(out.getvalue())
    print(f"JointFit.MCMC wall seconds: {wall_s:.3f}; launches {launches}; "
          "stages " + ", ".join(f"{k} {v:.3f} s"
                                for k, v in jf.last_profile.items()))
    jcols = ["phi", "beta", "a:mu", "b:mu", "chi", "chi:a", "chi:b",
             "iteration", "acceptance_ratio", "chain#", "all_rejected"]
    if list(jpost.columns) != jcols:
        fail(f"joint: posterior columns {list(jpost.columns)}")
    if len(jpost) != CHAINS * (NITS - 1 - BURNIN) \
            or jpost["chain#"].nunique() != CHAINS:
        fail(f"joint: posterior has {len(jpost)} rows")
    finite = float(np.isfinite(jpost.chi.to_numpy()).mean())
    last = jpost[jpost.iteration == jpost.iteration.max()]
    mean_acc = float(last.acceptance_ratio.mean())
    print(f"joint: D = {jf.dim}, idx maps {jf._idx_maps}; finite chi "
          f"fraction {finite}, mean final acceptance {mean_acc:.4f}")
    if finite != 1.0:
        fail(f"joint: finite chi fraction {finite}")
    if not BANDS["joint"][0] <= mean_acc <= BANDS["joint"][1]:
        fail(f"joint: mean final acceptance {mean_acc} outside "
             f"{BANDS['joint']}")
    if not (jpost["chi"].to_numpy() == (jpost["chi:a"].to_numpy()
                                        + jpost["chi:b"].to_numpy())).all():
        fail("joint: chi is not chi:a + chi:b")
    if "Joint Fitting Report" not in out.getvalue():
        fail("joint: the Joint Fitting Report did not print")
    if launches["joint_metropolis_hastings_fused"] != 1:
        fail(f"joint: the joint kernel was not launched once: {launches}")
    runs["joint"] = (wall_s, launches, dict(jf.last_profile))

    phase("main path: ModelFramework(GBM, diffusion=...).MCMC("
          "sampler='pmmh')")
    pf_in = {}
    pf_fused = cuda_pf.pmmh_fused

    def recording_pf(*args, **kw):
        pf_in.update(args=args, kw=kw)
        return pf_fused(*args, **kw)
    cuda_pf.pmmh_fused = recording_pf
    pfw = pmmh_framework()
    pf_plan = cuda_mh._build_plan(pfw._spec, pfw._obsdata_fit_host,
                                  pfw._times_fit, PF_SUB)
    print(f"PMMH compact grid {[float(t) for t in pfw._times_fit]}: "
          f"{len(pf_plan.step_ts)} Euler steps of h = "
          f"{pf_plan.step_ts[0][1]}, "
          f"{len(cuda_pf.obs_grid_indices(pf_plan))} observation blocks")
    out = io.StringIO()
    cuda_mh.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        ppost = pfw.MCMC(sampler="pmmh", chain_inits=PF_CHAINS,
                         iterations_per_chain=PF_NITS,
                         fitsurvey_samples=1000, n_particles=PF_K,
                         sde_substeps=PF_SUB, rwalk_std=0.4, use_priors=True,
                         adapt_proposal=True, target_accept=0.3,
                         adapt_rate=0.15, profile=True)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(cuda_mh.LAUNCHES)
    cuda_pf.pmmh_fused = pf_fused
    print(out.getvalue())
    print(f"MCMC(pmmh) wall seconds: {wall_s:.3f}; launches {launches}; "
          "stages " + ", ".join(f"{k} {v:.3f} s"
                                for k, v in pfw.last_profile.items()))
    pcols = ["mu", "chi", "rsquared", "aic", "iteration", "acceptance_ratio",
             "chain#", "all_rejected"]
    pf_R = PF_NITS - 1 - PF_NITS // 2
    if list(ppost.columns) != pcols or len(ppost) != PF_CHAINS * pf_R:
        fail(f"pmmh: posterior {list(ppost.columns)}, {len(ppost)} rows")
    if not ppost["rsquared"].isna().all():
        fail("pmmh: rsquared is not NaN")
    finite = float(np.isfinite(ppost.chi.to_numpy()).mean())
    ar = ppost.acceptance_ratio.to_numpy().reshape(PF_CHAINS, pf_R)
    its = np.arange(1, PF_NITS)[PF_NITS // 2:].astype(float)
    frozen = float(np.mean((ar[:, -1] * its[-1] - ar[:, 0] * its[0])
                           / (its[-1] - its[0])))
    z = np.log(ppost.mu.to_numpy(np.float64))
    exact_mean, exact_std = kalman_posterior(*gbm_data())
    print(f"pmmh: finite chi fraction {finite}, mean final acceptance "
          f"{float(ar[:, -1].mean()):.4f}, frozen-phase acceptance "
          f"{frozen:.4f}; log mu posterior mean {z.mean():.4f} (exact "
          f"{exact_mean:.4f}), std {z.std():.4f} (exact {exact_std:.4f})")
    if finite != 1.0:
        fail(f"pmmh: finite chi fraction {finite}")
    if not 0.15 <= frozen <= 0.5:
        fail(f"pmmh: frozen-phase acceptance {frozen} outside [0.15, 0.5]")
    if not abs(z.mean() - exact_mean) < 0.02 \
            or not abs(z.std() - exact_std) <= 0.05 * exact_std:
        fail("pmmh: the log mu posterior misses the exact one")
    if "Fitting Report" not in out.getvalue():
        fail("pmmh: the Fitting Report did not print")
    if launches["pmmh_fused"] != 1:
        fail(f"pmmh: the PMMH kernel was not launched once: {launches}")
    runs["pmmh"] = (wall_s, launches, dict(pfw.last_profile))

    # the slice's path: in-kernel priors (the demo's lognormal priors) and
    # the schedule calibrated from each run's seeds
    calib = []
    real_calibrate = schedule.calibrate_substeps

    def recording_calibrate(*args, **kw):
        t0 = time.perf_counter()
        out = real_calibrate(*args, **kw)
        torch.cuda.synchronize()
        calib.append(dict(args=args, kw=kw, sched=out,
                          secs=time.perf_counter() - t0))
        return out
    schedule.calibrate_substeps = recording_calibrate
    auto_runs = {}
    # the wrappers' inputs on these paths, for the comparisons after them
    wrappers = {"mh": (cuda_mh, "metropolis_hastings_fused"),
                "ensemble": (cuda_mh, "ensemble_fused"),
                "pt": (cuda_pt, "parallel_tempering_fused"),
                "joint": (cuda_joint, "joint_metropolis_hastings_fused")}
    auto_in = {k: {} for k in wrappers}
    for sampler in ("mh", "ensemble", "pt"):
        phase(f"main path: ModelFramework(...).MCMC(sampler={sampler!r}, "
              "use_priors=True, substeps='auto')")
        fw = framework()
        out = io.StringIO()
        extra = dict(temperatures=TEMPS) if sampler == "pt" else {}
        cuda_mh.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), \
                recording(*wrappers[sampler], auto_in[sampler]):
            post = fw.MCMC(chain_inits=CHAINS, iterations_per_chain=NITS,
                           fitsurvey_samples=1000, sd_fitdistance=6.0,
                           sampler=sampler, use_priors=True, substeps="auto",
                           print_report=True, profile=True, **extra)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(cuda_mh.LAUNCHES)
        sched = fw._auto_schedule
        if sched != calib[-1]["sched"]:
            fail(f"{sampler}: the cached schedule is not the calibrated one")
        print(f"MCMC({sampler}, priors, auto) wall seconds: {wall_s:.3f}; "
              f"launches {launches}; stages " + ", ".join(
                  f"{k} {v:.3f} s" for k, v in fw.last_profile.items()))
        print(f"MCMC({sampler}, priors, auto): calibrated schedule "
              f"{list(sched)}, schedule_cost {schedule.schedule_cost(sched)}"
              f" RHS steps a solve against {4 * (len(tf) - 1)} at substeps=4;"
              f" calibration call {calib[-1]['secs']:.3f} s on "
              f"{min(len(calib[-1]['args'][3]), 256)} of the "
              f"{len(calib[-1]['args'][3])} seeds")
        finite = float(np.isfinite(post.chi.to_numpy()).mean())
        last = post[post.iteration == post.iteration.max()]
        mean_acc = float(last.acceptance_ratio.mean())
        zeros = {c: float((last[c] == 0.0).mean()) for c in
                 ("mu", "phi", "beta")}
        print(f"{sampler} (priors, auto): finite chi fraction {finite}, mean "
              f"final acceptance {mean_acc:.4f}, final rows exactly 0: "
              f"{zeros}")
        if sampler == "ensemble":
            print(f"ensemble with the prior on: {100 * zeros['mu']:.2f} % of "
                  f"the walkers end at mu = 0 (without it, phase 4 above)")
        if finite != 1.0:
            fail(f"{sampler} (priors): finite chi fraction {finite}")
        lo, hi = BANDS[sampler]
        if not lo <= mean_acc <= hi:
            fail(f"{sampler} (priors): mean final acceptance {mean_acc} "
                 f"outside [{lo}, {hi}]")
        if launches["survey_fused"] != 1 \
                or launches[kernel_of[sampler]] != 1:
            fail(f"{sampler} (priors): the survey and chain kernels were "
                 f"not launched once each: {launches}")
        auto_runs[sampler] = (fw, sched,
                              last[["mu", "phi", "beta"]].to_numpy(copy=True))
    schedule.calibrate_substeps = real_calibrate

    phase("main path: JointFit({'a', 'b'}).MCMC(use_priors=True, "
          "substeps='auto')")
    jf = joint_fit()
    out = io.StringIO()
    jpost_plain = jpost
    cuda_mh.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), \
            recording(*wrappers["joint"], auto_in["joint"]):
        jpost = jf.MCMC(chain_inits=CHAINS, iterations_per_chain=NITS,
                        fitsurvey_samples=1000, substeps="auto",
                        use_priors=True, profile=True)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(cuda_mh.LAUNCHES)
    finite = float(np.isfinite(jpost.chi.to_numpy()).mean())
    last = jpost[jpost.iteration == jpost.iteration.max()]
    mean_acc = float(last.acceptance_ratio.mean())
    print(f"JointFit.MCMC(priors) wall seconds: {wall_s:.3f}; launches "
          f"{launches}; stages " + ", ".join(
              f"{k} {v:.3f} s" for k, v in jf.last_profile.items()))
    # the same seeds and schedule as the joint main path: only the prior
    # differs
    moved = float((jpost.acceptance_ratio.to_numpy()
                   != jpost_plain.acceptance_ratio.to_numpy()).mean())
    last_plain = jpost_plain[jpost_plain.iteration
                             == jpost_plain.iteration.max()]
    print(f"joint (priors; 'auto' resolved to "
          f"{jf._device_args({'substeps': 'auto'})[6]}): finite chi "
          f"fraction {finite}, mean final acceptance {mean_acc:.6f} (without "
          f"priors {float(last_plain.acceptance_ratio.mean()):.6f}); the "
          f"prior changed the running acceptance in {100 * moved:.2f} % of "
          "the rows")
    if moved == 0.0:
        fail("joint (priors): the chains are those without priors")
    if finite != 1.0:
        fail(f"joint (priors): finite chi fraction {finite}")
    if not BANDS["joint"][0] <= mean_acc <= BANDS["joint"][1]:
        fail(f"joint (priors): mean final acceptance {mean_acc} outside "
             f"{BANDS['joint']}")
    if launches["joint_metropolis_hastings_fused"] != 1:
        fail(f"joint (priors): the joint kernel was not launched once: "
             f"{launches}")

    phase("calibration: calibrate_substeps on the card and on the CPU, the "
          "MH path's seeds")
    c_args, c_kw = calib[0]["args"], dict(calib[0]["kw"])
    c_kw.pop("device", None)
    t0 = time.perf_counter()
    on_card = schedule.calibrate_substeps(*c_args, device="cuda", **c_kw)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = schedule.calibrate_substeps(*c_args, device="cpu", **c_kw)
    cpu_s = time.perf_counter() - t0
    print(f"calibrated on the card {list(on_card)} in {card_s:.3f} s; on "
          f"the CPU {list(on_cpu)} in {cpu_s:.3f} s")
    if on_card != on_cpu or on_card != calib[0]["sched"]:
        fail("calibration: the card's schedule differs from the CPU's")

    phase("accuracy: chi on the calibrated schedule against the adaptive "
          "solve, the MH path's seeds and final draws")
    # as the JAX package's accuracy gate (tests/test_accuracy_gate.py): the
    # oracle is adaptive Dopri5 (rtol 1e-6, atol 1e-2) on the full
    # 288-point grid in float64, the fixed steps run on the compact grid,
    # and near the fit (chi < 500) they must agree to 1e-4
    fw_mh, sched_mh, final_mh = auto_runs["mh"]
    obs_full, _ = build_obsdata_host(fw_mh.df, fw_mh.times,
                                     spec.post_snames)
    gate = []
    for what, th64 in (
            ("seeds", auto_in["mh"]["args"][4].double()),
            ("final draws", torch.as_tensor(final_mh, dtype=torch.float64,
                                            device=dev))):
        oracle = chi_of_theta(spec, obs_full, th64, y0, fw_mh.times,
                              method="dopri5", rtol=1e-6, atol=1e-2,
                              max_steps=32768).cpu().numpy()
        for label, chi in (
                ("calibrated schedule, float64", chi_of_theta(
                    spec, obs, th64, y0, tf, method="fixed_dopri5",
                    substeps=sched_mh)),
                ("substeps=4, float64", chi_of_theta(
                    spec, obs, th64, y0, tf, method="fixed_dopri5",
                    substeps=4)),
                ("calibrated schedule, the survey kernel",
                 cuda_mh.survey_fused(spec, obs, tf, y0, th64.float(),
                                      substeps=sched_mh))):
            chi = chi.double().cpu().numpy()
            both = np.isfinite(oracle) & np.isfinite(chi)
            near = both & (oracle < 500.0)
            rel = np.abs(chi - oracle) / np.maximum(np.abs(oracle), 1.0)
            near_max = float(rel[near].max()) if near.any() else float("nan")
            if label == "calibrated schedule, float64":
                gate.append(near_max)
            print(f"accuracy, the MH path's {len(oracle)} {what}, {label}, "
                  f"against the adaptive solve: near the fit ({near.sum()} "
                  f"draws) max rel chi err {near_max:.3g}; all "
                  f"{both.sum()} finite: median {np.median(rel[both]):.3g}, "
                  f"p99 {np.percentile(rel[both], 99):.3g}, max "
                  f"{rel[both].max():.3g}; finiteness disagreements "
                  f"{int((np.isfinite(oracle) != np.isfinite(chi)).sum())}",
                  flush=True)
    if not all(g < 1e-4 for g in gate):
        fail(f"accuracy: the calibrated schedule's near-fit max rel chi "
             f"errors {gate} (no near-fit draw: nan) are not below 1e-4")

    phase("the prior-aware paths: kernels vs twins at their main paths' "
          "inputs (all chains, the demo's priors, calibrated schedules)")
    auto_err = {}
    for sampler, its in (("mh", 51), ("ensemble", 51), ("pt", 21),
                         ("joint", 51)):
        call = auto_in[sampler]
        kw = call["kw"]
        th0 = call["args"][5 if sampler == "joint" else 4]
        sub = kw["substeps_list" if sampler == "joint" else "substeps"]
        if th0.shape[0] != CHAINS or kw["priors"] is None:
            fail(f"{sampler} (priors): the main path ran {th0.shape[0]} "
                 f"chains with priors {kw['priors']}")
        auto_err[sampler], out = kernel_vs_twin_at(
            f"{sampler} (priors, substeps='auto'; main path's inputs)",
            getattr(*wrappers[sampler]), call, its)
        print(f"{sampler} with priors at its main path's inputs: all "
              f"{th0.shape[0]} chains x {its - 1} iterations, seed "
              f"{kw['seed']}, substeps {sub}, priors {kw['priors']}, mean "
              f"acceptance {float(out.acceptance_ratio[:, -1].mean()):.4f}",
              flush=True)

    phase("survey and MH kernels vs twin at the MH main path's inputs")
    sv_args, sv_kw = sv_in["mh"]
    sv_th = sv_args[4]
    survey_err = survey_vs_twin("survey (main path's inputs)",
                                {"args": sv_args, "kw": sv_kw})
    print(f"survey at the main path's inputs: survey_fused on its "
          f"{sv_th.shape[0]} draws, {sv_kw['stepper']}, substeps "
          f"{sv_kw['substeps']}", flush=True)
    if sv_th.shape[0] != 1000:
        fail(f"the MH main path surveyed {sv_th.shape[0]} draws, not 1000")
    m_spec, m_obs, m_tf, m_y0, m_th0 = mh_in["args"]
    mkw = mh_in["kw"]
    m_nits = 51
    m_plan = cuda_mh._build_plan(m_spec, m_obs, m_tf,
                                 cuda_mh._normalize_substeps(
                                     mkw["substeps"], len(m_tf) - 1))
    m_mask = [1.0] * m_th0.shape[1] if mkw["walk_mask"] is None \
        else [float(w) for w in mkw["walk_mask"]]
    m_run = dict(nits=m_nits, burnin=0,
                 walk=tuple(float(mkw["rwalk_std"]) * float(w)
                            for w in m_mask),
                 walked=tuple(float(w) != 0.0 for w in m_mask),
                 num=int(torch.count_nonzero(m_th0[0])),
                 stepper=mkw["stepper"])
    rec_t = cuda_mh.mh_plain(m_spec, m_plan, m_y0, m_th0.t().contiguous(),
                             mkw["seed"], **m_run)
    torch.cuda.synchronize()
    # all chains, then a prefix that is not a multiple of the 8 chains a
    # warp holds: its last warp is part empty, and each chain's stream is
    # keyed on its index, so its records are the full run's
    for n_c in (m_th0.shape[0], m_th0.shape[0] - 3):
        mout = cuda_mh.metropolis_hastings_fused(
            m_spec, m_obs, m_tf, m_y0, m_th0[:n_c], **{
                **mkw, "nits": m_nits, "burnin": 0})
        torch.cuda.synchronize()
        rec_k = [mout.theta.permute(1, 2, 0), mout.chi.t(),
                 mout.rsquared.t(), mout.aic.t(),
                 mout.acceptance_ratio.t()]
        err = compare_records(f"MH (main path's inputs, {n_c} chains)",
                              rec_k, [r[..., :n_c] for r in rec_t], m_nits)
        if n_c == m_th0.shape[0]:
            mh_err = err
    rounds = rounds_of(accept_steps(rec_t[4].cpu().numpy(), m_nits))
    print(f"MH at the main path's inputs: metropolis_hastings_fused on all "
          f"{m_th0.shape[0]} chains and on {m_th0.shape[0] - 3}, seed "
          f"{mkw['seed']}, {mkw['stepper']} x {m_nits - 1} iterations, mean "
          f"acceptance {float(rec_t[4][-1].mean()):.4f}; the kernel's rounds "
          f"by the iterations they complete {dict(sorted(rounds.items()))}",
          flush=True)
    if not (rounds[2] and rounds[3]):
        fail(f"MH: the main path's inputs gave rounds {dict(rounds)}: "
             "rounds of 2 and of 3 iterations must both occur")
    if m_th0.shape[0] != CHAINS:
        fail(f"MH main path ran {m_th0.shape[0]} chains, not {CHAINS}")

    phase("ensemble kernel vs twin at the main path's inputs")
    ens_th0, cfg, ens_seed = ens_in["theta0"], ens_in["cfg"], ens_in["seed"]
    ens_nits = 50
    tile_main = cfg.tile_chains or cuda_mh.pick_tile_chains(len(ens_th0))
    ens_walk = tuple(float(w) for w in cfg.mask)
    ens_sub = cuda_mh._normalize_substeps(cfg.substeps, len(tf) - 1)
    stepper = dispatch.fused_stepper(cfg.method)
    out = cuda_mh.ensemble_fused(
        spec, obs, tf, y0, torch.as_tensor(ens_th0, device=dev), ens_seed,
        nits=ens_nits, burnin=0, a=float(cfg.stretch_a), walk_mask=cfg.mask,
        substeps=cfg.substeps, stepper=stepper, tile_chains=cfg.tile_chains)
    torch.cuda.synchronize()
    rec_k = [out.theta.permute(1, 2, 0), out.chi.t(), out.rsquared.t(),
             out.aic.t(), out.acceptance_ratio.t()]
    ens_np = cuda_mh.ensemble_init(ens_th0, ens_seed, tile_main, ens_walk,
                                   0.01)
    ens_start = torch.as_tensor(np.ascontiguousarray(ens_np.T), device=dev)
    W_main = ens_start.shape[1]
    ens_main = dict(tile=tile_main, a=float(cfg.stretch_a), walk=ens_walk,
                    walked=tuple(w != 0.0 for w in ens_walk),
                    num=int(np.count_nonzero(ens_th0[0])), W0=len(ens_th0),
                    stepper=stepper)
    ens_plan = cuda_mh._build_plan(spec, obs, tf, ens_sub)
    rec_t = cuda_mh.ensemble_plain(spec, ens_plan, y0, ens_start, ens_seed,
                                   nits=ens_nits, burnin=0, **ens_main)
    torch.cuda.synchronize()
    ens_err = compare_records("ensemble (main path's inputs)", rec_k, rec_t,
                              ens_nits)
    print(f"ensemble at the main path's inputs: {len(ens_th0)} walkers "
          f"padded to {W_main} ({W_main // tile_main} ensembles of "
          f"{tile_main}), seed {ens_seed}, substeps {ens_sub}, {stepper} x "
          f"{ens_nits} iterations, mean acceptance "
          f"{float(rec_k[4][-1].mean()):.4f}", flush=True)
    if (len(ens_th0), tile_main, W_main) != (CHAINS, 4096, 12288):
        fail(f"ensemble main path ran {len(ens_th0)} walkers at tile "
             f"{tile_main} padded to {W_main}, not 10000 / 4096 / 12288")

    phase("PT kernel vs twin at the main path's inputs")
    pt_spec, pt_obs, pt_tf, pt_y0, pt_th0 = pt_in["args"]
    ptkw = pt_in["kw"]
    pt_nits, pt_every = 21, int(ptkw["swap_every"])
    pt_temps = tuple(float(t) for t in ptkw["temperatures"])
    pout, prate = cuda_pt.parallel_tempering_fused(
        *pt_in["args"], **{**ptkw, "nits": pt_nits, "burnin": 0})
    torch.cuda.synchronize()
    rec_k = [pout.theta.permute(1, 2, 0), pout.chi.t(), pout.rsquared.t(),
             pout.aic.t(), pout.acceptance_ratio.t()]
    psc, pbt, pdb = cuda_pt.ladder_constants(pt_temps, ptkw["rwalk_std"],
                                             ptkw["walk_mask"])
    pt_plan = cuda_mh._build_plan(pt_spec, pt_obs, pt_tf,
                                  cuda_mh._normalize_substeps(
                                      ptkw["substeps"], len(pt_tf) - 1))
    pt_th_all = pt_th0.t().contiguous()
    rec_t = cuda_pt.pt_plain(
        pt_spec, pt_plan, pt_y0, pt_th_all, ptkw["seed"], nits=pt_nits,
        burnin=0, scales=psc,
        walked=tuple(float(w) != 0.0 for w in ptkw["walk_mask"]),
        betas=pbt, dbetas=pdb, swap_every=pt_every,
        num=int(torch.count_nonzero(pt_th0[0])), stepper=ptkw["stepper"])
    torch.cuda.synchronize()
    pt_err = compare_records("PT (main path's inputs)", rec_k, rec_t[:5],
                             pt_nits)
    pt_att = max(float(cuda_pt.swap_attempts(pt_nits, pt_every, 1)[0]), 1.0)
    if not torch.equal(prate, rec_t[5][-1] / cuda_mh.const(pt_att,
                                                           rec_t[5])):
        fail("PT (main path's inputs): kernel and twin swap counts differ")
    print(f"PT at the main path's inputs: parallel_tempering_fused on all "
          f"{pt_th_all.shape[1]} chains x {len(pt_temps)} rungs x "
          f"{pt_nits - 1} iterations, seed {ptkw['seed']}, mean cold "
          f"acceptance {float(rec_k[4][-1].mean()):.4f}, mean cold swap "
          f"rate {float(prate.mean()):.4f}", flush=True)
    if (pt_th_all.shape[1], pt_temps) != (CHAINS, TEMPS):
        fail(f"PT main path ran {pt_th_all.shape[1]} chains x {pt_temps}, "
             f"not {CHAINS} x {TEMPS}")

    phase("joint kernel vs twin at the main path's inputs")
    jspecs, jidx, jobs, jtimes, jy0s, jth0 = joint_in["args"][:6]
    jkw = joint_in["kw"]
    jseed, jstep = jkw["seed"], jkw["stepper"]
    jplans = [cuda_mh._build_plan(sp, ob, tm, cuda_mh._normalize_substeps(
        sub, len(tm) - 1)) for sp, ob, tm, sub in
        zip(jspecs, jobs, jtimes, jkw["substeps_list"])]
    jwalk = tuple(float(jkw["rwalk_std"]) * float(w) for w in jkw["walk_mask"])
    jwalked = tuple(float(w) != 0.0 for w in jkw["walk_mask"])
    jth_all = jth0.t().contiguous()
    j_nits = 50
    jl_kw = dict(walk=jwalk, walked=jwalked)
    jout = cuda_joint.joint_metropolis_hastings_fused(
        *joint_in["args"], **{**jkw, "nits": j_nits, "burnin": 0})
    torch.cuda.synchronize()
    rec_k = [jout.theta.permute(1, 2, 0), jout.chi.t(),
             jout.chi_parts.permute(1, 2, 0), jout.acceptance_ratio.t()]
    rec_t = cuda_joint.joint_plain(jspecs, jplans, jy0s, jidx, jth_all,
                                   jseed, nits=j_nits, burnin=0,
                                   stepper=jstep, **jl_kw)
    torch.cuda.synchronize()
    joint_err = compare_records("joint (main path's inputs)", rec_k, rec_t,
                                j_nits,
                                labels=("theta", "chi", "chi parts", "ar"))
    print(f"joint at the main path's inputs: joint_metropolis_hastings_fused"
          f" on all {jth_all.shape[1]} chains, seed {jseed}, {jstep} x "
          f"{j_nits} iterations, mean acceptance "
          f"{float(rec_k[3][-1].mean()):.4f}", flush=True)
    if jth_all.shape[1] != CHAINS:
        fail(f"joint main path ran {jth_all.shape[1]} chains, not {CHAINS}")

    phase("PMMH kernel vs twin at the main path's inputs")
    pspec, pobs, ptf, py0, pth0 = pf_in["args"]
    pkw = pf_in["kw"]
    pseed, n_part = pkw["seed"], pkw["n_particles"]
    pf_plan = cuda_mh._build_plan(pspec, pobs, ptf,
                                  cuda_mh._normalize_substeps(
                                      pkw["substeps"], len(ptf) - 1))
    pf_run = pmmh_twin_kw(pkw)
    pth_all = pth0.t().contiguous()
    p_nits, p_burn = 21, 10
    pf_err, pout = pmmh_vs_twin("PMMH (main path's inputs)", pf_in, p_nits,
                                p_burn)
    print(f"PMMH at the main path's inputs: pmmh_fused on all "
          f"{pth_all.shape[1]} chains x {n_part} particles x {p_nits - 1} "
          f"proposals ({p_burn} adapting), seed {pseed}, mean acceptance "
          f"{float(pout.acceptance_ratio[:, -1].mean()):.4f}", flush=True)
    if (pth_all.shape[1], n_part) != (PF_CHAINS, PF_K):
        fail(f"PMMH main path ran {pth_all.shape[1]} chains x {n_part} "
             f"particles, not {PF_CHAINS} x {PF_K}")

    # chunked checkpointing, resume and run-length extension, on the main
    # paths' captured calls at their full run lengths
    ens_cfg = ens_in["cfg"]
    chunk_phases([
        ("MH", mh_fused, mh_in["args"], mh_in["kw"], 250),
        ("ensemble", cuda_mh.ensemble_fused,
         (spec, obs, tf, y0, torch.as_tensor(ens_in["theta0"], device=dev),
          ens_in["seed"]),
         dict(nits=ens_cfg.nits, burnin=ens_cfg.burnin,
              a=float(ens_cfg.stretch_a), walk_mask=ens_cfg.mask,
              substeps=ens_cfg.substeps,
              stepper=dispatch.fused_stepper(ens_cfg.method),
              tile_chains=ens_cfg.tile_chains), 250),
        ("PT", pt_fused, pt_in["args"], pt_in["kw"], 250),
        ("PMMH", pf_fused, pf_in["args"], pf_in["kw"], 64),
        ("joint", joint_fused, joint_in["args"], joint_in["kw"], 250),
        ("joint (priors)", joint_fused, auto_in["joint"]["args"],
         auto_in["joint"]["kw"], 250)],
        framework, CHAINS, NITS)
    # the joint kernel's chunk mode against its twin's, and through
    # JointFit.MCMC; then PMMH's Milstein step
    jc_err, jc_launches, jc_secs = joint_chunk_phases(
        joint_fit, jpost_plain, [("joint", joint_in),
                                 ("joint (priors)", auto_in["joint"])], NITS)
    (mil_err, mil_launches, mil_call, runs["pmmh:milstein"],
     mil_times) = milstein_phases(pmmh_framework)

    # every observation model, censoring and doses: kernels against twins
    # on each scoring branch, the paths (a)-(e), times against the demo's
    s_errs = scoring_phases(paths, {
        "mh": mh_in, "pt": pt_in, "ensemble": {
            "args": (spec, obs, tf, y0, torch.as_tensor(
                ens_in["theta0"], device=dev), ens_in["seed"]),
            "kw": dict(nits=ens_cfg.nits, burnin=ens_cfg.burnin,
                       a=float(ens_cfg.stretch_a), walk_mask=ens_cfg.mask,
                       substeps=ens_cfg.substeps,
                       stepper=dispatch.fused_stepper(ens_cfg.method),
                       tile_chains=ens_cfg.tile_chains)}}, pf_in)

    # the stiff path: the kernels' kvaerno3 instantiations
    stiff_rows = stiff_phases(framework, rob_fw, smi_line)
    # forcings and array parameters through every kernel
    fa_rows = forcing_phases(fa, joint_pair, (spec, pf_spec), mh_in, pf_in,
                             smi_line)
    # PT ladders, joint fits and models of any size
    limit_rows = limits_phases(lf, smi_line)

    # -- 5. times -----------------------------------------------------------
    phase("times")
    short = 6        # the twins over 5 proposals, scaled per iteration
    th_main_t = torch.as_tensor(seeds, device=dev).t().contiguous()
    th_s = torch.as_tensor(draws[:1000], device=dev).t().contiguous()
    launch_kw = {k: v for k, v in ens_main.items() if k != "stepper"}
    pt_main = dict(scales=scales, walked=(True,) * 3, betas=betas,
                   dbetas=dbetas, swap_every=1, num=3)
    sv_ms, sv_plain_ms, sv_bound, _ = kernel_costs(
        "survey", "dopri5", (spec, plan, y0, th_s, None, {}), reps=50,
        short=short)
    mh_ms, mh_plain_ms, mh_bound, _ = kernel_costs(
        "mh", "dopri5", (spec, plan, y0, th_main_t, seed,
                         dict(walk=walk, walked=(True,) * 3, num=3)),
        short=short)
    ens_ms, ens_plain_ms, ens_bound, _ = kernel_costs(
        "ensemble", stepper, (spec, ens_plan, y0, ens_start, ens_seed,
                              launch_kw), short=short)
    pt_ms, pt_plain_ms, pt_bound, _ = kernel_costs(
        "pt", "dopri5", (spec, plan, y0, th_main_t, seed, pt_main),
        short=short)
    joint_ms = events_ms(cuda_joint.joint_launcher(
        jspecs, jplans, jy0s, jidx, jstep, jth_all, jseed, nits=NITS,
        burnin=BURNIN, **jl_kw))
    jt_ms = events_ms(lambda: cuda_joint.joint_plain(
        jspecs, jplans, jy0s, jidx, jth_all, jseed, nits=short, burnin=0,
        stepper=jstep, **jl_kw))
    joint_plain_ms = jt_ms / (short - 1) * (NITS - 1)
    # chunk mode: the path's four launches of 250, 250, 250 and 249, each
    # chunk from the state the one before left on the card
    j_chunks = [(b, min(250, NITS - 1 - b)) for b in range(0, NITS - 1, 250)]
    j_launch = {R: cuda_joint.joint_launcher(
        jspecs, jplans, jy0s, jidx, jstep, jth_all, jseed, nits=NITS,
        burnin=BURNIN, R_chunk=R, **jl_kw) for _, R in j_chunks}

    def joint_in_chunks():
        state = None
        for b, R in j_chunks:
            _, state = j_launch[R](it_base=b, state=state)
    joint_chunk_ms = events_ms(joint_in_chunks)
    state_250 = j_launch[250](it_base=0)[1]
    jtc_ms = events_ms(lambda: cuda_joint.joint_plain(
        jspecs, jplans, jy0s, jidx, jth_all, jseed, nits=NITS, burnin=BURNIN,
        stepper=jstep, R_chunk=short - 1, it_base=250, state=state_250,
        **jl_kw))
    joint_chunk_plain_ms = jtc_ms / (short - 1) * (NITS - 1)
    print(f"joint kernel in {len(j_chunks)} chunk launches at the main "
          f"path's shape: {joint_chunk_ms:.3f} ms (whole run {joint_ms:.3f} "
          f"ms, {(joint_chunk_ms - joint_ms) / (len(j_chunks) - 1):+.3f} ms "
          f"a boundary); the twin's chunk mode scaled from {short - 1} "
          f"proposals {joint_chunk_plain_ms:.1f} ms")
    pf_burn = PF_NITS // 2
    pf_ms = events_ms(cuda_pf.pmmh_launcher(
        pspec, pf_plan, py0, pth_all, pseed, nits=PF_NITS, burnin=pf_burn,
        **pf_run))
    pf_short = 3     # the twin over 2 proposals (and its initial filter)
    pft_ms = events_ms(lambda: cuda_pf.pmmh_plain(
        pspec, pf_plan, py0, pth_all, pseed, nits=pf_short, burnin=0,
        **pf_run))
    pf_plain_ms = pft_ms / (pf_short - 1) * (PF_NITS - 1)
    for label, ms, p_ms, steps in (
            ("MH", mh_ms, mh_plain_ms, CHAINS),
            ("ensemble", ens_ms, ens_plain_ms, W_main),
            ("PT", pt_ms, pt_plain_ms, CHAINS * len(TEMPS)),
            ("joint", joint_ms, joint_plain_ms, CHAINS * len(jspecs))):
        rate = steps * (NITS - 1) / (ms / 1e3)
        print(f"{label} kernel {steps} solves x {NITS}: {ms:.3f} ms "
              f"({rate:.4g} solve-steps/s); twin scaled from {short - 1} "
              f"proposals {p_ms:.1f} ms")
    n_pf = pth_all.shape[1]
    pf_steps = n_pf * n_part * len(pf_plan.step_ts) * PF_NITS
    print(f"PMMH kernel {n_pf} chains x {n_part} particles x "
          f"{len(pf_plan.step_ts)} steps x {PF_NITS} filters: {pf_ms:.3f} ms "
          f"({pf_steps / (pf_ms / 1e3):.4g} particle-steps/s); twin scaled "
          f"from {pf_short - 1} proposals {pf_plain_ms:.1f} ms")
    print(f"survey kernel 1000 draws: {sv_ms:.4f} ms; twin "
          f"{sv_plain_ms:.3f} ms")
    # the slice's kernels: the demo's lognormal priors at the main paths'
    # shapes, and MH on the schedule its prior-aware path calibrated
    demo_tab = prior_table(auto_runs["mh"][0].parameters[p].tdist
                           for p in ("mu", "phi", "beta"))
    auto_sched = auto_runs["mh"][1]
    auto_plan = cuda_mh._build_plan(spec, obs, tf, auto_sched)
    mh_kw = dict(nits=NITS, burnin=BURNIN, walk=walk, walked=(True,) * 3,
                 num=3)
    prior_ms = {
        "MH, priors": events_ms(cuda_mh.mh_launcher(
            spec, plan, y0, "dopri5", th_main_t, seed, prior=demo_tab,
            **mh_kw)),
        "MH, calibrated schedule": events_ms(cuda_mh.mh_launcher(
            spec, auto_plan, y0, "dopri5", th_main_t, seed, **mh_kw)),
        "MH, calibrated schedule and priors": events_ms(cuda_mh.mh_launcher(
            spec, auto_plan, y0, "dopri5", th_main_t, seed, prior=demo_tab,
            **mh_kw)),
        "ensemble, priors": events_ms(cuda_mh.ensemble_launcher(
            spec, ens_plan, y0, stepper, ens_start, ens_seed, nits=NITS,
            burnin=BURNIN, prior=demo_tab, **launch_kw)),
        "PT, priors": events_ms(cuda_pt.pt_launcher(
            spec, plan, y0, "dopri5", th_main_t, seed, nits=NITS,
            burnin=BURNIN, prior=demo_tab, **pt_main)),
        "joint, priors": events_ms(cuda_joint.joint_launcher(
            jspecs, jplans, jy0s, jidx, jstep, jth_all, jseed, nits=NITS,
            burnin=BURNIN, prior=prior_table(jf._dists()), **jl_kw)),
    }
    # a prior whose log density is one constant over the chains' range
    # (Cauchy of a huge scale: -log1p(z * z) + c rounds to c, theta = 0
    # included) runs the prior's arithmetic on the chains of the prior-free
    # run: what the prior costs apart from the chains it changes. At scale
    # 1e30 the quotient z of phi is near float32's smallest normal, where
    # an IEEE division leaves its fast path; at 1e15 it does not.
    flat_ms = {}
    for scale in (1e15, 1e30):
        flat_d = D.Cauchy(loc=0.0, scale=scale)
        flat = prior_table([flat_d] * 3)
        flat_ms[f"MH, flat prior of scale {scale:g}"] = events_ms(
            cuda_mh.mh_launcher(spec, plan, y0, "dopri5", th_main_t, seed,
                                prior=flat, **mh_kw))
        flat_ms[f"ensemble, flat prior of scale {scale:g}"] = events_ms(
            cuda_mh.ensemble_launcher(spec, ens_plan, y0, stepper, ens_start,
                                      ens_seed, nits=NITS, burnin=BURNIN,
                                      prior=flat, **launch_kw))
        flat_ms[f"PT, flat prior of scale {scale:g}"] = events_ms(
            cuda_pt.pt_launcher(spec, plan, y0, "dopri5", th_main_t, seed,
                                nits=NITS, burnin=BURNIN, prior=flat,
                                **pt_main))
        flat_ms[f"joint, flat prior of scale {scale:g}"] = events_ms(
            cuda_joint.joint_launcher(
                jspecs, jplans, jy0s, jidx, jstep, jth_all, jseed, nits=NITS,
                burnin=BURNIN, prior=prior_table([flat_d] * len(jf._dists())),
                **jl_kw))
    print(f"MH kernel without priors, substeps=4 ({len(plan.step_ts)} steps "
          f"a solve): {mh_ms:.3f} ms")
    for label, ms in prior_ms.items():
        print(f"{label} kernel at the main path's shape: {ms:.3f} ms"
              + (f" ({len(auto_plan.step_ts)} steps a solve)"
                 if "calibrated" in label else ""))
    for label, ms in flat_ms.items():
        print(f"{label} (the prior-free run's chains): {ms:.3f} ms")
    for sampler, (wall_s, _, stages) in runs.items():
        print(f"MCMC({sampler}) wall time: {wall_s:.3f} s; stages "
              + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items()))
    print(f"build {build_s:.3f} s ({smi_line})")

    # bounds (survey, MH, ensemble and PT: kernel_costs): float32
    # operations from the twins on the CPU, bytes from the main path's shapes
    R = NITS - 1 - BURNIN
    one = torch.as_tensor(seeds[:1].T.copy())
    # MH on the schedule the MH path's substeps='auto' calibrated
    init, step, rec = per_iteration_ops(lambda n, b: cuda_mh.mh_plain(
        spec, auto_plan, y0, one, seed, nits=n, burnin=b, walk=walk,
        walked=(True,) * 3, num=3))
    mh_auto_bound = bound(
        CHAINS * (init + (NITS - 1) * step + R * rec),
        sum(a.nbytes for a in cuda_mh.plan_tables(spec, auto_plan, y0,
                                                  "dopri5"))
        + CHAINS * 3 * 4 + R * CHAINS * (3 + 4) * 4)
    jone = jth_all[:, :1].cpu().contiguous()
    init_j, step_j, rec_j = per_iteration_ops(
        lambda n, b: cuda_joint.joint_plain(
            jspecs, jplans, jy0s, jidx, jone, jseed, nits=n, burnin=b,
            stepper=jstep, **jl_kw))
    D, K_exp = jth_all.shape[0], len(jspecs)
    jplan_bytes = sum(a.nbytes for a in cuda_joint.joint_tables(
        jspecs, jplans, jy0s, jidx, jstep)[:3])
    joint_bound = bound(CHAINS * (init_j + (NITS - 1) * step_j + R * rec_j),
                        jplan_bytes + CHAINS * D * 4
                        + R * CHAINS * (D + K_exp + 2) * 4)
    # the selection's work depends on the data (a masked sum, K * K * S
    # adds, in each block whose ladder dipped), so average PF_OPS_CHAINS
    # chains' counts
    pf_counts = [per_iteration_ops(lambda n, b, c=c: cuda_pf.pmmh_plain(
        pspec, pf_plan, py0, pth_all[:, c:c + 1].cpu().contiguous(), pseed,
        nits=n, burnin=b, **pf_run)) for c in range(PF_OPS_CHAINS)]
    init, step, rec = (sum(v) / len(pf_counts) for v in zip(*pf_counts))
    print(f"PMMH float32 operations per iteration of {PF_OPS_CHAINS} "
          "chains: "
          f"{sorted(c[1] for c in pf_counts)} (a masked sum adds "
          f"{n_part ** 2 * len(pspec.snames)})")
    pf_R = PF_NITS - 1 - pf_burn
    pf_plan_bytes = sum(a.nbytes for a in cuda_mh.plan_tables(
        pspec, pf_plan, py0, "euler"))
    P_pf = pth_all.shape[0]
    pf_bound = bound(n_pf * (init + (PF_NITS - 1) * step + pf_R * rec),
                     pf_plan_bytes + (n_pf + 7) * P_pf * 4
                     + pf_R * n_pf * (P_pf + 2) * 4)
    # the joint kernel in chunks: the same work, every row recorded (the
    # host drops burn-in), the state read and written at each boundary
    n_jc = len(j_chunks)
    joint_chunk_bound = bound(
        CHAINS * (init_j + (NITS - 1) * step_j + (NITS - 1) * rec_j),
        jplan_bytes + CHAINS * D * 4
        + (NITS - 1) * CHAINS * (D + K_exp + 2) * 4
        + (2 * n_jc - 1) * CHAINS * (D + K_exp + 3) * 4)
    # Milstein: the twin's float32 operations (with the diagonal's) on the
    # Milstein path's chains, averaged as for Euler
    mspec, mobs, mtf, my0, mth0 = mil_call["args"]
    mkw = mil_call["kw"]
    mil_plan = cuda_mh._build_plan(mspec, mobs, mtf,
                                   cuda_mh._normalize_substeps(
                                       mkw["substeps"], len(mtf) - 1))
    mil_run = pmmh_twin_kw(mkw)
    mth_all = mth0.t().contiguous()
    m_counts = [per_iteration_ops(lambda n, b, c=c: cuda_pf.pmmh_plain(
        mspec, mil_plan, my0, mth_all[:, c:c + 1].cpu().contiguous(),
        mkw["seed"], nits=n, burnin=b, **mil_run))
        for c in range(PF_OPS_CHAINS)]
    init, step, rec = (sum(v) / len(m_counts) for v in zip(*m_counts))
    mil_bound = bound(n_pf * (init + (PF_NITS - 1) * step + pf_R * rec),
                      pf_plan_bytes + (n_pf + 7) * P_pf * 4
                      + pf_R * n_pf * (P_pf + 2) * 4)
    mil_ms = mil_times[1]
    mt_ms = events_ms(lambda: cuda_pf.pmmh_plain(
        mspec, mil_plan, my0, mth_all, mkw["seed"], nits=pf_short, burnin=0,
        **mil_run))
    mil_plain_ms = mt_ms / (pf_short - 1) * (PF_NITS - 1)
    print(f"PMMH Milstein kernel: {mil_ms:.3f} ms; twin scaled from "
          f"{pf_short - 1} proposals {mil_plain_ms:.1f} ms; float32 "
          f"operations per iteration of {PF_OPS_CHAINS} chains "
          f"{sorted(c[1] for c in m_counts)} (Euler "
          f"{sorted(c[1] for c in pf_counts)})")
    for label, (b_ms, by) in (("survey", sv_bound), ("MH", mh_bound),
                              ("MH, calibrated schedule "
                               f"({len(auto_plan.step_ts)} steps)",
                               mh_auto_bound),
                              ("ensemble", ens_bound), ("PT", pt_bound),
                              ("joint", joint_bound),
                              ("joint in chunks", joint_chunk_bound),
                              ("PMMH", pf_bound),
                              ("PMMH Milstein", mil_bound)):
        print(f"{label} bound: {b_ms:.4f} ms, by {by}")

    from torch.profiler import ProfilerActivity, profile
    for sampler in ("mh", "ensemble"):
        phase(f"where the time goes: one more MCMC(sampler={sampler!r}) "
              "under torch.profiler")
        fw = framework()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof, \
                contextlib.redirect_stdout(io.StringIO()):
            GC_SPANS.clear()
            t0 = time.perf_counter()
            fw.MCMC(chain_inits=CHAINS, iterations_per_chain=NITS,
                    fitsurvey_samples=1000, sd_fitdistance=6.0,
                    sampler=sampler, print_report=True, profile=True)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        kernels = device_kernels(prof)
        # busy: the union of the device's intervals, copies included
        busy, end = 0.0, float("-inf")
        for s, e in sorted(x for v in kernels.values() for x in v):
            if e > end:
                busy += e - max(s, end)
                end = e
        busy /= 1e6
        print(f"profiled MCMC({sampler}) wall {prof_wall:.3f} s; stages "
              + ", ".join(f"{k} {v:.3f} s"
                          for k, v in fw.last_profile.items()))
        print(f"profiled MCMC({sampler}) " + gc_report(t0, fw.last_profile))
        if busy > 0:
            print(f"device busy {busy:.4f} s = {100 * busy / prof_wall:.2f} "
                  f"% of wall (idle {100 - 100 * busy / prof_wall:.2f} %)")
            print_launches(kernels)
        else:
            print("device time: not measured (the profiler recorded none)")
        if sampler == "ensemble":
            ens = [s for k, v in kernels.items() if "ens_kernel" in k
                   for s in v]
            if len(ens) != 1:
                fail(f"ensemble main path: {len(ens)} device launches of "
                     "ens_kernel under the profiler, not 1")
            print(f"ensemble main path: 1 device launch of ens_kernel, "
                  f"{(ens[0][1] - ens[0][0]) / 1e3:.3f} ms")

    csrc = "odelib_tpu_torch/ops/csrc/"

    def row(name, src, replaces, sampler, err, ms, plain_ms, b):
        return {"name": name, "route": "cuda", "source": csrc + src,
                "replaces": replaces, "launches": runs[sampler][1][name],
                "max_abs_err": max(err, s_errs[name]), "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": b[0], "bound_by": b[1], "library_ms": None}
    print(json.dumps({"kernels": [
        row("survey_fused", "mh.cu", "odelib_tpu/ops/pallas_mh.py:1765",
            "mh", survey_err, sv_ms, sv_plain_ms, sv_bound),
        row("metropolis_hastings_fused", "mh.cu",
            "odelib_tpu/ops/pallas_mh.py:1017", "mh",
            max(mh_err, auto_err["mh"]), mh_ms, mh_plain_ms, mh_bound),
        row("ensemble_fused", "ensemble.cu",
            "odelib_tpu/ops/pallas_mh.py:1514", "ensemble",
            max(ens_err, auto_err["ensemble"]), ens_ms, ens_plain_ms,
            ens_bound),
        row("parallel_tempering_fused", "pt.cu",
            "odelib_tpu/ops/pallas_pt.py:49", "pt",
            max(pt_err, auto_err["pt"]), pt_ms, pt_plain_ms, pt_bound),
        row("joint_metropolis_hastings_fused", "joint.cu",
            "odelib_tpu/ops/pallas_joint.py:347", "joint",
            max(joint_err, auto_err["joint"]), joint_ms, joint_plain_ms,
            joint_bound),
        row("pmmh_fused", "pf.cu", "odelib_tpu/ops/pallas_pf.py:130",
            "pmmh", pf_err, pf_ms, pf_plain_ms, pf_bound),
        {"name": "joint:chunk", "route": "cuda", "source": csrc + "joint.cu",
         "replaces": "odelib_tpu/ops/pallas_joint.py:212",
         "launches": jc_launches, "max_abs_err": jc_err,
         "ms": joint_chunk_ms, "plain_ms": joint_chunk_plain_ms,
         "bound_ms": joint_chunk_bound[0], "bound_by": joint_chunk_bound[1],
         "library_ms": None},
        {"name": "pmmh:milstein", "route": "cuda", "source": csrc + "pf.cu",
         "replaces": "odelib_tpu/ops/pallas_pf.py:289",
         "launches": mil_launches, "max_abs_err": mil_err, "ms": mil_ms,
         "plain_ms": mil_plain_ms, "bound_ms": mil_bound[0],
         "bound_by": mil_bound[1], "library_ms": None}]
        + stiff_rows + fa_rows + limit_rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
