"""Drive odelib_tpu_torch's main paths once on one CUDA card.

    python3 chip_smoke.py

Phases, each failing the script if it fails:

1. device: the card's name and power limit (nvidia-smi); exits non-zero
   without CUDA;
2. build: all six kernels (ops/csrc/*.cu) from the checkout's sources
   into a clean build directory, three libraries started together: the
   main-path model's, a joint fit of two different models' (zero_i and
   one_i) and the PMMH path's SDE model's; the builds' seconds and each
   kernel's registers, stack and spills;
3. kernel versus twin on the card, at the main-path model (zero_i on the
   demo data, t_steps=288, substeps=4): the survey on 4096 LHS draws (chi
   rtol 1e-5, equal non-finite masks), MH on 1024 chains x 200 iterations
   (identical accept sequences up to documented ulp ties, records rtol
   1e-5), the ensemble on 2048 walkers (two ensembles of 1024) x 200
   iterations, PT with the main path's 4 rungs on 1024 chains x 200
   iterations, and with 3 (an idle lane in each chain's group of 4) and 8
   rungs on 1000 chains x 60 (identical accept sequences and swap counts,
   bitwise records), and the joint kernel on the heterogeneous pair
   zero_i + one_i, 256 chains x 20 iterations (bitwise records);
4. the main paths, each with launch counts reset just before and read just
   after: ModelFramework(..., device='cuda').MCMC(chain_inits=10000,
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
   (|mean - exact| < 0.02, std within rtol 0.05). Then each of four
   kernels, through its public wrapper, against its twin on its main
   path's own inputs, captured where the path calls the wrapper:
   ensemble_fused (its 10,000 walkers and seed, the default tile of 4096,
   padded to 12,288 walkers; 200 iterations; the tile sets each walker's
   partners, so this is the geometry the main path runs; identical accept
   sequences, records rtol 1e-5), parallel_tempering_fused (all 10,000
   chains x 4 rungs x 20 iterations: 40,000 threads, so the last block of
   128 is part empty; identical accept sequences and swap counts, bitwise),
   joint_metropolis_hastings_fused (all 10,000 chains x 50 iterations) and
   pmmh_fused (all 10,240 chains x 128 particles x 20 iterations, adapting
   for 10), the last three bitwise (PT and PMMH fail on any bit);
5. times: each kernel against its plain torch twin on the card at the main
   path's shapes (CUDA events; the twin over a few proposals, scaled), the
   MCMC wall times with their stage breakdowns, and the device's busy share
   of one more MH run under torch.profiler. Each kernel's bound is the
   larger of its float32 operations (counted by running its twin on the
   CPU under a counting dispatch mode; per chain and iteration they do not
   depend on the data but for the particle filter's selection, which
   twin and kernel make by a search, one add per particle and state,
   or by a masked sum where rounding made the prefix sum dip: averaged
   over 8 chains) over the FP32 peak and its
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
MU, SIG, S_OBS = 0.4, 0.3, 0.15
PRI_MU, PRI_SD = 0.4, 0.5          # mu ~ lognorm(s=PRI_SD, scale=PRI_MU)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


T0 = time.perf_counter()


def phase(name):
    print(f"== {name} (at {time.perf_counter() - T0:.0f} s)", flush=True)


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


def compare_records(name, rec_k, rec_t, nits, labels=MH_LABELS, burnin=0,
                    bitwise=False):
    """Kernel against twin records (chain-minor, from iteration burnin +
    1): identical accept sequences, every record rtol 1e-5 (``bitwise``:
    equal); returns chi's max abs error."""
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
        if rel > 1e-5:
            fail(f"{name}: {label} kernel vs twin rel err {rel:.3g} > 1e-5")
        if bitwise and not (a[m] == b[m]).all():
            fail(f"{name}: {label} kernel and twin differ in bits")
    return err


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
    from odelib_tpu_torch.data import (build_obsdata_host,
                                       compact_observation_grid,
                                       format_dataframe, load_demo_dataframe)
    from odelib_tpu_torch.models import one_i, zero_i
    from odelib_tpu_torch.ops import (build, cuda_joint, cuda_mh, cuda_pf,
                                      cuda_pt)
    from odelib_tpu_torch.ops.priors import prior_table
    if "jax" in sys.modules:
        fail("jax was imported")

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

    def framework(df=None, **kw):
        return ModelFramework(
            ODE=zero_i.rhs, parameter_names=list(zero_i.pnames),
            state_names=list(zero_i.snames),
            dataframe=(load_demo_dataframe(host="S", virus="V")
                       if df is None else df),
            mu=parameter(scipy.stats.lognorm, {"s": 3, "scale": 1e-8},
                         random_seed=1),
            phi=parameter(scipy.stats.lognorm, {"s": 3, "scale": 1e-8},
                          random_seed=2),
            beta=parameter(scipy.stats.lognorm, {"s": 1, "scale": 25},
                           random_seed=3),
            t_steps=288, device="cuda", ode_style="jax", **kw)

    def joint_fit():
        """zero_i on the demo data (a) and on the same frame with its log
        abundances perturbed (numpy seed 7, sd 0.1) and both initial
        abundances x 1.13 (b), sharing phi and beta: D = 4."""
        fw_a = framework()
        df = load_demo_dataframe(host="S", virus="V")
        df["abundance"] = df["abundance"] * np.exp(
            np.random.default_rng(7).normal(0, 0.1, len(df)))
        y0_a = fw_a.get_inits(as_dict=True)
        fw_b = framework(df, **{s: 1.13 * float(v) for s, v in y0_a.items()})
        return JointFit({"a": fw_a, "b": fw_b}, shared=["phi", "beta"],
                        random_seed=0)

    def gbm(y, t, ps):
        return np.array([ps[0] * y[0]])

    def gnoise(y, t, ps):
        return np.array([SIG * y[0]])

    def pmmh_framework():
        t_obs, log_o = gbm_data()
        df = pd.DataFrame({"organism": "N", "time": t_obs,
                           "abundance": np.exp(log_o), "log_sigma": S_OBS})
        return ModelFramework(
            ODE=gbm, diffusion=gnoise, parameter_names=["mu"],
            state_names=["N"], dataframe=df, t_steps=41, N=2.0,
            mu=parameter(scipy.stats.lognorm, {"s": PRI_SD,
                                               "scale": PRI_MU}),
            device="cuda")

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
    pf_spec = pmmh_framework()._spec

    # -- 2. build -------------------------------------------------------------
    phase("build")
    from concurrent.futures import ThreadPoolExecutor
    shutil.rmtree(build.BUILD_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as ex:       # three nvcc processes at once
        libs = list(ex.map(lambda a: build.load_kernels(*a),
                           [(spec,), (spec, (spec1,)),
                            (pf_spec, (), True)]))
    build_s = time.perf_counter() - t0
    logs = ""
    for label, lib in zip(("zero_i", "zero_i + one_i (joint)", "GBM SDE"),
                          libs):
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
    for name in ("survey_kernel", "mh_kernel", "ens_init_kernel",
                 "ens_half_kernel", "pt_kernel", "joint_kernel", "pf_kernel"):
        if name not in logs:
            fail(f"build: {name} is missing from nvcc.log")
    print(f"build seconds (three libraries in parallel): {build_s:.3f}",
          flush=True)

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
    if not (np.isfinite(ck) == np.isfinite(ct)).all():
        fail("survey: kernel and twin disagree on which chi are finite")
    fin = np.isfinite(ck)
    survey_err = float(np.max(np.abs(ck[fin] - ct[fin]))) if fin.any() else 0.0
    survey_rel = float(np.max(np.abs(ck[fin] - ct[fin]) / np.abs(ct[fin])))
    print(f"survey: {fin.sum()}/{n_draws} finite, max abs err "
          f"{survey_err:.6g}, max rel err {survey_rel:.3g}, bitwise equal "
          f"{np.mean(ck[fin] == ct[fin]):.4f}", flush=True)
    if survey_rel > 1e-5:
        fail(f"survey: kernel vs twin rel err {survey_rel:.3g} > 1e-5")

    phase("MH kernel vs twin")
    C, nits = 1024, 200
    order = np.argsort(np.where(fin, ck, np.inf))
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
    rec_k = [r.cpu().numpy() for r in rec_k]          # (R, P, C), (R, C)
    rec_t = [r.cpu().numpy() for r in tw]
    acc_k = accept_steps(rec_k[4], nits)
    acc_t = accept_steps(rec_t[4], nits)
    flip = np.abs(acc_k - acc_t) > 0.5                  # (R, C)
    first = np.where(flip.any(0), flip.argmax(0), nits - 1)
    rows = np.arange(nits - 1)[:, None] < first[None, :]  # before any flip
    n_flip = int(flip.any(0).sum())
    for c in np.where(flip.any(0))[0]:
        r = int(first[c])
        it = r + 1
        lt = np.log(rec_t[0][r - 1, :, c] if r else
                    th0[c].cpu().numpy()).astype(np.float32)
        chi_old = rec_t[1][r - 1, c] if r else float(
            cuda_mh.survey_plain(spec, plan, y0,
                                 th0[c:c + 1].t().contiguous())[0])
        rng = cuda_mh.Rng(seed, torch.tensor([c], device=dev))
        rng.start(it)
        prop = [torch.tensor(lt[p], device=dev)
                + cuda_mh.const(walk[p], th0) * rng.normal()
                for p in range(3)]
        u = float(rng.uniform()[0])
        th_p = torch.stack([torch.exp(v) for v in prop]).reshape(3, 1)
        chi_new = float(cuda_mh.survey_plain(spec, plan, y0, th_p)[0])
        gap = abs((chi_old - chi_new) - np.log(u))
        print(f"accept flip: chain {c} iteration {it}: |log_ratio - log u| "
              f"= {gap:.3g}")
        if not gap < 1e-4:
            fail(f"MH: accept decision of chain {c} flipped at iteration "
                 f"{it} without an ulp-level tie")
    mh_err = 0.0
    for name, a, b in zip(("theta", "chi", "rsquared", "aic", "ar"),
                          rec_k, rec_t):
        m = rows if a.ndim == 2 else rows[:, None, :]
        m = np.broadcast_to(m, a.shape) & np.isfinite(b)
        rel = float(np.max(np.abs(a[m] - b[m]) / np.maximum(np.abs(b[m]),
                                                              1e-30)))
        if name == "chi":
            mh_err = float(np.max(np.abs(a[m] - b[m])))
        print(f"MH {name}: max rel err {rel:.3g}, bitwise equal "
              f"{np.mean(a[m] == b[m]):.4f}")
        if rel > 1e-5:
            fail(f"MH: {name} kernel vs twin rel err {rel:.3g} > 1e-5")
    print(f"MH: {C} chains x {nits} iterations, {n_flip} chains with an "
          f"accept flip, mean acceptance {rec_k[4][-1].mean():.4f}",
          flush=True)

    phase("ensemble kernel vs twin")
    W, tile, mask = 2048, 1024, (1.0, 1.0, 1.0)
    start = torch.as_tensor(np.ascontiguousarray(cuda_mh.ensemble_init(
        seeds[:W], seed, tile, mask, 0.01).T), device=dev)
    ens_kw = dict(tile=tile, nits=nits, burnin=0, a=2.0, walk=mask,
                  walked=(True,) * 3, num=3, W0=W)
    rec_k = cuda_mh.ensemble_launcher(spec, plan, y0, "dopri5", start, seed,
                                      **ens_kw)()
    torch.cuda.synchronize()
    rec_t = cuda_mh.ensemble_plain(spec, plan, y0, start, seed, **ens_kw)
    torch.cuda.synchronize()
    compare_records("ensemble", rec_k, rec_t, nits)
    print(f"ensemble: {W} walkers ({W // tile} ensembles) x {nits} "
          f"iterations, {1 + 2 * (nits - 1)} device launches, mean "
          f"acceptance {float(rec_k[4][-1].mean()):.4f}", flush=True)

    phase("PT kernel vs twin")
    # the main path's ladder, then 3 rungs (an idle lane in each chain's
    # group of 4 lanes) and 8 (a full group), on 1000 chains so the last
    # block of 128 threads is part empty; the twin's time grows with the
    # rungs, so these two take fewer iterations
    for temps, n_c, n_it in (
            (TEMPS, C, nits), ((1.0, 2.0, 4.0), 1000, 60),
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
        compare_records(f"PT {len(temps)} rungs", rec_k, rec_t, n_it,
                        bitwise=True)
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
    for sampler in ("mh", "ensemble", "pt"):
        phase(f"main path: ModelFramework(...).MCMC(sampler={sampler!r})")
        fw = framework()
        out = io.StringIO()
        extra = dict(temperatures=TEMPS) if sampler == "pt" else {}
        cuda_mh.reset_launch_counts()
        torch.cuda.synchronize()
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
        for name in ("survey_fused", kernel_of[sampler]):
            if launches[name] < 1:
                fail(f"{sampler}: {name} never launched: {launches}")
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

    phase("ensemble kernel vs twin at the main path's inputs")
    ens_th0, cfg, ens_seed = ens_in["theta0"], ens_in["cfg"], ens_in["seed"]
    ens_nits = 200
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
                             pt_nits, bitwise=True)
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
    pf_walk = tuple(float(w) for w in pkw["walk_mask"])
    pf_run = dict(K=n_part, walk=pf_walk,
                  walked=tuple(w != 0.0 for w in pf_walk),
                  rwalk_std=pkw["rwalk_std"], prior=prior_table(pkw["priors"]),
                  adapt=pkw["adapt_proposal"], target=pkw["target_accept"],
                  adapt_rate=pkw["adapt_rate"])
    pth_all = pth0.t().contiguous()
    p_nits, p_burn = 21, 10
    pout = cuda_pf.pmmh_fused(*pf_in["args"],
                              **{**pkw, "nits": p_nits, "burnin": p_burn})
    torch.cuda.synchronize()
    rec_k = [pout.theta.permute(1, 2, 0), pout.chi.t(),
             pout.acceptance_ratio.t()]
    rec_t = cuda_pf.pmmh_plain(pspec, pf_plan, py0, pth_all, pseed,
                               nits=p_nits, burnin=p_burn, **pf_run)
    torch.cuda.synchronize()
    pf_err = compare_records("PMMH (main path's inputs)", rec_k, rec_t,
                             p_nits, labels=("theta", "chi", "ar"),
                             burnin=p_burn, bitwise=True)
    print(f"PMMH at the main path's inputs: pmmh_fused on all "
          f"{pth_all.shape[1]} chains x {n_part} particles x {p_nits - 1} "
          f"proposals ({p_burn} adapting), seed {pseed}, mean acceptance "
          f"{float(rec_k[2][-1].mean()):.4f}", flush=True)
    if (pth_all.shape[1], n_part) != (PF_CHAINS, PF_K):
        fail(f"PMMH main path ran {pth_all.shape[1]} chains x {n_part} "
             f"particles, not {PF_CHAINS} x {PF_K}")

    # -- 5. times -----------------------------------------------------------
    phase("times")
    short = 6        # the twins over 5 proposals, scaled per iteration
    th_main_t = torch.as_tensor(seeds, device=dev).t().contiguous()
    mh_ms = events_ms(cuda_mh.mh_launcher(
        spec, plan, y0, "dopri5", th_main_t, seed, nits=NITS, burnin=BURNIN,
        walk=walk, walked=(True,) * 3, num=3))
    tw_ms = events_ms(lambda: cuda_mh.mh_plain(
        spec, plan, y0, th_main_t, seed, nits=short, burnin=0, walk=walk,
        walked=(True,) * 3, num=3))
    mh_plain_ms = tw_ms / (short - 1) * (NITS - 1)
    th_s = torch.as_tensor(draws[:1000], device=dev).t().contiguous()
    sv_ms = events_ms(cuda_mh.survey_launcher(spec, plan, y0, "dopri5",
                                              th_s), reps=50)
    sv_plain_ms = events_ms(lambda: cuda_mh.survey_plain(
        spec, plan, y0, th_s), reps=3)
    launch_kw = {k: v for k, v in ens_main.items() if k != "stepper"}
    ens_ms = events_ms(cuda_mh.ensemble_launcher(
        spec, ens_plan, y0, stepper, ens_start, ens_seed, nits=NITS,
        burnin=BURNIN, **launch_kw))
    ens_tw_ms = events_ms(lambda: cuda_mh.ensemble_plain(
        spec, ens_plan, y0, ens_start, ens_seed, nits=short, burnin=0,
        **ens_main))
    ens_plain_ms = ens_tw_ms / (short - 1) * (NITS - 1)
    pt_main = dict(scales=scales, walked=(True,) * 3, betas=betas,
                   dbetas=dbetas, swap_every=1, num=3)
    pt_ms = events_ms(cuda_pt.pt_launcher(
        spec, plan, y0, "dopri5", th_main_t, seed, nits=NITS, burnin=BURNIN,
        **pt_main))
    pt_tw_ms = events_ms(lambda: cuda_pt.pt_plain(
        spec, plan, y0, th_main_t, seed, nits=short, burnin=0, **pt_main))
    pt_plain_ms = pt_tw_ms / (short - 1) * (NITS - 1)
    joint_ms = events_ms(cuda_joint.joint_launcher(
        jspecs, jplans, jy0s, jidx, jstep, jth_all, jseed, nits=NITS,
        burnin=BURNIN, **jl_kw))
    jt_ms = events_ms(lambda: cuda_joint.joint_plain(
        jspecs, jplans, jy0s, jidx, jth_all, jseed, nits=short, burnin=0,
        stepper=jstep, **jl_kw))
    joint_plain_ms = jt_ms / (short - 1) * (NITS - 1)
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
    print(f"ensemble: {W_main} walkers in {W_main // tile_main} ensembles, "
          f"{1 + 2 * (NITS - 1)} device launches per run")
    print(f"survey kernel 1000 draws: {sv_ms:.4f} ms; twin "
          f"{sv_plain_ms:.3f} ms")
    for sampler, (wall_s, _, stages) in runs.items():
        print(f"MCMC({sampler}) wall time: {wall_s:.3f} s; stages "
              + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items()))
    print(f"build {build_s:.3f} s ({smi_line})")

    # bounds: float32 operations from the twins on the CPU, bytes from the
    # main path's shapes
    cpu = torch.device("cpu")
    plan_bytes = sum(a.nbytes for a in cuda_mh.plan_tables(spec, plan, y0,
                                                           "dopri5"))
    one = torch.as_tensor(seeds[:1].T.copy(), device=cpu)
    sv_ops = 1000 * fp32_ops(lambda: cuda_mh.survey_plain(spec, plan, y0,
                                                          one))
    sv_bound = bound(sv_ops, plan_bytes + 1000 * (3 + 1) * 4)
    R = NITS - 1 - BURNIN
    init, step, rec = per_iteration_ops(lambda n, b: cuda_mh.mh_plain(
        spec, plan, y0, one, seed, nits=n, burnin=b, walk=walk,
        walked=(True,) * 3, num=3))
    mh_bound = bound(CHAINS * (init + (NITS - 1) * step + R * rec),
                     plan_bytes + CHAINS * 3 * 4 + R * CHAINS * (3 + 4) * 4)
    ens_one = torch.as_tensor(cuda_mh.ensemble_init(
        seeds[:256], seed, 256, mask, 0.01).T.copy(), device=cpu)
    init, step, rec = per_iteration_ops(lambda n, b: cuda_mh.ensemble_plain(
        spec, plan, y0, ens_one, seed, tile=256, nits=n, burnin=b, a=2.0,
        walk=mask, walked=(True,) * 3, num=3, W0=256))
    ens_bound = bound(
        (W_main * (init + (NITS - 1) * step) + CHAINS * R * rec) / 256,
        plan_bytes + W_main * 3 * 4 + R * CHAINS * (3 + 4) * 4)
    init, step, rec = per_iteration_ops(lambda n, b: cuda_pt.pt_plain(
        spec, plan, y0, one, seed, nits=n, burnin=b, **pt_main))
    pt_bound = bound(CHAINS * (init + (NITS - 1) * step + R * rec),
                     plan_bytes + CHAINS * 3 * 4 + R * CHAINS * (3 + 5) * 4)
    jone = jth_all[:, :1].cpu().contiguous()
    init, step, rec = per_iteration_ops(lambda n, b: cuda_joint.joint_plain(
        jspecs, jplans, jy0s, jidx, jone, jseed, nits=n, burnin=b,
        stepper=jstep, **jl_kw))
    D, K_exp = jth_all.shape[0], len(jspecs)
    jplan_bytes = sum(a.nbytes for a in cuda_joint.joint_tables(
        jspecs, jplans, jy0s, jidx, jstep)[:3])
    joint_bound = bound(CHAINS * (init + (NITS - 1) * step + R * rec),
                        jplan_bytes + CHAINS * D * 4
                        + R * CHAINS * (D + K_exp + 2) * 4)
    # the selection's work depends on the data (a masked sum, K * K * S
    # adds, in each block whose ladder dipped), so average 8 chains' counts
    pf_counts = [per_iteration_ops(lambda n, b, c=c: cuda_pf.pmmh_plain(
        pspec, pf_plan, py0, pth_all[:, c:c + 1].cpu().contiguous(), pseed,
        nits=n, burnin=b, **pf_run)) for c in range(8)]
    init, step, rec = (sum(v) / len(pf_counts) for v in zip(*pf_counts))
    print("PMMH float32 operations per iteration of 8 chains: "
          f"{sorted(c[1] for c in pf_counts)} (a masked sum adds "
          f"{n_part ** 2 * len(pspec.snames)})")
    pf_R = PF_NITS - 1 - pf_burn
    pf_plan_bytes = sum(a.nbytes for a in cuda_mh.plan_tables(
        pspec, pf_plan, py0, "euler"))
    P_pf = pth_all.shape[0]
    pf_bound = bound(n_pf * (init + (PF_NITS - 1) * step + pf_R * rec),
                     pf_plan_bytes + (n_pf + 7) * P_pf * 4
                     + pf_R * n_pf * (P_pf + 2) * 4)
    for label, (b_ms, by) in (("survey", sv_bound), ("MH", mh_bound),
                              ("ensemble", ens_bound), ("PT", pt_bound),
                              ("joint", joint_bound), ("PMMH", pf_bound)):
        print(f"{label} bound: {b_ms:.4f} ms, by {by}")

    phase("where the time goes: one more MH MCMC under torch.profiler")
    from torch.profiler import ProfilerActivity, profile
    fw = framework()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof, contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        fw.MCMC(chain_inits=CHAINS, iterations_per_chain=NITS,
                fitsurvey_samples=1000, sd_fitdistance=6.0,
                print_report=True, profile=True)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    dev_us = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", 0) or 0
        if t > 0:
            dev_us[ev.key] = t
    busy = sum(dev_us.values()) / 1e6
    print(f"profiled MCMC wall {prof_wall:.3f} s; stages "
          + ", ".join(f"{k} {v:.3f} s" for k, v in fw.last_profile.items()))
    if busy > 0:
        print(f"device busy {busy:.4f} s = {100 * busy / prof_wall:.2f} % "
              f"of wall (idle {100 - 100 * busy / prof_wall:.2f} %)")
        for k, v in sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {v / 1e3:10.3f} ms  {k[:90]}")
    else:
        print("device time: not measured (the profiler recorded none)")

    csrc = "odelib_tpu_torch/ops/csrc/"

    def row(name, src, replaces, sampler, err, ms, plain_ms, b):
        return {"name": name, "route": "cuda", "source": csrc + src,
                "replaces": replaces, "launches": runs[sampler][1][name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b[0], "bound_by": b[1], "library_ms": None}
    print(json.dumps({"kernels": [
        row("survey_fused", "mh.cu", "odelib_tpu/ops/pallas_mh.py:1765",
            "mh", survey_err, sv_ms, sv_plain_ms, sv_bound),
        row("metropolis_hastings_fused", "mh.cu",
            "odelib_tpu/ops/pallas_mh.py:1017", "mh", mh_err, mh_ms,
            mh_plain_ms, mh_bound),
        row("ensemble_fused", "ensemble.cu",
            "odelib_tpu/ops/pallas_mh.py:1514", "ensemble", ens_err, ens_ms,
            ens_plain_ms, ens_bound),
        row("parallel_tempering_fused", "pt.cu",
            "odelib_tpu/ops/pallas_pt.py:49", "pt", pt_err, pt_ms,
            pt_plain_ms, pt_bound),
        row("joint_metropolis_hastings_fused", "joint.cu",
            "odelib_tpu/ops/pallas_joint.py:347", "joint", joint_err,
            joint_ms, joint_plain_ms, joint_bound),
        row("pmmh_fused", "pf.cu", "odelib_tpu/ops/pallas_pf.py:130",
            "pmmh", pf_err, pf_ms, pf_plain_ms, pf_bound)]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
