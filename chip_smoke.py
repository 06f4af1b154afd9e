"""Drive odelib_tpu_torch's main path once on one CUDA card.

    python3 chip_smoke.py

Phases, each failing the script if it fails:

1. device: the card's name and power limit (nvidia-smi); exits non-zero
   without CUDA;
2. build: both kernels (ops/csrc/mh.cu) from the checkout's sources into a
   clean build directory, with the build's seconds;
3. kernel versus twin on the card, at the main-path model (zero_i on the
   demo data, t_steps=288, substeps=4): the survey on 4096 LHS draws (chi
   rtol 1e-5, equal non-finite masks) and MH on 1024 chains x 200
   iterations (identical accept sequences up to documented ulp ties,
   records rtol 1e-5);
4. the main path: ModelFramework(..., device='cuda').MCMC(chain_inits=
   10000, iterations_per_chain=1000, fitsurvey_samples=1000,
   sd_fitdistance=6.0) with launch counts reset just before and read just
   after, the posterior's columns, finite chi, mean acceptance in
   [0.1, 0.6] and the printed Fitting Report;
5. times: each kernel launch against its plain torch twin on the card at
   the main path's shapes (CUDA events), the MCMC wall time with its stage
   breakdown, and the device's busy share of one more MCMC run under
   torch.profiler.

Prints the device line and a JSON line of kernels before the last line,
and as the last line ``{"ok": true, "device": {...}}``.
"""
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name):
    print(f"== {name}", flush=True)


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

    from odelib_tpu_torch import ModelFramework, parameter
    from odelib_tpu_torch.data import load_demo_dataframe
    from odelib_tpu_torch.models import zero_i
    from odelib_tpu_torch.ops import build, cuda_mh
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

    def framework(t_steps=288):
        return ModelFramework(
            ODE=zero_i.rhs, parameter_names=list(zero_i.pnames),
            state_names=list(zero_i.snames),
            dataframe=load_demo_dataframe(host="S", virus="V"),
            mu=parameter(scipy.stats.lognorm, {"s": 3, "scale": 1e-8},
                         random_seed=1),
            phi=parameter(scipy.stats.lognorm, {"s": 3, "scale": 1e-8},
                          random_seed=2),
            beta=parameter(scipy.stats.lognorm, {"s": 1, "scale": 25},
                           random_seed=3),
            t_steps=t_steps, device="cuda", ode_style="jax")

    fw = framework()
    spec, obs, tf, y0 = (fw._spec, fw._obsdata_fit_host, fw._times_fit,
                         fw.get_inits())
    print(f"compact grid: {len(tf)} points, {len(obs.log_abundance)} "
          "observations", flush=True)

    # -- 2. build -------------------------------------------------------------
    phase("build")
    shutil.rmtree(build.BUILD_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    lib = build.load_kernels(spec)
    build_s = time.perf_counter() - t0
    log = open(os.path.join(os.path.dirname(lib._name), "nvcc.log")).read()
    print("\n".join(line for line in log.splitlines()
                    if "seconds" in line or "registers" in line))
    print(f"build seconds: {build_s:.3f}", flush=True)

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
    th0 = torch.as_tensor(draws[order[np.arange(C) % max(fin.sum(), 1)]],
                          device=dev)
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
    acc_k = np.diff(np.concatenate([np.zeros((1, C)), rec_k[4]
                                    * np.arange(1, nits)[:, None]]), axis=0)
    acc_t = np.diff(np.concatenate([np.zeros((1, C)), rec_t[4]
                                    * np.arange(1, nits)[:, None]]), axis=0)
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

    # -- 4. the main path -------------------------------------------------
    phase("main path: ModelFramework(...).MCMC")
    fw = framework()
    out = io.StringIO()
    cuda_mh.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        post = fw.MCMC(chain_inits=10000, iterations_per_chain=1000,
                       fitsurvey_samples=1000, sd_fitdistance=6.0,
                       print_report=True, profile=True)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(cuda_mh.LAUNCHES)
    print(out.getvalue())
    print(f"MCMC wall seconds: {wall_s:.3f}; launches {launches}; stages "
          + ", ".join(f"{k} {v:.3f} s" for k, v in fw.last_profile.items()))
    cols = ["mu", "phi", "beta", "chi", "rsquared", "aic", "iteration",
            "acceptance_ratio", "chain#", "all_rejected"]
    if list(post.columns) != cols:
        fail(f"posterior columns {list(post.columns)}")
    if len(post) != 10000 * 499 or post["chain#"].nunique() != 10000:
        fail(f"posterior has {len(post)} rows")
    finite = float(np.isfinite(post.chi.to_numpy()).mean())
    last = post[post.iteration == post.iteration.max()]
    mean_acc = float(last.acceptance_ratio.mean())
    print(f"finite chi fraction {finite}, mean final acceptance "
          f"{mean_acc:.4f}")
    if finite != 1.0:
        fail(f"finite chi fraction {finite}")
    if not 0.1 <= mean_acc <= 0.6:
        fail(f"mean final acceptance {mean_acc}")
    if "Fitting Report" not in out.getvalue():
        fail("the Fitting Report did not print")
    if min(launches.values()) < 1:
        fail(f"a kernel of the main path never launched: {launches}")
    if not isinstance(post, pd.DataFrame):
        fail("MCMC did not return a DataFrame")

    # -- 5. times ---------------------------------------------------------
    phase("times")
    C_main, nits_main = 10000, 1000
    th_main = torch.as_tensor(
        draws[order[np.arange(C_main) % max(fin.sum(), 1)]], device=dev)
    th_main_t = th_main.t().contiguous()
    mh_ms = events_ms(cuda_mh.mh_launcher(
        spec, plan, y0, "dopri5", th_main_t, seed, nits=nits_main,
        burnin=nits_main // 2, walk=walk, walked=(True,) * 3, num=3))
    short = 6        # the twin over 5 proposals, scaled per chain-step
    tw_ms = events_ms(lambda: cuda_mh.mh_plain(
        spec, plan, y0, th_main_t, seed, nits=short, burnin=0, walk=walk,
        walked=(True,) * 3, num=3))
    mh_plain_ms = tw_ms / (short - 1) * (nits_main - 1)
    th_s = torch.as_tensor(draws[:1000], device=dev).t().contiguous()
    sv_ms = events_ms(cuda_mh.survey_launcher(spec, plan, y0, "dopri5",
                                              th_s), reps=50)
    sv_plain_ms = events_ms(lambda: cuda_mh.survey_plain(
        spec, plan, y0, th_s), reps=3)
    rate = C_main * (nits_main - 1) / (mh_ms / 1e3)
    print(f"MH kernel {C_main} x {nits_main}: {mh_ms:.3f} ms "
          f"({rate:.4g} chain-steps/s); twin {tw_ms:.3f} ms for "
          f"{short - 1} proposals -> {mh_plain_ms:.1f} ms scaled")
    print(f"survey kernel 1000 draws: {sv_ms:.4f} ms; twin "
          f"{sv_plain_ms:.3f} ms")
    print(f"MCMC wall time: {wall_s:.3f} s; build {build_s:.3f} s "
          f"({smi_line})")

    phase("where the time goes: one more MCMC under torch.profiler")
    from torch.profiler import ProfilerActivity, profile
    fw = framework()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof, contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        fw.MCMC(chain_inits=10000, iterations_per_chain=1000,
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
    src = "odelib_tpu_torch/ops/csrc/mh.cu"
    print(json.dumps({"kernels": [
        {"name": "survey_fused", "route": "cuda", "source": src,
         "replaces": "odelib_tpu/ops/pallas_mh.py:1765",
         "launches": launches["survey_fused"], "max_abs_err": survey_err,
         "ms": sv_ms, "plain_ms": sv_plain_ms},
        {"name": "metropolis_hastings_fused", "route": "cuda",
         "source": src, "replaces": "odelib_tpu/ops/pallas_mh.py:1017",
         "launches": launches["metropolis_hastings_fused"],
         "max_abs_err": mh_err, "ms": mh_ms, "plain_ms": mh_plain_ms}]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
