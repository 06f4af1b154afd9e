"""Time the chain kernels' whole runs at the main paths' shapes on one card.

    python3 tools/kernel_times.py [--tree DIR] [--reps N]

Imports ``odelib_tpu_torch`` from ``DIR`` (default: this checkout), builds
its libraries, and times with CUDA events, after a warm-up launch, the
whole-run launches of ``mh_kernel``, ``ens_kernel`` and ``pt_kernel`` (each
prior-free and with the demo's three lognormal priors; ``mh_kernel`` also on
the 21-step schedule [3, 1 x 14, 2, 2] that ``substeps='auto'`` calibrates
on the demo), ``joint_kernel`` (config 9: zero_i on the demo and on it
perturbed, numpy seed 7, sharing phi and beta) and ``pf_kernel``,
at the shapes of ``chip_smoke.py``'s main paths: 10,000 chains x 1,000
iterations from the best of 4,096 LHS draws of the demo fit (the ensemble's
10,000 walkers padded to 12,288 in ensembles of 4,096; PT on 4 rungs), and
PMMH on 10,240 chains x 128 particles x 200 proposals of the GBM. Prints
the card (``nvidia-smi``), each kernel's registers, stack and spills from
its library's ``nvcc.log``, and a last line of JSON {label: ms}.

To weigh a change to a kernel, unpack the parent (``git archive``) into the
gitignored ``_archive/`` and run both trees in one call, in turns:
parent, change, change, parent (``--tree _archive/parent``).
"""
import argparse
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor


def events_ms(fn, reps):
    import torch
    fn()                                  # warm-up
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
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import scipy.stats
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_times: needs a CUDA card")
    import odelib_tpu_torch
    if not os.path.abspath(odelib_tpu_torch.__file__).startswith(tree):
        sys.exit(f"kernel_times: odelib_tpu_torch is not {tree}'s")
    from odelib_tpu_torch import ModelFramework, parameter
    from odelib_tpu_torch import distributions as D
    from odelib_tpu_torch.data import load_demo_dataframe
    from odelib_tpu_torch.models import zero_i
    from odelib_tpu_torch.ops import build, cuda_mh, cuda_pf, cuda_pt
    from odelib_tpu_torch.ops.priors import prior_table
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"tree {tree}; card {smi}", flush=True)
    dev = torch.device("cuda")

    fw = ModelFramework(
        ODE=zero_i.rhs, parameter_names=list(zero_i.pnames),
        state_names=list(zero_i.snames),
        dataframe=load_demo_dataframe(host="S", virus="V"),
        mu=parameter(scipy.stats.lognorm, {"s": 3, "scale": 1e-8},
                     random_seed=1),
        phi=parameter(scipy.stats.lognorm, {"s": 3, "scale": 1e-8},
                      random_seed=2),
        beta=parameter(scipy.stats.lognorm, {"s": 1, "scale": 25},
                       random_seed=3),
        t_steps=288, device="cuda", ode_style="jax")
    spec, obs, tf, y0 = (fw._spec, fw._obsdata_fit_host, fw._times_fit,
                         fw.get_inits())

    def gbm(y, t, ps):
        return np.array([ps[0] * y[0]])

    def gnoise(y, t, ps):
        return np.array([0.3 * y[0]])
    rng = np.random.default_rng(42)
    t_obs = np.arange(1, 9) * 0.5
    z, zs = np.log(2.0), []
    for dt in np.diff(np.concatenate([[0.0], t_obs])):
        z = z + (0.4 - 0.5 * 0.3 ** 2) * dt + 0.3 * np.sqrt(dt) * rng.normal()
        zs.append(z)
    log_o = np.array(zs) + 0.15 * rng.normal(size=len(zs))
    import pandas as pd
    pfw = ModelFramework(
        ODE=gbm, diffusion=gnoise, parameter_names=["mu"],
        state_names=["N"], dataframe=pd.DataFrame({
            "organism": "N", "time": t_obs, "abundance": np.exp(log_o),
            "log_sigma": 0.15}), t_steps=41, N=2.0,
        mu=parameter(scipy.stats.lognorm, {"s": 0.5, "scale": 0.4}),
        device="cuda")
    def load(f, diffusion=False):
        # a tree from before the observation models builds without scoring
        kw = {"scoring": [cuda_mh.scoring(cuda_mh._build_plan(
            f._spec, f._obsdata_fit_host, f._times_fit, 1))]} \
            if hasattr(cuda_mh, "scoring") else {}
        return build.load_kernels(f._spec, (), diffusion, **kw)
    with ThreadPoolExecutor(2) as ex:       # two nvcc processes at once
        libs = list(ex.map(lambda a: load(*a), [(fw,), (pfw, True)]))
    for lib in libs:
        log = open(os.path.join(os.path.dirname(lib._name),
                                "nvcc.log")).read()
        name = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
            elif name and re.search(r"(mh|ens|pt|pf|joint)_kernel",
                                    name) and (
                    "registers" in line or "spill" in line):
                short = re.search(r"(\w+_kernelIL[^E]*E[^E]*E)", name)
                print(f"{short.group(1) if short else name}: "
                      f"{line.strip()}")

    draws = fw._theta_from_df(fw._lhs_samples(4096)).astype(np.float32)
    plan = cuda_mh._build_plan(spec, obs, tf, 4)
    auto_plan = cuda_mh._build_plan(spec, obs, tf,
                                    (3,) + (1,) * (len(tf) - 4) + (2, 2))
    ct = cuda_mh.survey_fused(spec, obs, tf, y0,
                              torch.as_tensor(draws, device=dev)).cpu()
    ct = ct.numpy()
    fin = np.isfinite(ct)
    order = np.argsort(np.where(fin, ct, np.inf))
    seeds = draws[order[np.arange(10000) % max(fin.sum(), 1)]]
    th = torch.as_tensor(seeds, device=dev).t().contiguous()
    walk = (0.05,) * 3
    demo = prior_table(fw.parameters[p].tdist for p in zero_i.pnames)
    mh_kw = dict(nits=1000, burnin=500, walk=walk, walked=(True,) * 3,
                 num=3)
    tile, mask = 4096, (1.0, 1.0, 1.0)
    start = torch.as_tensor(np.ascontiguousarray(cuda_mh.ensemble_init(
        seeds, 11, tile, mask, 0.01).T), device=dev)
    ens_kw = dict(tile=tile, nits=1000, burnin=500, a=2.0, walk=mask,
                  walked=(True,) * 3, num=3, W0=10000)
    sc, bt, db = cuda_pt.ladder_constants((1.0, 2.0, 4.0, 8.0), 0.05, mask)
    pt_kw = dict(nits=1000, burnin=500, scales=sc, walked=(True,) * 3,
                 betas=bt, dbetas=db, swap_every=1, num=3)
    pf_plan = cuda_mh._build_plan(pfw._spec, pfw._obsdata_fit_host,
                                  pfw._times_fit, 40)
    pf_th = torch.as_tensor(np.exp(np.random.default_rng(1).normal(
        np.log(0.4), 0.3, (1, 10240))).astype(np.float32), device=dev)
    pf_kw = dict(K=128, nits=200, burnin=100, walk=(1.0,), walked=(True,),
                 rwalk_std=0.4, prior=prior_table(
                     [D.LogNormal(s=0.5, scale=0.4)]), adapt=True,
                 target=0.3, adapt_rate=0.15)
    from odelib_tpu_torch.ops import cuda_joint
    obs_b = obs._replace(log_abundance=obs.log_abundance + np.random.
                         default_rng(7).normal(0, 0.1, len(obs.log_abundance)))
    plan_b = cuda_mh._build_plan(spec, obs_b, tf, 4)
    j_th = th[[1, 2, 0, 0]].contiguous()        # phi, beta, a:mu, b:mu
    j_kw = dict(nits=1000, burnin=500, walk=(0.05,) * 4, walked=(True,) * 4)
    runs = {
        "mh": cuda_mh.mh_launcher(spec, plan, y0, "dopri5", th, 11, **mh_kw),
        "mh, priors": cuda_mh.mh_launcher(spec, plan, y0, "dopri5", th, 11,
                                          prior=demo, **mh_kw),
        "mh, 21 steps": cuda_mh.mh_launcher(spec, auto_plan, y0, "dopri5",
                                            th, 11, **mh_kw),
        "mh, 21 steps, priors": cuda_mh.mh_launcher(
            spec, auto_plan, y0, "dopri5", th, 11, prior=demo, **mh_kw),
        "ensemble": cuda_mh.ensemble_launcher(spec, plan, y0, "dopri5",
                                              start, 11, **ens_kw),
        "ensemble, priors": cuda_mh.ensemble_launcher(
            spec, plan, y0, "dopri5", start, 11, prior=demo, **ens_kw),
        "pt": cuda_pt.pt_launcher(spec, plan, y0, "dopri5", th, 11, **pt_kw),
        "pt, priors": cuda_pt.pt_launcher(spec, plan, y0, "dopri5", th, 11,
                                          prior=demo, **pt_kw),
        "joint": cuda_joint.joint_launcher(
            (spec, spec), (plan, plan_b), (y0, 1.13 * np.asarray(y0)),
            ((2, 0, 1), (3, 0, 1)), "dopri5", j_th, 11, **j_kw),
        "pmmh": cuda_pf.pmmh_launcher(pfw._spec, pf_plan, pfw.get_inits(),
                                      pf_th, 3, **pf_kw),
    }
    times = {}
    for label, launch in runs.items():
        times[label] = events_ms(launch, args.reps)
        print(f"{label}: {times[label]:.3f} ms", flush=True)
    print(json.dumps(times))


if __name__ == "__main__":
    main()
