"""Does torch.profiler record the ensemble kernel's launch before and
after autograd, Cholesky and the gradient samplers on the card?

    python3 tools/profiler_probe.py

Runs ``MCMC(sampler='ensemble')`` on zero_i and the demo (10,000
walkers x 1,000, as chip_smoke.py's profiler pass) once unprofiled (the
build), twice under ``torch.profiler``, MH once, then one gradient of
10,000 lanes (``samplers/hmc.py`` ``potential``), the ensemble twice more,
a dense-mass ChEES HMC and an adaptive-Metropolis run at 64 chains, and
the ensemble twice more, printing each profiled run's ``ens_kernel`` /
``mh_kernel`` launches, its device activities and their summed ms.
"""
import contextlib
import io
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import numpy as np
    import scipy.stats
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from odelib_tpu_torch import ModelFramework, parameter
    from odelib_tpu_torch import random as jr
    from odelib_tpu_torch.data import load_demo_dataframe
    from odelib_tpu_torch.models import zero_i
    from odelib_tpu_torch.samplers import amh, hmc

    def framework():
        pri = dict(
            mu=parameter(scipy.stats.lognorm, {"s": 3, "scale": 1e-8},
                         random_seed=1),
            phi=parameter(scipy.stats.lognorm, {"s": 3, "scale": 1e-8},
                          random_seed=2),
            beta=parameter(scipy.stats.lognorm, {"s": 1, "scale": 25},
                           random_seed=3))
        return ModelFramework(
            ODE=zero_i.rhs, parameter_names=list(zero_i.pnames),
            state_names=list(zero_i.snames),
            dataframe=load_demo_dataframe(host="S", virus="V"),
            t_steps=288, device="cuda", ode_style="jax", **pri)

    def run(sampler, profiled=True):
        fw = framework()
        call = dict(chain_inits=10000, iterations_per_chain=1000,
                    fitsurvey_samples=1000, sd_fitdistance=6.0,
                    sampler=sampler, print_report=True, profile=True)
        with contextlib.redirect_stdout(io.StringIO()):
            if not profiled:
                fw.MCMC(**call)
                torch.cuda.synchronize()
                return
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fw.MCMC(**call)
                torch.cuda.synchronize()
        k = cs.device_kernels(prof)
        ours = {n: len(v) for n, v in k.items()
                if "ens_kernel" in n or "mh_kernel" in n}
        total = sum(e - s for v in k.values() for s, e in v) / 1e3
        print(f"{sampler}: {ours}, {sum(len(v) for v in k.values())} "
              f"activities, {total:.3f} ms", flush=True)

    run("ensemble", profiled=False)
    run("ensemble")
    run("ensemble")
    run("mh")
    fw = framework()
    args = (fw._spec, fw._obsdata_fit_host, fw._times_fit, fw.get_inits())
    th = torch.as_tensor(np.array(cs.CENTRE) * np.exp(
        np.random.default_rng(0).normal(0, 0.05, (10000, 3))),
        device="cuda")
    hmc.potential(*args, th, num_params=3)(torch.log(th))
    torch.cuda.synchronize()
    print("one gradient of 10,000 lanes done", flush=True)
    run("ensemble")
    run("ensemble")
    keys = jr.fold_in(jr.PRNGKey(0), torch.arange(64, device="cuda"))
    hmc.hamiltonian_mc(*args, th[:64], keys, nits=4, burnin=2,
                       n_leapfrog=1, dense_mass=True, path_adapt=True,
                       max_leapfrog=2)
    amh.adaptive_metropolis(*args, th[:64], keys, nits=5, burnin=3,
                            adapt_start=1)
    torch.cuda.synchronize()
    print("dense ChEES HMC and AMH done", flush=True)
    run("ensemble")
    run("ensemble")


if __name__ == "__main__":
    main()
