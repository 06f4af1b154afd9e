"""The Robertson fit on the default grid, in both packages, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/robertson_default_grid.py [--atol A]

Builds ``models.get('robertson').framework(scoring_cases.robertson_frame())``
with the default ``t_steps`` (1,000 points over [0, 1e3], spaced ~1.001) in
``odelib_tpu`` and in ``odelib_tpu_torch``, and runs
``MCMC(sampler='mh', method='kvaerno3', substeps='auto')`` on 16 chains x 20
iterations from 200 survey draws: the JAX package through its Pallas kernels
in interpret mode, the port through its twins on the CPU. Prints, for each,
the compact grid, the calibrated schedule and the posterior's finite-chi
fraction, and the chi of the default rates on that schedule. On this grid
the observations from 1e-5 to 0.5 snap to t = 0 or 1, and the first
interval's Kvaerno3 steps start from y2 = 0, where the step's one Jacobian
holds none of the stiffness its stages meet. Takes about 2 minutes, most of
it the interpret-mode compiles.
"""
import argparse
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(pkg, fw, **kw):
    t0 = time.perf_counter()
    post = fw.MCMC(sampler="mh", method="kvaerno3", substeps="auto",
                   chain_inits=16, iterations_per_chain=20,
                   fitsurvey_samples=200, print_report=False, **kw)
    last = post[post.iteration == post.iteration.max()]
    print(f"{pkg}: compact grid {len(fw._times_fit)} points, schedule "
          f"{[int(s) for s in fw._auto_schedule]}, finite chi "
          f"{float(np.isfinite(post.chi).mean())}, mean final acceptance "
          f"{float(last.acceptance_ratio.mean())} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return fw


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--atol", type=float, default=None,
                    help="the framework's atol (default: the model's)")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import torch

    from odelib_tpu import models as jm
    from odelib_tpu_torch import models as tm
    from odelib_tpu_torch.model import chi_of_theta
    from scoring_cases import robertson_frame

    kw = {} if args.atol is None else {"atol": args.atol}
    df = robertson_frame()
    jfw = run("odelib_tpu (Pallas, interpret mode)",
              jm.get("robertson").framework(df, **kw), backend="pallas",
              pallas_interpret=True)
    tfw = run("odelib_tpu_torch (twins, CPU)",
              tm.get("robertson").framework(df, device="cpu", **kw))
    if tuple(jfw._auto_schedule) != tuple(tfw._auto_schedule):
        print("the two packages calibrated different schedules")
    theta = torch.tensor([tm.robertson.default_theta], dtype=torch.float64)
    chi = chi_of_theta(tfw._spec, tfw._obsdata_fit_host, theta,
                       tfw.get_inits(), tfw._times_fit,
                       method="fixed_kvaerno3",
                       substeps=list(tfw._auto_schedule))
    print(f"odelib_tpu_torch: chi of the default rates on that schedule, "
          f"float64: {float(chi[0])}")


if __name__ == "__main__":
    main()
