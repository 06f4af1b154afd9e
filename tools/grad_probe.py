"""Run chip_smoke.py's gradient-sampler phases alone on one card.

    python3 tools/grad_probe.py

Builds chip_smoke.py's zero_i framework and joint pair (the same
constructors as its ``main``) and calls ``grad_phases`` with 10,000 start
points drawn around the fit centre (``CENTRE x exp(N(0, 0.05))``, numpy
seed 0) in place of scan (a)'s final draws, so the phases run without the
rest of the script (no nvcc: they launch no kernel). Prints the card's
name and power limit, then the phases' own lines. A quick check of the
grad phases' checks and seconds before a whole run.
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import numpy as np
    import pandas as pd
    import scipy.stats

    import chip_smoke as cs
    from odelib_tpu_torch import ModelFramework, parameter
    from odelib_tpu_torch.data import load_demo_dataframe
    from odelib_tpu_torch.models import zero_i

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)

    def framework(df=None, ode=None, **kw):
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
        fw_a = framework()
        df = load_demo_dataframe(host="S", virus="V")
        df["abundance"] = df["abundance"] * np.exp(
            np.random.default_rng(7).normal(0, 0.1, len(df)))
        y0_a = fw_a.get_inits(as_dict=True)
        return {"a": fw_a, "b": make_b(df, **{s: 1.13 * float(v)
                                              for s, v in y0_a.items()})}

    rng = np.random.default_rng(0)
    starts = pd.DataFrame(np.array(cs.CENTRE) * np.exp(
        rng.normal(0, 0.05, (10000, 3))), columns=["mu", "phi", "beta"])
    t0 = time.perf_counter()
    cs.grad_phases(framework, joint_pair, starts, smi)
    print(f"grad phases alone: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
