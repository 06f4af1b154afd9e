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

    import chip_smoke as cs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)

    rng = np.random.default_rng(0)
    starts = pd.DataFrame(np.array(cs.CENTRE) * np.exp(
        rng.normal(0, 0.05, (10000, 3))), columns=["mu", "phi", "beta"])
    t0 = time.perf_counter()
    cs.grad_phases(cs.demo_framework, cs.demo_joint_pair, starts, smi)
    print(f"grad phases alone: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
