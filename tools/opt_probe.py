"""Run chip_smoke.py's inference-method phases alone on one card.

    python3 tools/opt_probe.py

Calls chip_smoke.py's ``opt_phases`` with its own zero_i framework and
config 9 pair (``demo_framework``, ``demo_joint_pair``), so the phases run
without the rest of the script (no nvcc: they launch no kernel). Prints
the card's name and power limit, then the phases' own lines. A quick
check of the opt phases' checks and seconds before a whole run.
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import chip_smoke as cs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    cs.opt_phases(cs.demo_framework, cs.demo_joint_pair, smi)
    print(f"opt phases alone: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
