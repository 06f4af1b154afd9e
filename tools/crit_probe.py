"""Run chip_smoke.py's model-criticism phases alone on one card.

    python3 tools/crit_probe.py

Builds the main paths' full-width posteriors as chip_smoke.py's main paths
do (zero_i on the demo: MCMC(sampler='mh') at 10,000 chains x 1,000, the
same with use_priors=True and substeps='auto', and config 9's JointFit
with both; the MH and joint kernels build at first use), then calls
chip_smoke.py's ``crit_phases`` on them. Prints the card's name and power
limit, each run's wall seconds, then the phases' own lines. A quick check
of the crit phases' checks and seconds before a whole run.
"""
import contextlib
import io
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import gc

    import chip_smoke as cs
    from odelib_tpu_torch import JointFit

    gc.callbacks.append(cs._gc_probe)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    runs = dict(chain_inits=cs.CHAINS, iterations_per_chain=cs.NITS,
                fitsurvey_samples=1000)
    posts = {}
    for key, kw in (("mh", {}),
                    ("mh_priors", dict(use_priors=True, substeps="auto"))):
        fw = cs.demo_framework()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            post = fw.MCMC(sd_fitdistance=6.0, sampler="mh", **runs, **kw)
        print(f"{key}: MCMC {time.perf_counter() - t0:.1f} s, "
              f"{len(post):,} rows", flush=True)
        posts[key] = (fw, post)
    jf = JointFit(cs.demo_joint_pair(), shared=["phi", "beta"],
                  random_seed=0)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        jpost = jf.MCMC(substeps="auto", use_priors=True, **runs)
    print(f"joint: MCMC {time.perf_counter() - t0:.1f} s, {len(jpost):,} "
          "rows", flush=True)
    t0 = time.perf_counter()
    cs.crit_phases(posts["mh"], posts["mh_priors"], (jf, jpost),
                   cs.demo_framework, cs.demo_joint_pair, smi)
    print(f"crit phases alone: {time.perf_counter() - t0:.1f} s",
          flush=True)


if __name__ == "__main__":
    main()
