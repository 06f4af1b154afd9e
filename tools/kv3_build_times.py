"""Time nvcc on the stiff library of a model of many states: the generated
``step_kvaerno3`` (``ops/build.py`` ``kvaerno3_source``) unrolls an S x S
elimination and its triangular solves.

    python3 tools/kv3_build_times.py [--classes N ...]

For each N (default 31 and 40: 33 and 42 states) builds the stiff
(``ODE_KVAERNO3``) library of ``scoring_cases.chain_case(N)``'s model, one
nvcc process at a time, each into a fresh directory, and prints the
seconds, the generated header's lines and each kvaerno3 kernel's registers
and spills (ptxas) from ``nvcc.log``; a last line of JSON.
"""
import argparse
import json
import os
import re
import shutil
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--classes", type=int, nargs="+", default=[31, 40])
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    from odelib_tpu_torch.model import rhs_program
    from odelib_tpu_torch.ops import build, cuda_mh
    from scoring_cases import chain_case
    out = {}
    for n in args.classes:
        spec, obs, tf, _ = chain_case(n)
        sc = cuda_mh.scoring(cuda_mh._build_plan(spec, obs, tf, 1))
        prog = rhs_program(spec)
        header = build.generated_header(prog, None, (), [sc], True)
        t0 = time.perf_counter()
        lib = build.build(prog, None, (), [sc], True)
        secs = time.perf_counter() - t0
        log = open(os.path.join(os.path.dirname(lib), "nvcc.log")).read()
        label = f"S={n + 2}"
        out[label] = secs
        print(f"{label}: nvcc {secs:.1f} s, header "
              f"{len(header.splitlines())} lines", flush=True)
        name = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
            elif name and "ILi3E" in name and (
                    "registers" in line or "spill" in line):
                print(f"  {name[:60]}: {line.strip()}")
        shutil.rmtree(os.path.dirname(lib), ignore_errors=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
