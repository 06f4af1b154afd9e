"""Does a zero dividend take CUDA's IEEE division slow path? Latency of a
dependent chain of divisions on one card.

    python3 tools/kv3_division_probe.py [--n 4096]

Builds (nvcc, the kernels' flags: sm_90a, -O3, -fmad=false) a probe whose
threads each run a chain of ``n`` dependent float32 quotients
q = (x + q * 0) / d, so the dividend stays exactly x and every quotient
waits for the last, by ``__fdiv_rn`` (the IEEE division: FCHK, a range
check, branches to a slow-path subroutine) and by ``kv3_quotient`` (ops/
build.py ``KV3_QUOTIENT``, step_kvaerno3's: a reciprocal taken once, then
the corrected product, scaled, no branch). The dividend x is 0 (chord
Newton's converged corrections), 1e-3 (an ordinary one) or 1e-40 (a
subnormal, which IEEE's slow path handles and for which kv3_quotient
raises the step's flag: the chain's last value prints as -1), the divisor
d ~1.2
(inside the 2^+-0.33 of the step's diagonal). One warp a block, one block
an SM. Prints the card (``nvidia-smi``) and, per (function, x), the
nanoseconds a quotient (CUDA events, the best of 5 launches) and the
chain's last quotient, and a last line of JSON {label: ns}.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r"""
#include <cuda_runtime.h>
%(quotient)s
template <int MODE>
__global__ void chain(float x, float d0, int n, float* out) {
  const float d = d0 + (float)threadIdx.x * 1e-7f;
  bool bad = false;
  const Kv3Div v = kv3_divisor(d, __frcp_rn(d), bad);
  float q = 0.0f;
  for (int i = 0; i < n; ++i) {
    const float xi = x + q * 0.0f;      // exactly x, after the last q
    q = MODE ? kv3_quotient(xi, v, bad) : __fdiv_rn(xi, d);
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = bad ? -1.0f : q;
}
extern "C" int probe(int mode, float x, float d, int n, int blocks,
                     float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode) chain<1><<<blocks, 32, 0, s>>>(x, d, n, out);
  else chain<0><<<blocks, 32, 0, s>>>(x, d, n, out);
  return (int)cudaGetLastError();
}
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        sys.exit("kv3_division_probe: needs a CUDA card")
    from odelib_tpu_torch.ops import build
    out_dir = os.path.join(ROOT, "odelib_tpu_torch", "_build", "kv3_probe")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "probe.cu")
    lib_path = os.path.join(out_dir, "libprobe.so")
    with open(src, "w") as f:
        f.write(SOURCE % {"quotient": build.KV3_QUOTIENT})
    subprocess.run([build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
                    "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.probe.argtypes = [ctypes.c_int, ctypes.c_float, ctypes.c_float,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card {smi}", flush=True)
    dev = torch.device("cuda")
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(blocks * 32, device=dev)
    stream = build.stream(dev)
    ns = {}
    for mode, fn in ((0, "__fdiv_rn"), (1, "kv3_quotient")):
        for x in (0.0, 1e-3, 1e-40):
            best = None
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                rc = lib.probe(mode, x, 1.2, args.n, blocks, out.data_ptr(),
                               stream)
                end.record()
                torch.cuda.synchronize()
                if rc:
                    sys.exit(f"probe launch failed: {rc}")
                ms = start.elapsed_time(end)
                best = ms if best is None else min(best, ms)
            label = f"{fn}, x = {x:g}"
            ns[label] = best * 1e6 / args.n
            print(f"{label}: {ns[label]:.2f} ns a quotient (last "
                  f"{float(out[0]):.6g})", flush=True)
    print(json.dumps(ns))


if __name__ == "__main__":
    main()
