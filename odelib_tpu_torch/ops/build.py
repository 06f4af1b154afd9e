"""Build and load the CUDA kernels (``csrc/mh.cu``) for one model.

The kernels are compiled with ``nvcc`` into a shared library with a plain
C interface and loaded with ``ctypes``; no PyTorch headers are involved,
so a build takes seconds. The build input is the template source in
``csrc/`` plus ``odelib_gen.cuh``, generated here from the traced RHS
(:meth:`odelib_tpu_torch.rhs.RhsProgram.cuda_source`) and the fixed-step
Dopri5/RK4 steppers. The inputs and the flags are hashed into a directory
under ``odelib_tpu_torch/_build/`` (gitignored), so each model builds
once, at first use, and every later process loads it.
A failed build raises with nvcc's output; a failed launch raises with the
CUDA error. Nothing falls back to the torch twins.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from ..rhs import _f32_literal, trace_rhs
from .runge_kutta import DP_A

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("mh.cu",)
# -Xptxas -v: registers, stack and spills of each kernel go to nvcc.log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"


def _stage_sum(coefs, ks, s):
    terms = [f"{_f32_literal(a)} * {k}[{s}]" for a, k in zip(coefs, ks)
             if a != 0.0]
    return " + ".join(terms)


def stepper_source(n_states: int) -> str:
    """Fixed-step Dopri5 and RK4 over ``y[ODE_S]`` with the step's
    constants ``sf`` (see ``plan_tables``), unrolled with literal float32
    tableau entries in the JAX kernel's summation order."""
    S = n_states
    ks = [f"k{i}" for i in range(6)]
    lines = ["__device__ __forceinline__ void step_dopri5(float* y, "
             "const float* sf, const float* p) {",
             "  const float h = sf[0];",
             f"  float {', '.join(f'{k}[ODE_S]' for k in ks)}, yi[ODE_S];",
             "  rhs(sf[1], y, p, k0);"]
    for i in range(1, 6):
        for s in range(S):
            lines.append(f"  yi[{s}] = y[{s}] + h * "
                         f"({_stage_sum(DP_A[i], ks, s)});")
        lines.append(f"  rhs(sf[{i + 1}], yi, p, k{i});")
    for s in range(S):
        lines.append(f"  y[{s}] = y[{s}] + h * ({_stage_sum(DP_A[6], ks, s)});")
    lines += ["}", "",
              "__device__ __forceinline__ void step_rk4(float* y, "
              "const float* sf, const float* p) {",
              "  float k0[ODE_S], k1[ODE_S], k2[ODE_S], k3[ODE_S], yi[ODE_S];",
              "  rhs(sf[3], y, p, k0);"]
    for src, coef, t_idx, dst in (("k0", 1, 4, "k1"), ("k1", 1, 4, "k2"),
                                  ("k2", 0, 5, "k3")):
        for s in range(S):
            lines.append(f"  yi[{s}] = y[{s}] + sf[{coef}] * {src}[{s}];")
        lines.append(f"  rhs(sf[{t_idx}], yi, p, {dst});")
    for s in range(S):
        lines.append(f"  y[{s}] = y[{s}] + sf[2] * (k0[{s}] + 2.0f * k1[{s}]"
                     f" + 2.0f * k2[{s}] + k3[{s}]);")
    lines += ["}", ""]
    return "\n".join(lines)


def generated_header(program) -> str:
    """``odelib_gen.cuh`` for a traced RHS program."""
    import math
    return "\n".join([
        "// generated by odelib_tpu_torch/ops/build.py; do not edit",
        "#pragma once",
        f"#define ODELIB_TWO_PI {_f32_literal(2.0 * math.pi)}",
        program.cuda_source(), stepper_source(program.n_states)])


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(program) -> Path:
    """Compile the kernels for ``program`` (cached by content hash);
    returns the shared library's path. The compiler's output and the
    build's seconds are kept beside it in ``nvcc.log``."""
    header = generated_header(program)
    h = hashlib.sha256()
    for part in (header, *((CSRC / s).read_text() for s in SOURCES),
                 " ".join(NVCC_FLAGS)):
        h.update(part.encode())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / "libodelib_mh.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "odelib_gen.cuh").write_text(header)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-I", str(out_dir), "-o", tmp,
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    (out_dir / "nvcc.log").write_text(
        f"{' '.join(cmd)}\nseconds: {secs:.3f}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


_LIBS = {}          # by library path
_BY_PROGRAM = {}    # by traced RHS program (skips regenerating the header)
_P = ctypes.c_void_p
_I = ctypes.c_int


def load_kernels(spec):
    """The loaded kernel library for ``spec``'s RHS (build at first use)."""
    program = trace_rhs(spec.rhs, len(spec.snames), spec.theta_size)
    lib = _BY_PROGRAM.get(program)
    if lib is not None:
        return lib
    path = str(build(program))
    lib = _LIBS.get(path)
    if lib is None:
        lib = ctypes.CDLL(path)
        lib.odelib_survey.argtypes = [_P, _P, _P, _P, _I, _I, _P]
        lib.odelib_survey.restype = _I
        lib.odelib_mh.argtypes = [_P] * 9 + [_I, _I, _I, ctypes.c_uint,
                                             ctypes.c_float, _I, _P]
        lib.odelib_mh.restype = _I
        lib.odelib_error_string.argtypes = [_I]
        lib.odelib_error_string.restype = ctypes.c_char_p
        _LIBS[path] = lib
    _BY_PROGRAM[program] = lib
    return lib


def check(lib, rc: int, what: str):
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.odelib_error_string(rc).decode()
        raise RuntimeError(f"CUDA {what} kernel launch failed: {msg} ({rc})")


def stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
