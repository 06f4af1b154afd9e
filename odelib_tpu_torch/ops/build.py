"""Build and load the CUDA kernels (``csrc/*.cu``) for one model.

The kernels are compiled with ``nvcc`` into one shared library with a
plain C interface and loaded with ``ctypes``; no PyTorch headers are
involved, so a build takes seconds. The build input is the sources in
``csrc/`` (``mh.cu``, ``ensemble.cu``, ``pt.cu``, ``joint.cu``, ``pf.cu``
and their shared ``common.cuh``) plus ``odelib_gen.cuh``, generated here
from the traced RHS (:meth:`odelib_tpu_torch.rhs.RhsProgram.cuda_source`)
and the fixed-step Dopri5/RK4 steppers, all in one nvcc call. The
particle filter's library of an SDE model adds its traced diffusion to
the header; a joint fit of different models adds each further model as a
``ModelN`` type for the joint kernel. The
inputs and the flags are hashed into a directory under
``odelib_tpu_torch/_build/`` (gitignored), so each model (or set of
models) builds once, at first use, and every later process loads it.
A failed build raises with nvcc's output; a failed launch raises with the
CUDA error. Nothing falls back to the torch twins.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..rhs import _f32_literal, trace_rhs
from .runge_kutta import DP_A

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("mh.cu", "ensemble.cu", "pt.cu", "joint.cu", "pf.cu")
HEADERS = ("common.cuh",)
PT_KMAX = 8         # rungs the PT kernel holds per chain (csrc/pt.cu)
JOINT_KMAX = 8      # experiments of the joint kernel (csrc/joint.cu)
JOINT_DMAX = 64     # joint theta slots per chain (csrc/joint.cu)
PF_KMAX = 512       # particles per PMMH chain, at most 16 a lane (csrc/pf.cu)
# -Xptxas -v: registers, stack and spills of each kernel go to nvcc.log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-DPT_KMAX={PT_KMAX}", f"-DJOINT_KMAX={JOINT_KMAX}",
              f"-DJOINT_DMAX={JOINT_DMAX}", f"-DPF_KMAX={PF_KMAX}")


BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"


def _stage_sum(coefs, ks, s):
    terms = [f"{_f32_literal(a)} * {k}[{s}]" for a, k in zip(coefs, ks)
             if a != 0.0]
    return " + ".join(terms)


def stepper_source(n_states: int, size: str = "ODE_S") -> str:
    """Fixed-step Dopri5 and RK4 over ``y[size]`` with the step's
    constants ``sf`` (see ``plan_tables``), unrolled with literal float32
    tableau entries in the JAX kernel's summation order."""
    S = n_states
    ks = [f"k{i}" for i in range(6)]
    lines = ["__device__ __forceinline__ void step_dopri5(float* y, "
             "const float* sf, const float* p) {",
             "  const float h = sf[0];",
             f"  float {', '.join(f'{k}[{size}]' for k in ks)}, yi[{size}];",
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
              f"  float k0[{size}], k1[{size}], k2[{size}], k3[{size}], "
              f"yi[{size}];",
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


def _model_source(i: int, program) -> str:
    """A further model of a joint fit: its RHS and steppers in namespace
    ``odelib_m<i>`` and the ``Model<i>`` type the joint kernel scores."""
    ns, S, P = f"odelib_m{i}", program.n_states, program.n_params
    fwd = [(f"rhs(float t, const float* y, const float* p, float* dy)",
            "rhs(t, y, p, dy)"),
           ("step_dopri5(float* y, const float* sf, const float* p)",
            "step_dopri5(y, sf, p)"),
           ("step_rk4(float* y, const float* sf, const float* p)",
            "step_rk4(y, sf, p)")]
    return "\n".join(
        [f"// model {i}: traced from {program.name}", f"namespace {ns} {{",
         program.cuda_function("rhs"), stepper_source(S, str(S)), "}",
         f"struct Model{i} {{", f"  static constexpr int S = {S};",
         f"  static constexpr int P = {P};"]
        + [f"  static __device__ __forceinline__ void {sig} {{ "
           f"{ns}::{call}; }}" for sig, call in fwd] + ["};", ""])


def generated_header(program, diffusion=None, extra=()) -> str:
    """``odelib_gen.cuh`` for a traced RHS program; with the traced
    ``diffusion`` of an SDE model, and with the ``extra`` programs of a
    joint fit's other models."""
    import math
    parts = ["// generated by odelib_tpu_torch/ops/build.py; do not edit",
             "#pragma once",
             f"#define ODELIB_TWO_PI {_f32_literal(2.0 * math.pi)}",
             program.cuda_source(), stepper_source(program.n_states)]
    if diffusion is not None:
        parts += ["#define ODE_HAS_DIFFUSION 1",
                  f"// diffusion traced from {diffusion.name}",
                  diffusion.cuda_function("diffusion")]
    if extra:
        parts += [_model_source(i + 1, p) for i, p in enumerate(extra)]
        parts += ["#define ODE_MODELS(X) " + " ".join(
                      f"X({i})" for i in range(len(extra) + 1)),
                  "#define ODE_PMAX " + str(max(
                      p.n_params for p in (program, *extra)))]
    return "\n".join(parts)


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(program, diffusion=None, extra=()) -> Path:
    """Compile the kernels for ``program`` (with an SDE's ``diffusion`` and
    a joint fit's ``extra`` programs; cached by content hash); returns the
    shared library's path. The compiler's output and the build's seconds
    are kept beside it in ``nvcc.log``."""
    header = generated_header(program, diffusion, extra)
    h = hashlib.sha256()
    for part in (header, *((CSRC / s).read_text()
                           for s in SOURCES + HEADERS),
                 " ".join(NVCC_FLAGS)):
        h.update(part.encode())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / "libodelib_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "odelib_gen.cuh").write_text(header)
    tmp = out_dir / f"{lib.name}.{os.getpid()}"
    cmd = [nvcc(), *NVCC_FLAGS, "-I", str(out_dir), "-shared",
           *(str(CSRC / s) for s in SOURCES), "-o", str(tmp)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    text = f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{text}")
    secs = time.perf_counter() - t0
    (out_dir / "nvcc.log").write_text(f"seconds: {secs:.3f}\n{text}")
    os.replace(tmp, lib)
    return lib


_LIBS = {}          # by library path
_BY_PROGRAM = {}    # by traced programs (skips regenerating the header)
_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float


def distinct_programs(specs):
    """The traced RHS programs of ``specs`` without repeats (two specs
    whose RHS emits the same device code share one), and each spec's
    index into them: the model of each experiment of a joint fit."""
    programs, index, model_of = [], {}, []
    for sp in specs:
        prog = trace_rhs(sp.rhs, len(sp.snames), sp.theta_size)
        text = prog.cuda_function("rhs")
        if text not in index:
            index[text] = len(programs)
            programs.append(prog)
        model_of.append(index[text])
    return programs, model_of


def load_kernels(spec, others=(), diffusion=False):
    """The loaded kernel library for ``spec``'s RHS, with the models of
    ``others`` compiled in for the joint kernel (build at first use). With
    ``diffusion`` it holds an SDE model's traced diffusion too, which only
    the particle filter reads; every other kernel integrates the drift, so
    the drift of an SDE model shares the library of the same ODE."""
    programs, _ = distinct_programs((spec, *others))
    diffusion = None if not diffusion or spec.diffusion is None else \
        trace_rhs(spec.diffusion, len(spec.snames), spec.theta_size)
    key = (tuple(programs), diffusion)
    lib = _BY_PROGRAM.get(key)
    if lib is not None:
        return lib
    path = str(build(programs[0], diffusion, tuple(programs[1:])))
    lib = _LIBS.get(path)
    if lib is None:
        lib = ctypes.CDLL(path)
        lib.odelib_survey.argtypes = [_P, _P, _P, _P, _I, _I, _P]
        lib.odelib_survey.restype = _I
        lib.odelib_mh.argtypes = [_P] * 9 + [_I, _I, _I, ctypes.c_uint,
                                             ctypes.c_float, _I, _P]
        lib.odelib_mh.restype = _I
        lib.odelib_ensemble.argtypes = [_P] * 10 + [_I] * 5 + [
            ctypes.c_uint] + [ctypes.c_float] * 4 + [_I, _P]
        lib.odelib_ensemble.restype = _I
        lib.odelib_pt.argtypes = [_P] * 10 + [_I] * 5 + [
            ctypes.c_uint, ctypes.c_float, _I, _P]
        lib.odelib_pt.restype = _I
        lib.odelib_joint.argtypes = [_P] * 3 + [_I] + [_P] * 6 + [_I] * 5 \
            + [_U, _I, _P]
        lib.odelib_joint.restype = _I
        lib.odelib_pf.argtypes = [_P] * 8 + [_I] * 4 + [_U] * 2 + [_I] * 3 \
            + [_F] * 5 + [_P]
        lib.odelib_pf.restype = _I
        lib.odelib_error_string.argtypes = [_I]
        lib.odelib_error_string.restype = ctypes.c_char_p
        _LIBS[path] = lib
    _BY_PROGRAM[key] = lib
    return lib


def check(lib, rc: int, what: str):
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.odelib_error_string(rc).decode()
        raise RuntimeError(f"CUDA {what} kernel launch failed: {msg} ({rc})")


def stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
