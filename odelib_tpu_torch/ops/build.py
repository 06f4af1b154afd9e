"""Build and load the CUDA kernels (``csrc/*.cu``) for one model.

The kernels are compiled with ``nvcc`` into one shared library with a
plain C interface and loaded with ``ctypes``; no PyTorch headers are
involved, so a build takes seconds. The build input is the sources in
``csrc/`` (``mh.cu``, ``ensemble.cu``, ``pt.cu``, ``joint.cu``, ``pf.cu``
and their shared ``common.cuh``) plus ``odelib_gen.cuh``, generated here
from the traced RHS (:meth:`odelib_tpu_torch.rhs.RhsProgram.cuda_source`),
the fixed-step Dopri5/RK4 steppers and the model's scoring constants (its
observation model with ``nu`` or ``r``, whether any observation is
censored, whether it is dosed: each kernel compiles that one branch of
the scorer), all in one nvcc call. The
particle filter's library of an SDE model adds its traced diffusion to
the header (and, for the Milstein step, the diffusion's diagonal
derivative ``diffusion_diag()``, in a library of its own); a joint fit of
different models adds each further model as a ``ModelN`` type for the
joint kernel. The
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

from ..rhs import _f32_literal, forcing_columns
from .runge_kutta import DP_A, KV3_A, KV3_NEWTON

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("mh.cu", "ensemble.cu", "pt.cu", "joint.cu", "pf.cu")
HEADERS = ("common.cuh",)
PT_KMAX = 32        # rungs of a chain on one warp (csrc/pt.cu); longer
#                     ladders span warps in a library built with ODE_WIDE
JOINT_KMAX = 8      # warps of a joint block, an experiment each
#                     (csrc/joint.cu); with ODE_WIDE they loop over more
JOINT_DMAX = 64     # joint theta slots of the one-experiment-a-warp
#                     instantiations; more run in ODE_WIDE's
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


def _row(r: int, n_forc: int) -> str:
    """The forcing row of distinct stage time ``r`` in a step's rows
    ``uf`` (``cuda_mh.STAGE_C``)."""
    return f"uf + {r * n_forc}" if r and n_forc else "uf"


def stepper_source(n_states: int, size: str = "ODE_S",
                   n_forc: int = 0) -> str:
    """Fixed-step Dopri5 and RK4 over ``y[size]`` with the step's
    constants ``sf`` (see ``plan_tables``) and its forcing rows ``uf``
    (``n_forc`` columns per distinct stage time, ``cuda_mh.
    forcing_table``), unrolled with literal float32 tableau entries in the
    JAX kernel's summation order."""
    S, F = n_states, n_forc
    ks = [f"k{i}" for i in range(6)]
    lines = ["__device__ __forceinline__ void step_dopri5(float* y, "
             "const float* sf, const float* p, const float* uf) {",
             "  const float h = sf[0];",
             f"  float {', '.join(f'{k}[{size}]' for k in ks)}, yi[{size}];",
             "  (void)uf;",
             "  rhs(sf[1], y, p, uf, k0);"]
    for i in range(1, 6):
        for s in range(S):
            lines.append(f"  yi[{s}] = y[{s}] + h * "
                         f"({_stage_sum(DP_A[i], ks, s)});")
        lines.append(f"  rhs(sf[{i + 1}], yi, p, {_row(i, F)}, k{i});")
    for s in range(S):
        lines.append(f"  y[{s}] = y[{s}] + h * ({_stage_sum(DP_A[6], ks, s)});")
    lines += ["}", "",
              "__device__ __forceinline__ void step_rk4(float* y, "
              "const float* sf, const float* p, const float* uf) {",
              f"  float k0[{size}], k1[{size}], k2[{size}], k3[{size}], "
              f"yi[{size}];",
              "  (void)uf;",
              "  rhs(sf[3], y, p, uf, k0);"]
    for src, coef, t_idx, dst, r in (("k0", 1, 4, "k1", 1),
                                     ("k1", 1, 4, "k2", 1),
                                     ("k2", 0, 5, "k3", 2)):
        for s in range(S):
            lines.append(f"  yi[{s}] = y[{s}] + sf[{coef}] * {src}[{s}];")
        lines.append(f"  rhs(sf[{t_idx}], yi, p, {_row(r, F)}, {dst});")
    for s in range(S):
        lines.append(f"  y[{s}] = y[{s}] + sf[2] * (k0[{s}] + 2.0f * k1[{s}]"
                     f" + 2.0f * k2[{s}] + k3[{s}]);")
    lines += ["}", ""]
    return "\n".join(lines)


def kvaerno3_source(program, columns=None) -> str:
    """The RHS's Jacobian ``jac()`` (:meth:`~odelib_tpu_torch.rhs.
    RhsProgram.jacobian`, reading the forcing ``columns``) and the
    fixed-step Kvaerno3 ``step_kvaerno3`` over ``y[ODE_S]`` with the step's
    constants ``sf`` (h, f32(h gamma), then the times of stages 1-4;
    ``plan_tables``) and forcing rows ``uf`` (t, t + 2 gamma h, t + h):
    I - h gamma J in
    registers, its elimination without pivoting and the triangular solves
    unrolled in the order of ``odelib_tpu/ops/runge_kutta.py``
    ``kvaerno3_fixed_step``, ``KV3_NEWTON`` chord-Newton iterations a
    stage, the last stage returned. The twin is
    :func:`~.runge_kutta.kvaerno3_fixed_step`."""
    S = program.n_states
    columns = forcing_columns(program) if columns is None else columns
    F = len(columns)
    a = [[f"a{i}_{j}" for j in range(S)] for i in range(S)]
    lines = [program.jacobian().cuda_function("jac", columns),
             "__device__ __forceinline__ void step_kvaerno3(float* y, "
             "const float* sf, const float* p, const float* uf) {",
             "  const float h = sf[0], hg = sf[1];",
             "  float k0[ODE_S], k1[ODE_S], k2[ODE_S], b[ODE_S], z[ODE_S], "
             f"fz[ODE_S], J[{S * S}];",
             "  (void)uf;",
             "  rhs(sf[2], y, p, uf, k0);",
             "  jac(sf[2], y, p, uf, J);"]
    for i in range(S):
        for j in range(S):
            lines.append(f"  float {a[i][j]} = {'1.0f' if i == j else '0.0f'}"
                         f" - hg * J[{i * S + j}];")
    for k in range(S - 1):  # in-place LU, no pivoting
        lines.append(f"  const float inv{k} = 1.0f / {a[k][k]};")
        for i in range(k + 1, S):
            lines.append(f"  {a[i][k]} = {a[i][k]} * inv{k};")
            for j in range(k + 1, S):
                lines.append(f"  {a[i][j]} = {a[i][j]} - {a[i][k]} * "
                             f"{a[k][j]};")
    ks = ["k0", "k1", "k2"]
    for st in range(1, len(KV3_A)):
        for s in range(S):
            lines.append(f"  b[{s}] = y[{s}] + h * "
                         f"({_stage_sum(KV3_A[st][:-1], ks, s)});")
        for s in range(S):
            lines.append(f"  z[{s}] = b[{s}] + hg * {ks[st - 1]}[{s}];")
        lines += [f"  for (int it = 0; it < {KV3_NEWTON}; ++it) {{",
                  f"    rhs(sf[{st + 2}], z, p, {_row(min(st, 2), F)}, fz);"]
        for s in range(S):
            lines.append(f"    float x{s} = z[{s}] - hg * fz[{s}] - b[{s}];")
        for i in range(S):          # forward substitution (unit lower)
            for j in range(i):
                lines.append(f"    x{i} = x{i} - {a[i][j]} * x{j};")
        for i in reversed(range(S)):
            for j in range(i + 1, S):
                lines.append(f"    x{i} = x{i} - {a[i][j]} * x{j};")
            lines.append(f"    x{i} = x{i} / {a[i][i]};")
        for s in range(S):
            lines.append(f"    z[{s}] = z[{s}] - x{s};")
        lines.append("  }")
        if st < len(KV3_A) - 1:
            for s in range(S):
                lines.append(f"  {ks[st]}[{s}] = (z[{s}] - b[{s}]) / hg;")
    for s in range(S):
        lines.append(f"  y[{s}] = z[{s}];")
    lines += ["}", ""]
    return "\n".join(lines)


# the observation models as the scorer numbers them (csrc/common.cuh)
OBS_FAMILY = {"lognormal": 0, "student_t": 1, "poisson": 2, "negbinom": 3}


def obs_source(i: int, scoring) -> str:
    """``ObsModel<i>``: the scoring constants of model ``i`` as
    ``static constexpr`` members, float32 where the JAX kernel's Python
    doubles meet float32 (``C1 = 0.5 (nu + 1)``, ``NU``, ``R``) and
    double for the Student-t log CDF of censored points (``T_*``, from
    ``cuda_mh.t_constants``)."""
    from .cuda_mh import t_constants
    family, param, censored, dosed = scoring
    nu = param if family == "student_t" else 1.0
    tc = t_constants(nu)
    f32 = [("NU", nu if family == "student_t" else 0.0),
           ("C1", 0.5 * (nu + 1.0) if family == "student_t" else 0.0),
           ("R", param if family == "negbinom" else 0.0)]
    f64 = [("T_NU", tc["nu"]), ("T_A", tc["a"]), ("T_THRESH", tc["thresh"]),
           ("T_KA", tc["ka"]), ("T_KB", tc["kb"])]
    return "\n".join(
        [f"struct ObsModel{i} {{",
         f"  static constexpr int FAMILY = {OBS_FAMILY[family]};  "
         f"// {family}",
         f"  static constexpr bool CENSORED = {str(bool(censored)).lower()};",
         f"  static constexpr bool DOSED = {str(bool(dosed)).lower()};"]
        + [f"  static constexpr float {k} = {_f32_literal(v)};"
           for k, v in f32]
        + [f"  static constexpr double {k} = {float(v)!r};"
           for k, v in f64] + ["};", ""])


def _columns_comment(columns) -> str:
    """The forcing columns as a comment (so the forcing names, never
    their values, are part of the library's hash)."""
    from ..rhs import column_text
    return "\n".join(f"// u[{k}] = {column_text(c)}"
                     for k, c in enumerate(columns))


def _model_source(i: int, program, scoring, columns=None) -> str:
    """A further model of a joint fit: its RHS and steppers in namespace
    ``odelib_m<i>``, its scoring constants and the ``Model<i>`` type the
    joint kernel scores (``F`` forcing columns a stage row)."""
    ns, S, P = f"odelib_m{i}", program.n_states, program.n_params
    columns = forcing_columns(program) if columns is None else columns
    fwd = [("rhs(float t, const float* y, const float* p, const float* u, "
            "float* dy)", "rhs(t, y, p, u, dy)"),
           ("step_dopri5(float* y, const float* sf, const float* p, "
            "const float* uf)", "step_dopri5(y, sf, p, uf)"),
           ("step_rk4(float* y, const float* sf, const float* p, "
            "const float* uf)", "step_rk4(y, sf, p, uf)")]
    return "\n".join(
        [f"// model {i}: traced from {program.name}",
         _columns_comment(columns), f"namespace {ns} {{",
         program.cuda_function("rhs", columns),
         stepper_source(S, str(S), len(columns)), "}",
         obs_source(i, scoring),
         f"struct Model{i} : ObsModel{i} {{",
         f"  static constexpr int S = {S};",
         f"  static constexpr int P = {P};",
         f"  static constexpr int F = {len(columns)};"]
        + [f"  static __device__ __forceinline__ void {sig} {{ "
           f"{ns}::{call}; }}" for sig, call in fwd] + ["};", ""])


def generated_header(program, diffusion, extra, scoring,
                     stiff: bool = False, milstein: bool = False,
                     columns=None, wide: bool = False) -> str:
    """``odelib_gen.cuh`` for a traced RHS program; with the traced
    ``diffusion`` of an SDE model (or None), with the ``extra`` programs
    of a joint fit's other models, with each model's ``scoring`` (one
    ``cuda_mh.scoring`` tuple per model), with ``stiff`` the RHS's
    Jacobian and the Kvaerno3 stepper (``ODE_KVAERNO3``: the survey, MH,
    ensemble and PT kernels then hold kvaerno3 instantiations), and with
    ``milstein`` the diffusion's diagonal derivative ``diffusion_diag()``
    (:meth:`~odelib_tpu_torch.rhs.RhsProgram.diagonal`; ``ODE_MILSTEIN``:
    the particle filter's instantiations then take the Milstein step),
    and with ``wide`` (``ODE_WIDE``) the PT kernel's instantiations for
    ladders of more than ``PT_KMAX`` rungs and the joint kernel's for
    more than ``JOINT_KMAX`` experiments or ``JOINT_DMAX`` slots.
    ``columns`` gives each model's forcing columns (the plan's forcing
    table, ``model.spec_columns``; model 0's cover its diffusion); by
    default each program's own (:func:`~odelib_tpu_torch.rhs.
    forcing_columns`)."""
    import math
    if len(scoring) != 1 + len(extra):
        raise ValueError(f"{len(scoring)} scorings for {1 + len(extra)} "
                         "models")
    if columns is None:
        columns = (forcing_columns(program, diffusion),) + tuple(
            forcing_columns(p) for p in extra)
    c0 = columns[0]
    parts = ["// generated by odelib_tpu_torch/ops/build.py; do not edit",
             "#pragma once",
             f"#define ODELIB_TWO_PI {_f32_literal(2.0 * math.pi)}"]
    if c0:
        parts.append(_columns_comment(c0))
    parts += [program.cuda_source(c0),
              stepper_source(program.n_states, n_forc=len(c0)),
              obs_source(0, scoring[0])]
    if stiff:
        parts += ["#define ODE_KVAERNO3 1", kvaerno3_source(program, c0)]
    if wide:
        parts.append("#define ODE_WIDE 1")
    if diffusion is not None:
        parts += ["#define ODE_HAS_DIFFUSION 1",
                  f"// diffusion traced from {diffusion.name}",
                  diffusion.cuda_function("diffusion", c0)]
        if milstein:
            parts += ["#define ODE_MILSTEIN 1",
                      diffusion.diagonal().cuda_function("diffusion_diag",
                                                         c0)]
    if extra:
        parts += [_model_source(i + 1, p, scoring[i + 1], columns[i + 1])
                  for i, p in enumerate(extra)]
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


def build(program, diffusion, extra, scoring, stiff: bool = False,
          milstein: bool = False, columns=None, wide: bool = False) -> Path:
    """Compile the kernels for ``program`` (with an SDE's ``diffusion``, a
    joint fit's ``extra`` programs, each model's ``scoring``, with
    ``stiff`` the Kvaerno3 instantiations, with ``milstein`` the particle
    filter's Milstein step and with ``wide`` the long-ladder and
    many-experiment instantiations; cached by content hash); returns the
    shared library's path. The compiler's output and the build's seconds
    are kept beside it in ``nvcc.log``."""
    header = generated_header(program, diffusion, extra, scoring, stiff,
                              milstein, columns, wide)
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


def distinct_programs(specs, scoring, with_columns=False):
    """The traced RHS programs of ``specs`` without repeats (two specs
    whose RHS emits the same device code, reading the same forcing
    columns, and have the same ``scoring``, one per spec, share one), and
    each spec's index into them: the model of each experiment of a joint
    fit. With ``with_columns`` also each program's forcing columns
    (``model.spec_columns`` of its first spec)."""
    from ..model import rhs_program, spec_columns
    programs, index, model_of, columns = [], {}, [], []
    for k, sp in enumerate(specs):
        prog = rhs_program(sp)
        cols = spec_columns(sp)
        text = (prog.cuda_function("rhs", cols), cols, tuple(scoring[k]))
        if text not in index:
            index[text] = len(programs)
            programs.append(prog)
            columns.append(cols)
        model_of.append(index[text])
    if with_columns:
        return programs, model_of, tuple(columns)
    return programs, model_of


def load_kernels(spec, others=(), diffusion=False, *, scoring,
                 stiff: bool = False, milstein: bool = False,
                 wide: bool = False):
    """The loaded kernel library for ``spec``'s RHS, with the models of
    ``others`` compiled in for the joint kernel (build at first use), each
    model scored as its entry of ``scoring`` says (one ``cuda_mh.scoring``
    of its plan per model). With ``diffusion`` it holds an SDE model's
    traced diffusion too, which only the particle filter reads; every
    other kernel integrates the drift, so the drift of an SDE model shares
    the library of the same ODE. With ``stiff`` the survey, MH, ensemble
    and PT kernels also hold their kvaerno3 instantiations (a library of
    its own: the explicit steppers' libraries stay as they were). With
    ``diffusion`` and ``milstein`` the particle filter takes the Milstein
    step (a library of its own too, whose ``odelib_pf`` refuses an Euler
    launch, as the Euler library's refuses a Milstein one). With ``wide``
    the PT kernel also holds ladders of more than ``PT_KMAX`` rungs and
    the joint kernel fits of more than ``JOINT_KMAX`` experiments or
    ``JOINT_DMAX`` slots (a library of its own: the others keep their code
    and build time, and refuse such a launch)."""
    from ..model import diffusion_program
    specs = (spec, *others)
    scoring = tuple(tuple(k) for k in scoring)
    programs, model_of, columns = distinct_programs(specs, scoring, True)
    keys = tuple(scoring[model_of.index(i)] for i in range(len(programs)))
    diffusion = None if not diffusion or spec.diffusion is None else \
        diffusion_program(spec)
    milstein = bool(milstein) and diffusion is not None
    key = (tuple(programs), keys, diffusion, bool(stiff), milstein, columns,
           bool(wide))
    lib = _BY_PROGRAM.get(key)
    if lib is not None:
        return lib
    path = str(build(programs[0], diffusion, tuple(programs[1:]), keys,
                     bool(stiff), milstein, columns, bool(wide)))
    lib = _LIBS.get(path)
    if lib is None:
        lib = ctypes.CDLL(path)
        lib.odelib_survey.argtypes = [_P, _I, _P, _I, _P, _P, _I, _I, _P]
        lib.odelib_survey.restype = _I
        lib.odelib_mh.argtypes = [_P, _I, _P, _I] + [_P] * 10 + [
            _I] * 4 + [_U, _F, _I, _P]
        lib.odelib_mh.restype = _I
        lib.odelib_ensemble_blocks.argtypes = [_I, _I, _I, _I,
                                               ctypes.POINTER(_I)]
        lib.odelib_ensemble_blocks.restype = _I
        lib.odelib_ensemble.argtypes = [_P, _I, _P, _I] + [_P] * 11 + [
            _I] * 6 + [_U] + [_F] * 4 + [_I, _I, _P]
        lib.odelib_ensemble.restype = _I
        lib.odelib_pt.argtypes = [_P] * 13 + [_I] * 6 + [
            ctypes.c_uint, ctypes.c_float, _I, _P]
        lib.odelib_pt.restype = _I
        lib.odelib_joint.argtypes = [_P, _I, _P, _I, _P, _I] + [_P] * 9 \
            + [_I] * 6 + [_U, _I, _I, _P]
        lib.odelib_joint.restype = _I
        lib.odelib_pf.argtypes = [_P] * 10 + [_I] * 6 + [_U] * 2 + [_I] * 4 \
            + [_F] * 5 + [_P]
        lib.odelib_pf.restype = _I
        lib.odelib_tobit.argtypes = [_P, _I, _I] + [ctypes.c_double] * 5 \
            + [_P, _P]
        lib.odelib_tobit.restype = _I
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
