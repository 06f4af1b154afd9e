"""Runge-Kutta steppers in torch.

Counterpart of ``odelib_tpu/ops/runge_kutta.py`` (the Dormand-Prince 5(4)
tableau and adaptive step with dense output, the Kvaerno 3(2) and 5(4)
ESDIRK methods and the fixed-step Kvaerno3 of the fused kernels) and of
the fixed steppers ``_dopri5_fixed_step``/``_rk4_fixed_step`` of
``odelib_tpu/ops/pallas_mh.py``. The fixed steppers work on a list of
per-state tensors and
reproduce the JAX operation order exactly: ``h`` and the tableau entries
are Python floats rounded to the state's dtype where they meet a tensor,
and every weighted stage sum runs left to right from the first non-zero
term, as Python's ``sum()`` does. The CUDA kernels (``csrc/mh.cu``)
follow the same order.
"""
from __future__ import annotations

import torch

DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
# b(5th) - b(4th): error-estimate weights
DP_E = (71 / 57600, 0.0, -71 / 16695, 71 / 1920,
        -17253 / 339200, 22 / 525, -1 / 40)
# dense-output weights (Hairer DOPRI5 CONTD5)
DP_D = (-12715105075 / 11282082432, 0.0, 87487479700 / 32700410799,
        -10690763975 / 1880347072, 701980252875 / 199316789632,
        -1453857185 / 822651844, 69997945 / 29380423)

_CONSTS = {}


def const(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-dim tensor of ``like``'s dtype and device (cached).
    Tensor constants keep every operation a plain elementwise kernel:
    torch's CUDA division by a Python scalar multiplies by its
    reciprocal instead, which is not the JAX reference's arithmetic."""
    key = (float(v).hex(), like.dtype, like.device)
    c = _CONSTS.get(key)
    if c is None:
        c = _CONSTS[key] = torch.tensor(float(v), dtype=like.dtype,
                                        device=like.device)
    return c


def weighted_sum(coefs, ks):
    """``sum(a * k for a, k in zip(coefs, ks) if a != 0.0)``."""
    acc = None
    for a, k in zip(coefs, ks):
        if a != 0.0:
            term = const(a, k) * k
            acc = term if acc is None else acc + term
    return acc


def dopri5_fixed_step(f, t: float, y, h: float, ps):
    """One fixed-size Dopri5 step; ``y`` is a list of per-state tensors."""
    S = len(y)
    hc = const(h, y[0])
    ks = [f(t, y, ps)]
    for i in range(1, 6):
        yi = [y[s] + hc * weighted_sum(DP_A[i], [k[s] for k in ks])
              for s in range(S)]
        ks.append(f(t + DP_C[i] * h, yi, ps))
    return [y[s] + hc * weighted_sum(DP_A[6], [k[s] for k in ks])
            for s in range(S)]


def rk4_fixed_step(f, t: float, y, h: float, ps):
    """One classical RK4 step; ``y`` is a list of per-state tensors."""
    S = len(y)
    half, full, sixth = (const(v, y[0]) for v in (0.5 * h, h, h / 6.0))
    two = const(2.0, y[0])
    k1 = f(t, y, ps)
    k2 = f(t + 0.5 * h, [y[s] + half * k1[s] for s in range(S)], ps)
    k3 = f(t + 0.5 * h, [y[s] + half * k2[s] for s in range(S)], ps)
    k4 = f(t + h, [y[s] + full * k3[s] for s in range(S)], ps)
    return [y[s] + sixth * (k1[s] + two * k2[s] + two * k3[s] + k4[s])
            for s in range(S)]


KV3_GAMMA = 0.4358665215084590
KV3_A = (
    (),
    (KV3_GAMMA, KV3_GAMMA),
    (0.4905633884192052, 0.0735700900723358, KV3_GAMMA),
    (0.3088099699294934, 1.4905633884192052, -1.2352398798571576,
     KV3_GAMMA),
)
KV3_C = (0.0, 2 * KV3_GAMMA, 1.0, 1.0)
KV3_NEWTON = 4      # chord-Newton iterations per stage (Jacobian reused)


def kvaerno3_fixed_step(f, t, y, h, ps, jac):
    """One fixed-size Kvaerno3 step on ``y``, a list of per-state tensors:
    the twin of the kernels' ``step_kvaerno3`` (``ops/build.py``) and of
    ``odelib_tpu``'s ``kvaerno3_fixed_step``. One Jacobian per step at
    (t, y) (``jac(t, y, ps)``: the S * S entries d f_i / d y_j,
    row-major), I - h gamma J factored
    by Gaussian elimination without pivoting, ``KV3_NEWTON`` chord-Newton
    iterations per stage from the last stage slope's predictor, and the
    last stage returned (stiffly accurate). Every operation is the JAX
    source's, in its order: ``h`` and ``h gamma`` are Python floats
    rounded to the state's dtype where they meet a tensor (or tensors,
    as ``odeint_fixed`` passes them)."""
    S = len(y)
    if isinstance(h, torch.Tensor):
        hc, hg = h, h * KV3_GAMMA
    else:
        hc, hg = const(h, y[0]), const(h * KV3_GAMMA, y[0])
    k1 = f(t, y, ps)
    J = jac(t, y, ps)
    one, zero = const(1.0, y[0]), const(0.0, y[0])
    A = [[(one if i == j else zero) - hg * J[i * S + j] for j in range(S)]
         for i in range(S)]
    for k in range(S):
        inv = one / A[k][k]
        for i in range(k + 1, S):
            m = A[i][k] * inv
            A[i][k] = m
            for jj in range(k + 1, S):
                A[i][jj] = A[i][jj] - m * A[k][jj]

    def lu_solve(r):
        x = list(r)
        for i in range(S):
            for jj in range(i):
                x[i] = x[i] - A[i][jj] * x[jj]
        for i in reversed(range(S)):
            for jj in range(i + 1, S):
                x[i] = x[i] - A[i][jj] * x[jj]
            x[i] = x[i] / A[i][i]
        return x

    ks = [k1]
    z = y
    for i in range(1, len(KV3_A)):
        b = [y[s] + hc * weighted_sum(KV3_A[i][:-1], [k[s] for k in ks])
             for s in range(S)]
        ti = t + KV3_C[i] * h
        z = [b[s] + hg * ks[-1][s] for s in range(S)]
        for _ in range(KV3_NEWTON):
            fz = f(ti, z, ps)
            x = lu_solve([z[s] - hg * fz[s] - b[s] for s in range(S)])
            z = [z[s] - x[s] for s in range(S)]
        if i < len(KV3_A) - 1:
            ks.append([(z[s] - b[s]) / hg for s in range(S)])
    return z


FIXED_STEPPERS = {"dopri5": dopri5_fixed_step, "rk4": rk4_fixed_step}


class Dopri5:
    """Adaptive RK 5(4) with FSAL and 4th-order dense output, on (S, N)
    states with a per-lane step size ``h`` of shape (N,)."""

    ERROR_ORDER = 5.0

    @staticmethod
    def first_stage(func, t, y, args):
        return func(t, y, args)

    @staticmethod
    def step(func, t, y, f0, h, args):
        ks = [f0]
        for i in range(1, 7):
            yi = y + h * sum(a * k for a, k in zip(DP_A[i], ks) if a != 0.0)
            ks.append(func(t + DP_C[i] * h, yi, args))
        y_new = y + h * sum(a * k for a, k in zip(DP_A[6], ks) if a != 0.0)
        f_new = ks[6]       # FSAL: row A[6] == b
        err = h * sum(e * k for e, k in zip(DP_E, ks) if e != 0.0)
        delta = y_new - y
        r3 = h * ks[0] - delta
        r4 = delta - h * f_new - r3
        r5 = h * sum(d * k for d, k in zip(DP_D, ks) if d != 0.0)
        dense = torch.stack([y, delta, r3, r4, r5])
        return y_new, f_new, err, dense

    @staticmethod
    def interp(dense, theta):
        r1, r2, r3, r4, r5 = dense
        th1 = 1.0 - theta
        return r1 + theta * (r2 + th1 * (r3 + theta * (r4 + th1 * r5)))

    @staticmethod
    def dense_zero(y):
        z = torch.zeros_like(y)
        return torch.stack([y, z, z, z, z])


# --------------------------------------------------------------------------
# stiffly accurate, L-stable ESDIRK methods (Kvaerno 2004)
# --------------------------------------------------------------------------

_NEWTON_ITERS = 6


class _ESDIRK:
    """Implicit adaptive ESDIRK with modified-Newton stage solves on (S, N)
    states with a per-lane step ``h`` (N,). The tableau rows carry the
    diagonal gamma last; the solution is the last stage (stiffly
    accurate) and the embedded method the second-to-last row. One
    Jacobian per step at (t, y) (``jac(t, y, args)`` -> (S, S, N)),
    I - h gamma J factored with partial pivoting
    (``torch.linalg.lu_factor_ex``, as ``jax.scipy.linalg.lu_factor``)
    and reused by ``_NEWTON_ITERS`` iterations of every stage; cubic
    Hermite dense output on (y, f0) -> (y_new, f_new)."""

    IMPLICIT = True
    A: tuple
    C: tuple
    GAMMA: float
    ERROR_ORDER: float

    @staticmethod
    def first_stage(func, t, y, args):
        return func(t, y, args)

    @classmethod
    def step(cls, func, t, y, f0, h, args, jac):
        S = y.shape[0]
        eye = torch.eye(S, dtype=y.dtype, device=y.device)[..., None]
        m = eye - (h * cls.GAMMA) * jac(t, y, args)
        lu, piv, _ = torch.linalg.lu_factor_ex(m.permute(2, 0, 1))

        def lu_solve(r):
            return torch.linalg.lu_solve(lu, piv, r.t()[..., None])[..., 0].t()

        ks = [f0]
        z = y
        for i in range(1, len(cls.A)):
            ti = t + cls.C[i] * h
            base = y + h * sum(a * k for a, k in zip(cls.A[i][:-1], ks)
                               if a != 0.0)
            for _ in range(_NEWTON_ITERS):
                res = z - base - h * cls.GAMMA * func(ti, z, args)
                z = z - lu_solve(res)
            ks.append(func(ti, z, args))
        f_new = ks[-1]
        b, bhat = cls.A[-1], cls.A[-2] + (0.0,)
        err = h * sum((bi - bh) * k for bi, bh, k in zip(b, bhat, ks))
        dense = torch.stack([y, z, h * f0, h * f_new])
        return z, f_new, err, dense

    @staticmethod
    def interp(dense, theta):
        """Cubic Hermite interpolation."""
        y0, y1, hf0, hf1 = dense
        t2 = theta * theta
        t3 = t2 * theta
        h00 = 2 * t3 - 3 * t2 + 1
        h10 = t3 - 2 * t2 + theta
        h01 = -2 * t3 + 3 * t2
        h11 = t3 - t2
        return h00 * y0 + h10 * hf0 + h01 * y1 + h11 * hf1

    @staticmethod
    def dense_zero(y):
        z = torch.zeros_like(y)
        return torch.stack([y, y, z, z])


class Kvaerno3(_ESDIRK):
    """Kvaerno 3(2): 4-stage ESDIRK, gamma = 0.4358665215."""

    ERROR_ORDER = 3.0
    GAMMA = KV3_GAMMA
    A = KV3_A
    C = KV3_C


class Kvaerno5(_ESDIRK):
    """Kvaerno 5(4): 7-stage ESDIRK, gamma = 0.26 (Kvaerno 2004,
    Table 5.1)."""

    ERROR_ORDER = 5.0
    GAMMA = 0.26
    A = (
        (),
        (0.26, 0.26),
        (0.13, 0.84033320996790809, 0.26),
        (0.22371961478320505, 0.47675532319799699, -0.06470895363112615,
         0.26),
        (0.16648564323248321, 0.10450018841591720, 0.03631482272098715,
         -0.13090704451073998, 0.26),
        (0.13855640231268224, 0.0, -0.04245337201752043, 0.02446657898003141,
         0.61943039072480676, 0.26),
        (0.13659751177640291, 0.0, -0.05496908796538376,
         -0.04118626728321046, 0.62993304899016403, 0.06962479448202728,
         0.26),
    )
    C = (0.0, 0.52, 1.230333209967908, 0.8957659843500759,
         0.43639360985864756, 1.0, 1.0)


STEPPERS = {"dopri5": Dopri5, "kvaerno3": Kvaerno3, "kvaerno5": Kvaerno5}
