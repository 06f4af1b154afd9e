"""Runge-Kutta steppers in torch.

Counterpart of ``odelib_tpu/ops/runge_kutta.py`` (the Dormand-Prince 5(4)
tableau and adaptive step with dense output) and of the fixed steppers
``_dopri5_fixed_step``/``_rk4_fixed_step`` of ``odelib_tpu/ops/
pallas_mh.py``. The fixed steppers work on a list of per-state tensors and
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
