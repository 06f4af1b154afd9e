"""Integrators, fixed-step steppers and the fused CUDA kernels."""
from .integrate import ODESolution, odeint_grid
from .runge_kutta import FIXED_STEPPERS, Dopri5

__all__ = ["ODESolution", "odeint_grid", "FIXED_STEPPERS", "Dopri5"]
