"""Integrators, fixed-step steppers and the fused CUDA kernels."""
import contextlib

from .integrate import ODESolution, odeint_grid
from .runge_kutta import FIXED_STEPPERS, Dopri5

__all__ = ["ODESolution", "odeint_grid", "FIXED_STEPPERS", "Dopri5",
           "plain_launchers"]


@contextlib.contextmanager
def plain_launchers():
    """While the block runs, the MH, ensemble, PT and joint wrappers run
    their kernels' plain twins where they would launch the kernel, on the
    same tensors, the card's too: each launcher is swapped for one that
    calls the twin, and nothing is launched or counted. A wrapper call
    made inside and outside the block holds a kernel against its twin on
    one set of arguments."""
    from . import cuda_joint, cuda_mh, cuda_pt
    swaps = ((cuda_mh, "mh_launcher", cuda_mh.mh_plain),
             (cuda_mh, "ensemble_launcher", cuda_mh.ensemble_plain),
             (cuda_pt, "pt_launcher", cuda_pt.pt_plain),
             (cuda_joint, "joint_launcher", cuda_joint.joint_plain))
    real = [getattr(m, n) for m, n, _ in swaps]
    for m, n, plain in swaps:
        setattr(m, n, cuda_mh.twin_launcher(plain))
    try:
        yield
    finally:
        for (m, n, _), fn in zip(swaps, real):
            setattr(m, n, fn)
