"""odelib_tpu_torch — Bayesian ODE fitting on PyTorch and CUDA.

The PyTorch/H100 port of ``odelib_tpu``: the same user API
(``ModelFramework``, ``parameter``) and the same posterior DataFrames, with
the JAX package's Pallas kernels rewritten as hand-written CUDA kernels for
Hopper (``ops/csrc``) beside plain torch twins that run on the CPU. The
package imports torch, numpy, pandas and scipy; it never imports jax.
"""
from . import distributions, stats
from .api import ModelFramework, parameter

__version__ = "0.1.0"

__all__ = ["ModelFramework", "parameter", "distributions", "stats",
           "__version__"]
