"""Parallel-tempering bookkeeping on the host.

Counterpart of ``swap_attempts`` in ``odelib_tpu/samplers/pt.py``. The XLA
ladder sampler and ``tune_ladder`` are not ported yet (ROADMAP queue 1,
item 15); the port's tempering runs the fused kernel
(:mod:`odelib_tpu_torch.ops.cuda_pt`).
"""
from __future__ import annotations

import numpy as np


def swap_attempts(nits: int, swap_every: int, n_pairs: int) -> np.ndarray:
    """Per-pair PROPOSAL counts over iterations 1..nits-1: pair k is
    proposed on swap rounds whose parity matches k % 2."""
    its = np.arange(1, int(nits))
    rounds = its[its % int(swap_every) == 0]
    parity = (rounds // int(swap_every)) % 2
    return np.array([(parity == (k % 2)).sum() for k in range(n_pairs)],
                    dtype=float)
