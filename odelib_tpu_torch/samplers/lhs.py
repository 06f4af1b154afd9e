"""Latin hypercube sampling with an explicit ``torch.Generator``.

Counterpart of ``odelib_tpu/samplers/lhs.py``: one point drawn uniformly
inside each of ``samples`` equal-probability strata per dimension, strata
shuffled independently per dimension, then pushed through each prior's
``ppf``. The generator, not global RNG state, makes the draw reproducible.
"""
from __future__ import annotations

from typing import Sequence

import torch


def lhs_unit(generator: torch.Generator, n_dims: int, samples: int,
             dtype=torch.float64):
    """(samples, n_dims) Latin-hypercube draw on the unit cube."""
    u = torch.rand((samples, n_dims), generator=generator, dtype=dtype)
    strata = torch.stack([torch.randperm(samples, generator=generator)
                          for _ in range(n_dims)], dim=1)
    return (strata.to(dtype) + u) / samples


def sample_lhs(generator: torch.Generator, dists: Sequence, samples: int):
    """(samples, len(dists)) LHS parameter draws, one distribution per
    dimension."""
    cube = lhs_unit(generator, len(dists), samples)
    return torch.stack([d.ppf(cube[:, i]) for i, d in enumerate(dists)],
                       dim=1)
