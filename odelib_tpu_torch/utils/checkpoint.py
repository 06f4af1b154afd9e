"""Posterior files: save and load a posterior DataFrame, and the chains'
last states as restart points.

A copy of ``odelib_tpu/utils/checkpoint.py`` in plain numpy/pandas. The
file is numpy's npz format holding one array per column and the column
order; ``MCMC(checkpoint_path=...)`` writes the posterior with it. The
chunked runs' progress files are :mod:`odelib_tpu_torch.ops.chunked`'s.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pandas as pd


def save_posterior(path: str, posterior: pd.DataFrame) -> None:
    """Save a posterior DataFrame to exactly ``path`` (npz). Written
    through a file handle: ``np.savez_compressed(path)`` would append
    ``.npz`` to another extension."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    arrays = {}
    meta = {"columns": list(posterior.columns)}
    for c in posterior.columns:
        v = posterior[c].to_numpy()
        if v.dtype == object:  # array-valued parameter columns
            v = np.stack([np.asarray(x, float) for x in v])
        arrays[f"col_{c}"] = v
    with open(path, "wb") as f:
        np.savez_compressed(f, __meta__=np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8), **arrays)


def load_posterior(path: str) -> pd.DataFrame:
    """The DataFrame :func:`save_posterior` wrote."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        cols = {}
        for c in meta["columns"]:
            v = z[f"col_{c}"]
            cols[c] = list(v) if v.ndim > 1 else v
    return pd.DataFrame(cols)


def resume_theta(posterior: pd.DataFrame, pnames,
                 n_chains: int) -> pd.DataFrame:
    """Each chain's last recorded parameters: restart points for a
    continued run (``MCMC(chain_inits=<this DataFrame>)``)."""
    rows = []
    for c in range(n_chains):
        sub = posterior[posterior["chain#"] == c]
        if len(sub):
            rows.append(sub.iloc[-1][list(pnames)].to_dict())
    return pd.DataFrame(rows)
