"""Pandas data ingestion -> host observation arrays.

Counterpart of ``odelib_tpu/data.py``: both input schemas of the reference
``_formatdf`` (replicates aggregated in log space, or direct
abundance/log_sigma rows), nearest-grid-point indexing, the flat
:class:`~odelib_tpu_torch.model.ObsData` and the compact observation grid
the MCMC hot loop integrates on.
"""
from __future__ import annotations

import os
import warnings
from typing import Dict, Tuple

import numpy as np
import pandas as pd

from .model import ObsData


def format_dataframe(df: pd.DataFrame, snames) -> pd.DataFrame:
    """Normalize a user dataframe to organism-indexed log-space columns."""
    df = df.sort_values(by=["organism", "time"])
    if "replicate" in df and "censored" in df:
        raise ValueError(
            "censored observations cannot be aggregated over replicates "
            "(a mean of detection limits is not a limit); provide the "
            "direct schema (organism, time, abundance[, log_sigma]) with "
            "one row per point instead")
    if "replicate" in df:
        _df = df[["organism", "time", "abundance"]].copy()
        _df["log_abundance"] = np.log(_df["abundance"])
        dfagg = _df.groupby(by=["time", "organism"]).mean()
        dfagg["log_sigma"] = _df.groupby(
            by=["time", "organism"]).std()["log_abundance"]
        df = dfagg.reset_index(level="time")
    else:
        df = df.set_index("organism")
        if "abundance" in df and "log_abundance" not in df:
            df["log_abundance"] = np.log(df["abundance"].to_numpy())
        if "log_sigma" not in df:
            df["log_sigma"] = 1
            warnings.warn("log_sigma not found, setting log variance to 1")
    return df


def nearest_grid_indices(obs_times: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """First index of the closest grid point for each observation time."""
    d = np.abs(obs_times[:, None] - grid[None, :])
    return d.argmin(axis=1).astype(np.int32)


def fit_setup(df: pd.DataFrame, times: np.ndarray):
    """Per-state observation dictionaries, in first-appearance order:
    (pred_tindex, obs_logabundance, obs_logsigma)."""
    pred_tindex, obs_logabundance, obs_logsigma = {}, {}, {}
    for sname in dict.fromkeys(df.index):
        sub = df.loc[[sname]]
        pred_tindex[sname] = nearest_grid_indices(
            np.atleast_1d(sub["time"].to_numpy(dtype=float)), times)
        obs_logabundance[sname] = np.atleast_1d(
            sub["log_abundance"].to_numpy(dtype=float))
        obs_logsigma[sname] = np.atleast_1d(
            sub["log_sigma"].to_numpy(dtype=float))
    return pred_tindex, obs_logabundance, obs_logsigma


def build_obsdata_host(df: pd.DataFrame, times: np.ndarray,
                       post_snames) -> Tuple[ObsData, Tuple[str, ...]]:
    """Flatten per-state observations (``post_snames`` order) into one
    host :class:`ObsData`. Returns (obsdata, observed_state_names)."""
    if "censored" in df.columns:
        raise NotImplementedError(
            "censored observations are not ported yet (ROADMAP queue 1, "
            "item 13)")
    pred_tindex, logab, logsig = fit_setup(df, np.asarray(times))
    observed = tuple(s for s in post_snames if s in pred_tindex)
    if not observed:
        raise ValueError(
            f"No dataframe organisms match model states {post_snames}; "
            f"found organisms {sorted(pred_tindex)}")
    la, ls, ti, si = [], [], [], []
    sstot = 0.0
    for s in observed:
        la.append(logab[s])
        ls.append(logsig[s])
        ti.append(pred_tindex[s])
        si.append(np.full(len(logab[s]), post_snames.index(s), np.int32))
        ab = np.exp(logab[s])
        if ab.size:
            sstot += ab.shape[0] * np.var(ab)
    la = np.concatenate(la)
    return ObsData(log_abundance=la, log_sigma=np.concatenate(ls),
                   abundance=np.exp(la), t_index=np.concatenate(ti),
                   state_index=np.concatenate(si),
                   sstot=np.asarray(sstot)), observed


def compact_observation_grid(obs: ObsData, times,
                             extra_times=None) -> Tuple[np.ndarray, ObsData]:
    """Shrink the integration grid to the observed times (plus the origin
    and any ``extra_times``, snapped to the full grid first). Returns
    (compact_times, obs with remapped t_index)."""
    times = np.asarray(times)
    obs_times = times[np.asarray(obs.t_index)]
    keep = obs_times
    if extra_times is not None and len(np.atleast_1d(extra_times)):
        snapped = times[nearest_grid_indices(
            np.atleast_1d(np.asarray(extra_times, float)), times)]
        keep = np.concatenate([keep, snapped])
    uniq = np.unique(keep)
    if uniq[0] != times[0]:
        uniq = np.concatenate([[times[0]], uniq])
    new_tidx = np.searchsorted(uniq, obs_times).astype(np.int32)
    return uniq, obs._replace(t_index=new_tidx)


def demo_data_path() -> str:
    """Path to the demo host/virus dataset: ``ODELIB_DEMODATA`` if set,
    else the file committed with the JAX package (read as a plain file;
    nothing of that package is imported)."""
    override = os.environ.get("ODELIB_DEMODATA", "")
    if override:
        return override
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, "odelib_tpu", "demodata.csv")


def load_demo_dataframe(host: str = "host",
                        virus: str = "virus") -> pd.DataFrame:
    """Load the demo dataset, renaming organisms to model state names."""
    df = pd.read_csv(demo_data_path())
    return df.replace({"host": host, "virus": virus})


def initial_states_from_df(df: pd.DataFrame) -> Dict[str, float]:
    """Initial states from the t==0 rows (first occurrence wins)."""
    out = {}
    at0 = df[df["time"] == 0]
    for org, abundance in at0["abundance"].items():
        if org not in out:
            out[org] = abundance
    return out
