"""Pandas data ingestion -> host observation arrays.

Counterpart of ``odelib_tpu/data.py``: both input schemas of the reference
``_formatdf`` (replicates aggregated in log space, or direct
abundance/log_sigma rows), the ``censored`` column, nearest-grid-point
indexing, the flat
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


_CENSOR_NAMES = {"": 0, "none": 0, "exact": 0, "no": 0,
                 "left": 1, "lod": 1, "below": 1,
                 "right": 2, "upper": 2, "above": 2}


def parse_censor_column(col) -> np.ndarray:
    """A user 'censored' column as int32 flags (0 exact, 1 left, 2 right):
    booleans (True = left-censored, the detection-limit case), integers
    {0, 1, 2}, or labels ('left'/'lod'/'below', 'right'/'upper'/'above',
    ''/'none'/'exact'/'no'); None and NaN are exact."""
    vals = np.atleast_1d(np.asarray(col, object))
    out = np.zeros(len(vals), np.int32)
    for i, v in enumerate(vals):
        if isinstance(v, str):
            key = v.strip().lower()
            if key not in _CENSOR_NAMES:
                raise ValueError(f"unknown censoring label {v!r}; use one "
                                 f"of {sorted(set(_CENSOR_NAMES))}")
            out[i] = _CENSOR_NAMES[key]
        elif isinstance(v, (bool, np.bool_)):
            out[i] = 1 if v else 0
        elif v is None or (isinstance(v, float) and np.isnan(v)):
            out[i] = 0
        else:
            iv = int(v)
            if iv not in (0, 1, 2):
                raise ValueError(f"censoring flag must be 0 (exact), "
                                 f"1 (left) or 2 (right), got {v!r}")
            out[i] = iv
    return out


def censor_by_state(df: pd.DataFrame, states) -> Dict[str, np.ndarray]:
    """Per-state censoring flags of the dataframe's 'censored' column, or
    {} when it has none or nothing is censored."""
    if "censored" not in df.columns:
        return {}
    out = {s: parse_censor_column(df.loc[[s]]["censored"].to_numpy())
           for s in states}
    return out if any(c.any() for c in out.values()) else {}


def build_obsdata_host(df: pd.DataFrame, times: np.ndarray,
                       post_snames) -> Tuple[ObsData, Tuple[str, ...]]:
    """Flatten per-state observations (``post_snames`` order) into one
    host :class:`ObsData`. Returns (obsdata, observed_state_names). Rows of
    a ``censored`` column (:func:`parse_censor_column`) hold a detection
    limit, not a measurement: they are scored by the Tobit likelihood and
    left out of the R^2 sums (``sstot`` here)."""
    pred_tindex, logab, logsig = fit_setup(df, np.asarray(times))
    observed = tuple(s for s in post_snames if s in pred_tindex)
    if not observed:
        raise ValueError(
            f"No dataframe organisms match model states {post_snames}; "
            f"found organisms {sorted(pred_tindex)}")
    cen = censor_by_state(df, observed)
    la, ls, ti, si, ce = [], [], [], [], []
    sstot = 0.0
    for s in observed:
        la.append(logab[s])
        ls.append(logsig[s])
        ti.append(pred_tindex[s])
        si.append(np.full(len(logab[s]), post_snames.index(s), np.int32))
        ab = np.exp(logab[s])
        if cen:
            ce.append(cen[s])
            ab = ab[cen[s] == 0]
        if ab.size:
            sstot += ab.shape[0] * np.var(ab)
    la = np.concatenate(la)
    return ObsData(log_abundance=la, log_sigma=np.concatenate(ls),
                   abundance=np.exp(la), t_index=np.concatenate(ti),
                   state_index=np.concatenate(si),
                   sstot=np.asarray(sstot),
                   censor=np.concatenate(ce) if cen else None), observed


def compact_observation_grid(obs: ObsData, times,
                             extra_times=None) -> Tuple[np.ndarray, ObsData]:
    """Shrink the integration grid to the observed times (plus the origin
    and any ``extra_times``, snapped to the full grid first: the dose
    times, so that a dose lands where a full-grid solve puts it). Returns
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
