"""Tracing, per-stage timing and the package logger.

Counterpart of ``odelib_tpu/utils/profiling.py``:

* :func:`get_logger` — the one ``logging.Logger`` of the package
  (``odelib_tpu_torch``), with an INFO ``StreamHandler`` in the
  ``[%(name)s] %(message)s`` format attached once, lazily. The routing
  banners, swap rates and run-length extensions go through it, so a user
  silences or redirects them with standard ``logging`` configuration.
  Unlike the JAX package's logger it propagates to the root logger, so
  that ``caplog`` and a root handler see its records (a root handler
  then prints them a second time).
* :class:`StageTimer` — named wall-clock stages and their report, which
  ``MCMC(profile=True)`` logs.
* :func:`trace` — ``torch.profiler`` around a block of framework code,
  writing a trace that Chrome (``chrome://tracing``) and TensorBoard's
  profiler plugin load.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Optional

_LOGGER_NAME = "odelib_tpu_torch"


def get_logger() -> logging.Logger:
    """The package logger; its INFO handler attached once, lazily."""
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("[%(name)s] %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


class StageTimer:
    """Accumulate named wall-clock stages.

    Callers synchronise the device inside a stage for its number to count
    the device's work (``MCMC(profile=True)`` does)::

        timer = StageTimer()
        with timer.stage("survey"):
            ...
        timer.report()   # through the package logger
    """

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = (self.times.get(name, 0.0)
                                + time.perf_counter() - t0)

    def report(self, logger: Optional[logging.Logger] = None) -> str:
        logger = logger or get_logger()
        total = sum(self.times.values()) or 1.0
        lines = ["stage timings:"]
        for name, t in self.times.items():
            lines.append(f"  {name:<14s} {t:8.3f}s  ({100 * t / total:5.1f}%)")
        msg = "\n".join(lines)
        logger.info(msg)
        return msg


@contextlib.contextmanager
def trace(logdir: str):
    """Record a ``torch.profiler`` trace of the enclosed block (the host's
    operators, and the card's kernels and copies when CUDA is available)
    into ``logdir`` as ``<host>_<pid>.<time>.pt.trace.json``. Open it in
    Chrome's ``chrome://tracing`` or TensorBoard's profiler plugin::

        with odelib_tpu_torch.utils.trace("odelib-trace"):
            model.MCMC(chain_inits=10_000, iterations_per_chain=1000)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, on_trace_ready=torch.profiler.
                 tensorboard_trace_handler(logdir)):
        yield
