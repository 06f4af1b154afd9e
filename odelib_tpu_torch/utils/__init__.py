"""Host-side utilities: convergence diagnostics, posterior files, the
predictive criteria (WAIC, PSIS-LOO) with their Pareto smoothing,
simulation-based calibration, sensitivity analysis, stage timing, tracing
and the package logger."""
from .checkpoint import load_posterior, resume_theta, save_posterior
from .diagnostics import effective_sample_size, split_rhat, summarize
from .profiling import StageTimer, get_logger, trace
from .sbc import SBCResult, rank_uniformity_pvalue, sbc_ranks

__all__ = ["save_posterior", "load_posterior", "resume_theta",
           "StageTimer", "get_logger", "trace",
           "effective_sample_size", "split_rhat", "summarize",
           "sbc_ranks", "rank_uniformity_pvalue", "SBCResult"]
