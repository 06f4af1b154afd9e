"""Host-side utilities: convergence diagnostics, posterior files and the
predictive criteria (WAIC, PSIS-LOO) with their Pareto smoothing."""
