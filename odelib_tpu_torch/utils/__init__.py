"""Host-side utilities: convergence diagnostics and posterior files."""
