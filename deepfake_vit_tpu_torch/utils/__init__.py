"""Host-side utilities of the port: weights, checkpoint and config I/O, logging,
profiling, TensorBoard event files and visualizations."""
