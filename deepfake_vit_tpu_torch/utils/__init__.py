"""Host-side utilities of the port (weights, checkpoint and config I/O)."""
