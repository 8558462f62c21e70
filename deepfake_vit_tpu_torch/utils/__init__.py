"""Host-side utilities of the port (weights I/O)."""
