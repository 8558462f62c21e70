"""Detection and alignment constants of the serving path."""
