"""Whole serving step's share of the card's bf16 peak: the detector's and
the classifier's operations for a batch (``counts.py``) times the batches of
the traced run's unprofiled window, over that window's seconds and 989
TFLOP/s. Moves ``faces_per_s``."""

from benchmark.peaks import BF16_FLOPS


def read(sl, ctx):
    if not ctx.get("window_steps"):
        return None
    return 100.0 * ctx["flops_per_step"] * ctx["window_steps"] / ctx["window_s"] / BF16_FLOPS
