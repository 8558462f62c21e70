"""The Swin classifier's window halves' share of the card's bf16 peak:
their operations a batch (QKV, QKᵀ, ·V and the output projection over
every window, ``counts_swin.window_flops`` for each face) over the device
time of the kernels in the ``classify.window`` spans a batch and 989
TFLOP/s. None without the spans or the count. Moves ``faces_per_s``."""

from benchmark.peaks import BF16_FLOPS


def read(sl, ctx):
    ms = sl.range_ms("classify.window")
    flops = ctx.get("window_flops_per_step")
    if ms is None or not flops:
        return None
    return 100.0 * flops / (ms / sl.steps * 1e-3) / BF16_FLOPS
