"""Device ms a batch of the kernels launched inside the clip classifier's
``classify.temporal`` spans (each TimeSformer block's temporal half, 12 a
batch: the move to patch-major sequences, LayerNorm, the QKV projection,
the 8-token attention, its output projection, ``Dense_td`` and the move
back), from the profiled slice; None when there is no such span. Moves
``faces_per_s``."""


def read(sl, ctx):
    ms = sl.range_ms("classify.temporal")
    return None if ms is None else ms / sl.steps
