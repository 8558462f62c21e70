"""Device ms a batch of the kernels launched inside the Swin classifier's
``classify.window`` spans (each block's window half, 24 a batch: the roll,
the window partition, the QKV projection, the relative position bias and
shift mask, the attention core, the output projection, the reverse and the
roll back; LayerNorm 1 lies outside), from the profiled slice; None when
there is no such span. Moves ``faces_per_s``."""


def read(sl, ctx):
    ms = sl.range_ms("classify.window")
    return None if ms is None else ms / sl.steps
