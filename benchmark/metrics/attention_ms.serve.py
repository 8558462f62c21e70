"""Device ms a batch of the kernels launched inside the classifier's
``classify.attention`` spans (the B4's HybridAttention once a batch; each
ViT block's attention, 12 a batch: the QKV and output projections, QKᵀ,
softmax, ·V), from the profiled slice; None when there is no such span.
Moves ``faces_per_s``."""


def read(sl, ctx):
    ms = sl.range_ms("classify.attention")
    return None if ms is None else ms / sl.steps
