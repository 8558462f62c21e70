"""Device ms a batch of the kernels launched inside the program's
``serve.align`` span (``_align``: Umeyama, the pooled crop and the warp),
from the profiled slice; None when the span is missing or launched no
kernel. Moves ``faces_per_s``."""


def read(sl, ctx):
    ms = sl.range_ms("serve.align")
    return None if ms is None else ms / sl.steps
