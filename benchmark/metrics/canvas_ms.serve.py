"""Device ms a batch of the kernels launched inside the program's
``serve.canvas`` span (the frames' cast to the pipeline's dtype and the
normalized detection canvas, ``_canvas``), from the profiled slice; None
when the span is missing or launched no kernel. Moves ``faces_per_s``."""


def read(sl, ctx):
    ms = sl.range_ms("serve.canvas")
    return None if ms is None else ms / sl.steps
