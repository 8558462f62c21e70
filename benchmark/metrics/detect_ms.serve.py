"""Device ms a batch of the kernels launched inside the pipeline's
``_detect`` stage (the detector network, anchor decode and face selection),
from the profiled slice; the harness wraps the stage in a range in traced
runs only. Moves ``faces_per_s``."""


def read(sl, ctx):
    ms = sl.range_ms("bench.detect")
    return None if ms is None else ms / sl.steps
