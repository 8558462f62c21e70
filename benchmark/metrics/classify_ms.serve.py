"""Device ms a batch of the kernels launched inside the pipeline's
``_classify`` stage (normalization, the classifier, attention, head and
softmax), from the profiled slice. Moves ``faces_per_s``."""


def read(sl, ctx):
    ms = sl.range_ms("bench.classify")
    return None if ms is None else ms / sl.steps
