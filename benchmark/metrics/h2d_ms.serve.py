"""Device ms a batch of host-to-device copies (``forward``'s copy of the
pinned frames), from the memcpy records of the profiled slice. Moves
``faces_per_s``."""


def read(sl, ctx):
    ms = sl.memcpy_ms("HtoD")
    return ms / sl.steps if ms > 0 else None
