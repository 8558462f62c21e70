"""Share of the profiled slice of steady batches in which no kernel, copy
or memset ran on the card: 1 − (union of device intervals ÷ the slice's
span on the host clock). Moves ``faces_per_s``."""


def read(sl, ctx):
    if not sl.device:
        return None
    return 100.0 * (1.0 - sl.busy_s() / sl.window_s)
