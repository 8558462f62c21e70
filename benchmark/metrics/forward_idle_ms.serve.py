"""Device-idle ms a batch inside the program's ``serve.forward`` spans: for
each span, its length on the host clock less the union of the device's
kernel, copy and memset intervals clipped to it. The part of
``idle_share.serve`` that the program's own host work causes (dispatch,
the blocking frame copy, allocation); the rest of the slice's idle time is
the caller's. None when the slice holds no such span. Moves
``faces_per_s``."""

from benchmark.trace import union_length

SPAN = "serve.forward"


def read(sl, ctx):
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in sl.events
             if e.get("cat") == "user_annotation" and e.get("name") == SPAN]
    if not spans:
        return None
    idle = 0.0
    for a, b in spans:
        clipped = [(max(e["ts"], a), min(e["ts"] + e["dur"], b)) for e in sl.device]
        idle += (b - a) - union_length([(x, y) for x, y in clipped if y > x])
    return idle * 1e-3 / sl.steps
