"""Kernels a batch launched inside the program's ``serve.forward`` spans:
the kernel records whose launch (a CUDA runtime or driver call on the
span's thread, ``cudaGraphLaunch`` among them, matched by its correlation
id) lies inside a span, over the slice's batches. Counted from the device's
records, so it holds under a captured CUDA graph, whose kernels carry the
graph launch's correlation id, and counts library kernels as well as the
hand-written ones. None when the slice holds no such span or it launched
no kernel. Moves ``faces_per_s``."""

from collections import defaultdict

from benchmark.trace import LAUNCH_CATS

SPAN = "serve.forward"


def read(sl, ctx):
    spans = defaultdict(list)
    for e in sl.events:
        if e.get("cat") == "user_annotation" and e.get("name") == SPAN:
            spans[e.get("tid")].append((e["ts"], e["ts"] + e["dur"]))
    corr = {e["args"]["correlation"] for e in sl.events
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})
            and any(a <= e["ts"] <= b for a, b in spans.get(e.get("tid"), ()))}
    n = sum(1 for e in sl.kernels if e.get("args", {}).get("correlation") in corr)
    return n / sl.steps if n else None
