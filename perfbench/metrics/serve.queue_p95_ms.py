"""serve.queue_p95_ms (ms): the 95th percentile of the program's
``queue_wait`` spans (``serve/batcher.py``: submit to batch formation), over
the requests submitted before the profiled slice, which slows the host."""

import numpy as np


def read(ctx):
    if not ctx.spans or ctx.slice is None:
        return None
    cut = ctx.slice[0] * 1e9
    waits = [s.dur_ns / 1e6 for s in ctx.spans
             if s.name == "queue_wait" and s.t0_ns < cut]
    return float(np.percentile(waits, 95)) if waits else None
