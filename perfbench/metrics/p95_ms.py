"""p95_ms (ms): the 95th percentile over every request due in an open
loop's window, each timed from when it was due to be sent to when its
future resolved.  A shed, timed-out or failed request, or one that never
resolved, counts as missing the latency limit: its time is at least the
limit."""

import numpy as np


def read(ctx):
    rec = ctx.record
    if ctx.loop != "open" or rec is None or not len(rec.due):
        return None
    lat = rec.latency_s * 1e3
    limit = float(ctx.latency_limit_ms)
    lat = np.where(rec.ok & np.isfinite(lat), lat,
                   np.maximum(np.nan_to_num(lat, nan=limit), limit))
    return float(np.percentile(lat, 95))
