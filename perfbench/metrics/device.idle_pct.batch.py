"""device.idle_pct.batch (%): the share of the profiled slice's wall time
that no device interval (a kernel, a copy or a memset) covers, taken as the
union of the intervals, in a closed loop."""

from perfbench.yard import intervals


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or tr.hi <= tr.lo:
        return None
    return 100.0 * intervals.idle_share(tr.device_intervals, tr.lo, tr.hi)
