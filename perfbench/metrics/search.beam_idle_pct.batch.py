"""search.beam_idle_pct.batch (%): the share of the profiled slice's
``search.beam`` ranges (the program's beam-loop spans, which stand among the
profiler's host events while it records) that no device interval (a kernel,
a copy or a memset) covers, in a closed loop: the device waiting on the
host inside the loop."""

from perfbench.yard import intervals


def read(ctx):
    tr = ctx.trace
    if ctx.device.type != "cuda" or tr is None or not tr.device:
        return None
    beams = [(s, e) for n, s, e in tr.host if n == "search.beam" and e > s]
    if not beams:
        return None
    dev = intervals.union(tr.device_intervals)
    busy = sum(intervals.busy(dev, s, e) for s, e in beams)
    return 100.0 * (1.0 - busy / sum(e - s for s, e in beams))
