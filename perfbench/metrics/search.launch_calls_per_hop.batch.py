"""search.launch_calls_per_hop.batch (calls): the host's kernel- and
graph-launch calls that start inside the profiled slice's ``search.hop``
ranges (one hop's work without its termination test; the program's spans,
among the profiler's host events while it records), over the number of
those ranges, in a closed loop."""

from perfbench.yard import launches, spans


def read(ctx):
    tr = ctx.trace
    if ctx.device.type != "cuda" or tr is None:
        return None
    hops = [(s, e) for n, s, e in tr.host if n == "search.hop"]
    if not hops:
        return None
    starts = [s for n, s, _ in tr.host if launches.is_launch(n)]
    n = spans.count_inside(hops, starts)
    return n / len(hops) if n else None
