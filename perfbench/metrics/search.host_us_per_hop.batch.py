"""search.host_us_per_hop.batch (us): the host's time a hop of the beam
loop in a closed loop: the program's ``search.beam`` spans
(``core/search.py``, one a query chunk; attribute ``hops``, the loop's
iterations) summed, over their hops summed, in the calls after the profiled
ones (the profiler slows the host).  Nothing to read off the card."""

from perfbench.yard import spans


def read(ctx):
    if ctx.device.type != "cuda" or ctx.loop != "closed":
        return None
    n_traced = int(ctx.cell.traffic.get("trace", {}).get("calls", 3))
    if len(ctx.calls) <= n_traced:
        return None
    cut = ctx.calls[n_traced - 1][4] * 1e9
    beams = [s for s in spans.named(ctx.spans, "search.beam") if s.t0_ns > cut]
    return spans.us_per_hop(beams)
