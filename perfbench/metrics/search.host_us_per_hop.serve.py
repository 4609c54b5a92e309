"""search.host_us_per_hop.serve (us): the host's time a hop of the beam
loop in an open loop: the program's ``search.beam`` spans
(``core/search.py``; attribute ``hops``, the loop's iterations) summed,
over their hops summed, in the batches that ended before the profiled
slice.  Nothing to read off the card."""

from perfbench.yard import spans


def read(ctx):
    if ctx.device.type != "cuda" or ctx.slice is None:
        return None
    cut = ctx.slice[0] * 1e9
    beams = [s for s in spans.named(ctx.spans, "search.beam") if s.t1_ns <= cut]
    return spans.us_per_hop(beams)
