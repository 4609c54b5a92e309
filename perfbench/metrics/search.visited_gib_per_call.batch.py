"""search.visited_gib_per_call.batch (GiB): the visited bitmap a search call
zeroes and writes in a closed loop: the ``visited_bytes`` attribute of the
program's ``search.beam`` spans (``core/search.py``, one a query chunk)
summed within each ``search.call`` span, over 2^30, as the mean over the
profiled calls.  None where the beam spans carry no ``visited_bytes`` (a
program that does not report them).  Nothing to read off the card."""

from perfbench.yard import chunks, spans


def read(ctx):
    if ctx.device.type != "cuda" or ctx.loop != "closed":
        return None
    calls = chunks.profiled_calls(ctx, spans.named(ctx.spans, "search.call"))
    return chunks.visited_gib(calls, spans.named(ctx.spans, "search.beam"))
