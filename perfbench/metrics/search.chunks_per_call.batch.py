"""search.chunks_per_call.batch (chunks): how many query chunks a search
call's beam ran in, one after another, in a closed loop: the program's
``search.beam`` spans (``core/search.py``, one a chunk) counted inside each
``search.call`` span (``index/backends.py``), as the mean over the
profiled calls.  A chunk's visited bitmap is ``ceil(N/32)`` words a query
under a fixed budget, so a larger index takes fewer queries a chunk.  None
where no profiled call holds a beam span.  Nothing to read off the card."""

from perfbench.yard import chunks, spans


def read(ctx):
    if ctx.device.type != "cuda" or ctx.loop != "closed":
        return None
    calls = chunks.profiled_calls(ctx, spans.named(ctx.spans, "search.call"))
    return chunks.per_call(calls, spans.named(ctx.spans, "search.beam"))
