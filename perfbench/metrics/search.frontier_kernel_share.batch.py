"""search.frontier_kernel_share.batch (fraction): the share of the beam
loop's hops whose frontier step (neighbour gather, visited test, dedup,
compaction, visited update) ran the ``frontier`` CUDA kernel in a closed
loop: the program's ``search.beam`` spans (``core/search.py``, one a query
chunk; attributes ``hops`` and ``frontier_hops``) over the window,
``frontier_hops`` summed over ``hops`` summed.  None where the spans carry
no ``frontier_hops`` (a program whose frontier step has no kernel).
Nothing to read off the card."""

from perfbench.yard import frontier_hops, spans


def read(ctx):
    if ctx.device.type != "cuda" or ctx.loop != "closed":
        return None
    return frontier_hops.share(spans.named(ctx.spans, "search.beam"))
