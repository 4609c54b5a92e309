"""search.graph_hop_share.serve (fraction): the share of the beam loop's hops
that were replays of a captured CUDA graph in an open loop: the program's
``search.beam`` spans (``core/search.py``; attributes ``hops`` and
``graph_hops``) of every batch served in the window, ``graph_hops`` summed
over ``hops`` summed.  None where the spans carry no ``graph_hops`` (a
program that never captures its hop).  Nothing to read off the card."""

from perfbench.yard import graph_hops, spans


def read(ctx):
    if ctx.device.type != "cuda" or ctx.loop != "open":
        return None
    return graph_hops.share(spans.named(ctx.spans, "search.beam"))
