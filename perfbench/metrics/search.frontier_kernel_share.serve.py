"""search.frontier_kernel_share.serve (fraction): the share of the beam
loop's hops whose frontier step ran the ``frontier`` CUDA kernel in an open
loop: the program's ``search.beam`` spans (``core/search.py``; attributes
``hops`` and ``frontier_hops``) of every batch served in the window,
``frontier_hops`` summed over ``hops`` summed.  None where the spans carry
no ``frontier_hops`` (a program whose frontier step has no kernel).
Nothing to read off the card."""

from perfbench.yard import frontier_hops, spans


def read(ctx):
    if ctx.device.type != "cuda" or ctx.loop != "open":
        return None
    return frontier_hops.share(spans.named(ctx.spans, "search.beam"))
