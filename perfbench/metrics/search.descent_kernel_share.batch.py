"""search.descent_kernel_share.batch (fraction): the share of the upper
levels that the descent walked in the ``descend`` CUDA kernel in a closed
loop: the program's ``search.descend`` spans (``core/search.py``, one a
search call; attributes ``levels`` and ``kernel_levels``) over the window,
``kernel_levels`` summed over ``levels`` summed.  None where the spans carry
no ``kernel_levels`` (a program whose descent has no kernel).  Nothing to
read off the card."""

from perfbench.yard import descent_levels, spans


def read(ctx):
    if ctx.device.type != "cuda" or ctx.loop != "closed":
        return None
    return descent_levels.share(spans.named(ctx.spans, "search.descend"))
