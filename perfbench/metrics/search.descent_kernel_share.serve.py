"""search.descent_kernel_share.serve (fraction): the share of the upper
levels that the descent walked in the ``descend`` CUDA kernel in an open
loop: the program's ``search.descend`` spans (``core/search.py``;
attributes ``levels`` and ``kernel_levels``) of every batch served in the
window, ``kernel_levels`` summed over ``levels`` summed.  None where the
spans carry no ``kernel_levels`` (a program whose descent has no kernel).
Nothing to read off the card."""

from perfbench.yard import descent_levels, spans


def read(ctx):
    if ctx.device.type != "cuda" or ctx.loop != "open":
        return None
    return descent_levels.share(spans.named(ctx.spans, "search.descend"))
