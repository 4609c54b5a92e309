"""peak_gib (GiB): ``torch.cuda.max_memory_allocated()`` over the window,
reset at its start, so the resident index counts."""


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    return ctx.peak_bytes / 2**30
