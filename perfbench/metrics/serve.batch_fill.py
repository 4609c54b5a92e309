"""serve.batch_fill (fraction): the mean over device batches of the
requests a batch carried over its padded batch bucket, from the program's
``bucket_pad`` spans (attributes ``n`` and ``bucket``; one span a request,
the same stamps for a batch), before the profiled slice."""


def read(ctx):
    if not ctx.spans or ctx.slice is None:
        return None
    cut = ctx.slice[0] * 1e9
    batches = {}
    for s in ctx.spans:
        if s.name == "bucket_pad" and s.t0_ns < cut and s.attrs:
            batches[(s.t0_ns, s.dur_ns)] = s.attrs["n"] / s.attrs["bucket"]
    return sum(batches.values()) / len(batches) if batches else None
