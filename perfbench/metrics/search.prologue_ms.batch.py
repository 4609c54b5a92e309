"""search.prologue_ms.batch (ms): the host's time before a search call's
beam loop in a closed loop: the mean over the program's ``search.call``
spans (``index/backends.py``) of the ``search.transform`` (host sPCA, the
copy to the device) and ``search.descend`` (the upper levels' greedy
descent) spans inside each, over the calls after the profiled ones (the
profiler slows the host).  Nothing to read off the card."""

from perfbench.yard import spans


def read(ctx):
    if ctx.device.type != "cuda" or ctx.loop != "closed":
        return None
    n_traced = int(ctx.cell.traffic.get("trace", {}).get("calls", 3))
    if len(ctx.calls) <= n_traced:
        return None
    cut = ctx.calls[n_traced - 1][4] * 1e9
    calls = [s for s in spans.named(ctx.spans, "search.call") if s.t0_ns > cut]
    inner = [s for s in ctx.spans
             if s.name in ("search.transform", "search.descend")]
    per_call = spans.inside(calls, inner)
    if not per_call:
        return None
    return sum(sum(s.dur_ns for s in kids) for kids in per_call) / len(per_call) / 1e6
