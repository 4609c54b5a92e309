"""A search call's query chunks and their visited bitmaps, from the
program's spans: ``search.call`` (``index/backends.py``) and the
``search.beam`` spans inside it (one a chunk, attribute ``visited_bytes``,
``core/search.py``)."""
from __future__ import annotations

from perfbench.yard import spans


def profiled_calls(ctx, calls) -> list:
    """The ``search.call`` spans of a closed loop's profiled calls (its
    first ``trace.calls``), by their start on the program's clock."""
    n_traced = int(ctx.cell.traffic.get("trace", {}).get("calls", 3))
    if len(ctx.calls) < n_traced or n_traced <= 0:
        return []
    cut = ctx.calls[n_traced - 1][4] * 1e9
    return [s for s in calls if s.t0_ns <= cut]


def per_call(calls, beams) -> float | None:
    """The mean count of ``beams`` inside each of ``calls`` (the chunks
    that ran); None where no call holds a beam."""
    got = [len(kids) for kids in spans.inside(calls, beams) if kids]
    return sum(got) / len(got) if got else None


def visited_gib(calls, beams) -> float | None:
    """The mean over ``calls`` of the ``visited_bytes`` of the beams inside
    each, summed, over 2^30; None where no beam inside a call carries it."""
    per = [[b.attrs["visited_bytes"] for b in kids
            if "visited_bytes" in (b.attrs or {})]
           for kids in spans.inside(calls, beams)]
    per = [sum(v) for v in per if v]
    return sum(per) / len(per) / 2**30 if per else None
