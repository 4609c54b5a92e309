"""The program's spans as the readers take them: ``repro_torch.obs`` spans
(``name``, ``t0_ns``, ``t1_ns``, ``dur_ns``, ``tid``, ``attrs``) on the
program's monotonic clock, or (start, end) ranges of the profiler's host
events on the profiler's clock."""
from __future__ import annotations

import bisect


def named(spans, name: str) -> list:
    return [s for s in spans if s.name == name]


def us_per_hop(beams) -> float | None:
    """The ``search.beam`` spans' time summed over their ``hops`` summed, in
    microseconds; None with no hop to divide by."""
    hops = sum((s.attrs or {}).get("hops", 0) for s in beams)
    if hops <= 0:
        return None
    return sum(s.dur_ns for s in beams) / hops / 1e3


def inside(outer, inner) -> list:
    """For each span of ``outer`` (spans of one name, which do not overlap
    on a thread), the spans of ``inner`` that lie within it on its thread."""
    by_tid = {}
    for i, s in enumerate(outer):
        by_tid.setdefault(s.tid, []).append((s.t0_ns, i))
    for v in by_tid.values():
        v.sort()
    out = [[] for _ in outer]
    for s in inner:
        v = by_tid.get(s.tid)
        if not v:
            continue
        j = bisect.bisect_right(v, (s.t0_ns, len(outer))) - 1
        if j >= 0 and s.t1_ns <= outer[v[j][1]].t1_ns:
            out[v[j][1]].append(s)
    return out


def count_inside(ranges, points) -> int:
    """How many of ``points`` fall in one of ``ranges`` ((start, end) pairs
    that do not overlap)."""
    ranges = sorted(ranges)
    starts = [s for s, _ in ranges]
    n = 0
    for p in points:
        j = bisect.bisect_right(starts, p) - 1
        if j >= 0 and p <= ranges[j][1]:
            n += 1
    return n
