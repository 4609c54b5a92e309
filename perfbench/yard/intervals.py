"""Device timelines: the union of busy intervals, the idle share of a
window and its longest idle gaps.

Intervals are ``(start, end)`` pairs in one clock (any unit); overlapping
intervals (kernels on two streams, a copy under a kernel) count once.
"""
from __future__ import annotations


def union(intervals, lo: float | None = None, hi: float | None = None) -> list:
    """Sorted, disjoint intervals covering ``intervals``, clipped to
    ``[lo, hi]`` when given; empty intervals are dropped."""
    merged = []
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def busy(intervals, lo: float, hi: float) -> float:
    """Length of ``[lo, hi]`` covered by at least one interval."""
    return sum(e - s for s, e in union(intervals, lo, hi))


def idle_share(intervals, lo: float, hi: float) -> float | None:
    """Share of the window ``[lo, hi]`` that no interval covers; None for an
    empty window (there is nothing to read)."""
    if hi <= lo:
        return None
    return 1.0 - busy(intervals, lo, hi) / (hi - lo)


def gaps(intervals, lo: float, hi: float) -> list:
    """The idle gaps of ``[lo, hi]`` as ``(start, end)``, longest first."""
    out, t = [], lo
    for s, e in union(intervals, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return sorted(out, key=lambda g: g[0] - g[1])
