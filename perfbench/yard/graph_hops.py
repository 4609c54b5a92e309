"""The share of the beam loop's hops that replayed a captured CUDA graph,
from the program's ``search.beam`` spans (attributes ``hops`` and
``graph_hops``, ``core/search.py``)."""
from __future__ import annotations


def share(beams) -> float | None:
    """``graph_hops`` summed over ``hops`` summed, over the spans that carry
    ``graph_hops``; None where none does (a program that never captures its
    hop) or no hop was run."""
    tagged = [s.attrs for s in beams if "graph_hops" in (s.attrs or {})]
    hops = sum(a.get("hops", 0) for a in tagged)
    if hops <= 0:
        return None
    return sum(a["graph_hops"] for a in tagged) / hops
