"""The share of the beam loop's hops whose frontier step ran the port's
``frontier`` CUDA kernel, from the program's ``search.beam`` spans
(attributes ``hops`` and ``frontier_hops``, ``core/search.py``)."""
from __future__ import annotations


def share(beams) -> float | None:
    """``frontier_hops`` summed over ``hops`` summed, over the spans that
    carry ``frontier_hops``; None where none does (a program whose frontier
    step has no kernel) or no hop was run."""
    tagged = [s.attrs for s in beams if "frontier_hops" in (s.attrs or {})]
    hops = sum(a.get("hops", 0) for a in tagged)
    if hops <= 0:
        return None
    return sum(a["frontier_hops"] for a in tagged) / hops
