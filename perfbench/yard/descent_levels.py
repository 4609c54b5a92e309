"""The share of the descent's upper levels that the port's ``descend`` CUDA
kernel walked, from the program's ``search.descend`` spans (attributes
``levels`` and ``kernel_levels``, ``core/search.py``)."""
from __future__ import annotations


def share(descents) -> float | None:
    """``kernel_levels`` summed over ``levels`` summed, over the spans that
    carry ``kernel_levels``; None where none does (a program whose descent
    has no kernel) or no level was walked."""
    tagged = [s.attrs for s in descents if "kernel_levels" in (s.attrs or {})]
    levels = sum(a.get("levels", 0) for a in tagged)
    if levels <= 0:
        return None
    return sum(a["kernel_levels"] for a in tagged) / levels
