"""Launch calls: the host's calls into the CUDA runtime or driver that
start device work, read from the names of the profiler's host events.

A kernel launch and a graph launch each count as one call, so a captured
hop reads as fewer calls whatever implements it.  Copies and memsets are
not launches.
"""
from __future__ import annotations

LAUNCH_PREFIXES = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
                   "cuLaunchKernel", "cuLaunchCooperativeKernel",
                   "cudaGraphLaunch", "cuGraphLaunch")


def is_launch(name: str) -> bool:
    return name.startswith(LAUNCH_PREFIXES)


def count(names) -> int:
    """Launch calls among the host event names ``names``."""
    return sum(1 for n in names if is_launch(n))


def per_query(names, n_queries: int) -> float | None:
    """Launch calls per query served; None when no query was served or no
    call was seen (nothing to read)."""
    n = count(names)
    if n_queries <= 0 or n == 0:
        return None
    return n / n_queries
