"""Arrival schedules of an open-loop traffic mix.

A schedule is the due time of every request of the window (seconds from
the window's start) and the query each one sends.  Kinds, as a traffic
file's ``arrivals`` names them:

  poisson   exponential gaps at ``rate_per_s``
  burst     Poisson bursts of ``burst_size`` requests due together, at
            ``rate_per_s`` requests a second on average

Every seed sends the same requests: the gaps and the queries (drawn
uniformly, with replacement, from the configuration's evaluation pool) come
from one draw of the traffic's ``base_seed``, and the run's seed deals them
in an order of its own.  So the load, its burstiness and the queries' work
are the seed's in order only, and runs of two seeds measure the same work.
"""
from __future__ import annotations

import numpy as np

from perfbench.gen.data import stream_seed


def schedule(traffic: dict, seed: int, seconds: float,
             n_queries: int) -> tuple[np.ndarray, np.ndarray]:
    """``(due_s, picks)``: float64 due times in ``[0, seconds)``, ascending,
    and the int64 query index of each request."""
    base = np.random.default_rng(stream_seed(int(traffic["base_seed"]), "arrivals"))
    order = np.random.default_rng(stream_seed(seed, "arrivals"))
    rate = float(traffic["rate_per_s"])
    kind = traffic["arrivals"]
    if kind not in ("poisson", "burst"):
        raise ValueError(f"unknown arrivals {kind!r}")
    size = int(traffic.get("burst_size", 1)) if kind == "burst" else 1
    n = int(rate / size * seconds * 2 + 64)      # draws covering the window
    gaps = base.exponential(size / rate, n)
    picks = base.integers(0, n_queries, n * size)
    gaps = gaps[: int(np.searchsorted(np.cumsum(gaps), seconds))]
    starts = np.cumsum(order.permutation(gaps))
    due = np.repeat(starts, size)
    return due, order.permutation(picks[: len(due)])


def permutations(seed: int, n_queries: int):
    """An endless stream of seeded permutations of the evaluation pool, one
    a call of a closed loop."""
    rng = np.random.default_rng(stream_seed(seed, "order"))
    while True:
        yield rng.permutation(n_queries)
