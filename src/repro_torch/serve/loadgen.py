"""Open-loop load generation: Poisson and diurnal arrival processes (the JAX
package's ``repro.serve.loadgen``, copied).

``run_load`` submits queries against a running server on an open-loop clock
(arrivals don't wait for completions — the only honest way to measure tail
latency under load) and returns every Response.  Patterns:

  poisson  exponential inter-arrival gaps at constant rate ``rps``
  diurnal  Poisson thinned by a sinusoidal day curve — rate sweeps
           ``rps * (1 +/- diurnal_amp)`` over ``period_s``
  uniform  fixed gaps (deterministic spacing, for debugging)

An optional ``mutate_fn`` is invoked on its own thread every
``mutate_every_s`` to drive live churn (appends/deletes on the MutableIndex
behind the server) while traffic is in flight.
"""
from __future__ import annotations

import threading
import time

import numpy as np


def _gaps(pattern: str, rps: float, duration_s: float, rng,
          diurnal_amp: float = 0.6, period_s: float | None = None):
    """Yield inter-arrival gaps (seconds) until ``duration_s`` is covered."""
    t = 0.0
    period = period_s or duration_s
    while t < duration_s:
        if pattern == "poisson":
            gap = rng.exponential(1.0 / rps)
        elif pattern == "uniform":
            gap = 1.0 / rps
        elif pattern == "diurnal":
            rate = rps * (1.0 + diurnal_amp
                          * np.sin(2 * np.pi * t / period))
            gap = rng.exponential(1.0 / max(rate, 1e-3))
        else:
            raise ValueError(f"unknown arrival pattern {pattern!r}")
        t += gap
        if t < duration_s:
            yield gap


def run_load(server, queries: np.ndarray, rps: float, duration_s: float,
             pattern: str = "poisson", k: int | None = None,
             ef: int | None = None, deadline_ms: float | None = None,
             ef_mix: list | None = None, k_mix: list | None = None,
             seed: int = 0, mutate_fn=None, mutate_every_s: float = 1.0,
             diurnal_amp: float = 0.6, period_s: float | None = None,
             wait: bool = True) -> list:
    """Drive ``server`` with an open-loop arrival process; returns Responses.

    ``ef_mix``/``k_mix`` cycle per-request knobs through the given values to
    exercise heterogeneous-traffic batching; scalar ``ef``/``k`` win if set.
    """
    rng = np.random.default_rng(seed)
    futures = []
    stop_mutate = threading.Event()
    mutator = None
    if mutate_fn is not None:
        def _mutate_loop():
            while not stop_mutate.wait(mutate_every_s):
                mutate_fn()

        mutator = threading.Thread(target=_mutate_loop, daemon=True,
                                   name="serve-loadgen-mutator")
        mutator.start()

    try:
        i = 0
        t_next = time.perf_counter()
        for gap in _gaps(pattern, rps, duration_s, rng,
                         diurnal_amp=diurnal_amp, period_s=period_s):
            t_next += gap
            delay = t_next - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            q = queries[i % len(queries)]
            kw = dict(deadline_ms=deadline_ms)
            kw["ef"] = ef if ef is not None else (
                ef_mix[i % len(ef_mix)] if ef_mix else None)
            kw["k"] = k if k is not None else (
                k_mix[i % len(k_mix)] if k_mix else None)
            futures.append(server.submit(q, **kw))
            i += 1
    finally:
        stop_mutate.set()
        if mutator is not None:
            mutator.join(timeout=5)

    if not wait:
        return futures
    return [f.result(timeout=60) for f in futures]
