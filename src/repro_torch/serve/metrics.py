"""Serving metrics: latency tail, goodput, degradation, swap accounting.

The JAX package's ``repro.serve.metrics``, copied.  One :class:`Metrics`
instance rides on a server: a thin façade over a private
:class:`repro_torch.obs.Registry`.  Statuses and resilience events are typed
counters, latencies go into bounded quantile sketches
(``repro_torch.obs.QuantileSketch``), so a server absorbs any number of
requests at a **fixed memory footprint** (see :meth:`footprint_bytes`).

``summary()`` has the JAX package's key set (percentiles are sketch
quantiles, ~1% relative error), including:

  errors_by_type   exception-class histogram of errored futures, so a chaos
                   run can tell ``InjectedCrash`` from a real poison
  stages           per-stage latency percentiles (queue / exec / resolve)
  fee_exit_fraction  live FEE early-exit fraction (1 - dims touched / dims
                   scored lanes could touch) when the backend reports lane
                   counters

The underlying registry is exposed as ``metrics.registry`` for exporters
(``launch/serve.py --metrics-out``) and the chaos report.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

from repro_torch.obs import Registry

# coarse per-request stages recorded as histograms (the fine-grained
# bucket_pad/topk_slice split lives in the span tracer; these three are the
# ones cheap enough to sketch on every response)
STAGE_KEYS = ("queue", "exec", "resolve")


class Metrics:
    def __init__(self, slo_ms: float, registry: Registry | None = None):
        self.slo_ms = slo_ms
        # private registry by default: parallel servers/tests never share
        # counters; library-level counters live in obs.default_registry()
        self.registry = registry if registry is not None else Registry("serve")
        r = self.registry
        self._requests = r.counter("serve.requests", "responses recorded")
        self._status = {s: r.counter(f"serve.status.{s}")
                        for s in ("ok", "shed", "timeout")}
        self._degraded = r.counter("serve.degraded",
                                   "served below the requested ef bucket")
        self._good = r.counter("serve.good", "ok within deadline (goodput)")
        self._errors = r.counter("serve.errors",
                                 "futures resolved with an exception")
        self._lat = r.histogram("serve.latency_ms",
                                "end-to-end total_ms of ok responses")
        self._stage = {k: r.histogram(f"serve.stage.{k}_ms")
                       for k in STAGE_KEYS}
        self._lanes = r.counter("serve.search.lanes_evaluated")
        self._dims = r.counter("serve.search.dims_touched")
        self._dims_max = r.counter("serve.search.dims_possible")
        self._swap_installs = r.counter("serve.swap.installs")
        self._swap_deltas = r.counter("serve.swap.delta_installs")
        self._swap_bytes = r.counter("serve.swap.h2d_bytes")

        self._lock = threading.Lock()
        self._swaps: deque = deque(maxlen=64)   # recent UploadStats (bounded)
        self._swap_max_frac = 0.0
        self._err_types: dict = {}              # exception class -> count
        self._resid: dict = {}                  # ef bucket -> [n_eval, n_resid]
        self._events: dict = {}                 # resilience event counters
        self.cold_start_ms: float | None = None
        self._t0 = time.perf_counter()
        self._t_last = self._t0

    def start_clock(self) -> None:
        with self._lock:
            self._t0 = time.perf_counter()
            self._t_last = self._t0

    def record(self, resp) -> None:
        self._requests.inc()
        c = self._status.get(resp.status)
        if c is not None:
            c.inc()
        if resp.degraded:
            self._degraded.inc()
        if resp.status == "ok":
            if not resp.deadline_missed:
                self._good.inc()
            self._lat.observe(resp.total_ms)
            self._stage["queue"].observe(resp.queue_ms)
            self._stage["exec"].observe(resp.service_ms)
            self._stage["resolve"].observe(
                max(resp.total_ms - resp.queue_ms - resp.service_ms, 0.0))
        with self._lock:
            self._t_last = time.perf_counter()

    def record_swap(self, stats) -> None:
        self._swap_installs.inc()
        if stats.mode == "delta":
            self._swap_deltas.inc()
            with self._lock:
                self._swap_max_frac = max(self._swap_max_frac,
                                          stats.reupload_fraction)
        self._swap_bytes.inc(stats.h2d_bytes)
        with self._lock:
            self._swaps.append(stats)

    def record_error(self, exc: BaseException | None = None) -> None:
        """A request future was resolved with an exception (poisoned query,
        batch execution failure that bisection could not isolate away).
        Error *types* are counted so ``summary()["errors_by_type"]`` can tell
        an injected chaos fault from a real poison."""
        self._errors.inc()
        name = type(exc).__name__ if exc is not None else "unknown"
        with self._lock:
            self._err_types[name] = self._err_types.get(name, 0) + 1
            self._t_last = time.perf_counter()

    def record_residual(self, ef_bucket: int, n_eval: float,
                        n_resid: float) -> None:
        """Accumulate tiered-storage fetch counters for one served batch:
        evaluated lanes vs lanes that survived the coarse tier and pulled
        residual words.  ``summary()`` reports the per-bucket fraction."""
        with self._lock:
            acc = self._resid.setdefault(ef_bucket, [0.0, 0.0])
            acc[0] += n_eval
            acc[1] += n_resid

    def record_batch(self, n_eval: float, dims: float, dim: int) -> None:
        """Live search counters of one served batch: lanes evaluated, feature
        dims actually streamed, and the dims a non-exiting run would have
        streamed — ``summary()`` turns these into the FEE exit fraction."""
        self._lanes.inc(n_eval)
        self._dims.inc(dims)
        self._dims_max.inc(n_eval * dim)

    def record_event(self, name: str, n: int = 1) -> None:
        """Count a named resilience event (``breaker_trip``,
        ``watchdog_restart_stalled``, ``swap_rollback``, ...)."""
        self.registry.counter(f"serve.event.{name}").inc(n)
        with self._lock:
            self._events[name] = self._events.get(name, 0) + n

    # -- reporting -----------------------------------------------------------
    def summary(self) -> dict:
        with self._lock:
            elapsed = max(self._t_last - self._t0, 1e-9)
            events = dict(self._events)
            err_types = dict(self._err_types)
            resid = {b: list(acc) for b, acc in self._resid.items()}
            swaps = list(self._swaps)
            swap_max_frac = self._swap_max_frac
        n = int(self._requests.value)
        out = dict(
            requests=n,
            ok=int(self._status["ok"].value),
            shed=int(self._status["shed"].value),
            timeout=int(self._status["timeout"].value),
            degraded=int(self._degraded.value),
            degraded_fraction=self._degraded.value / max(n, 1),
            goodput_qps=self._good.value / elapsed,
            elapsed_s=elapsed,
            slo_ms=self.slo_ms,
            cold_start_ms=self.cold_start_ms,
            errors=int(self._errors.value),
        )
        if err_types:
            out["errors_by_type"] = err_types
        if events:
            out["events"] = events
        if resid:
            out["residual_fetch_fraction"] = {
                str(b): round(acc[1] / max(acc[0], 1.0), 4)
                for b, acc in sorted(resid.items())}
        if self._dims_max.value > 0:
            out["fee_exit_fraction"] = round(
                1.0 - self._dims.value / self._dims_max.value, 4)
        if self._lat.count:
            p50, p99, p999 = self._lat.percentiles((0.5, 0.99, 0.999))
            out.update(p50_ms=p50, p99_ms=p99, p999_ms=p999,
                       mean_ms=self._lat.mean, max_ms=self._lat.max)
            out["stages"] = {
                k: dict(zip(("p50_ms", "p99_ms"),
                            (round(v, 4) for v in
                             h.percentiles((0.5, 0.99)))))
                for k, h in self._stage.items() if h.count}
        if swaps:
            deltas = [s for s in swaps if s.mode == "delta"]
            out["swaps"] = dict(
                installs=int(self._swap_installs.value),
                delta_installs=int(self._swap_deltas.value),
                h2d_bytes=int(self._swap_bytes.value),
                max_delta_reupload_fraction=max(
                    [swap_max_frac] + [s.reupload_fraction for s in deltas]),
                last=dataclasses.asdict(swaps[-1]),
            )
        return out

    def histogram(self, n_bins: int = 40) -> dict:
        """Log-spaced latency histogram (the CI artifact payload) — re-binned
        from the bounded sketch, same ``bins_ms``/``counts`` shape as before."""
        h = self._lat.histogram(n_bins)
        return dict(bins_ms=h["bins"], counts=h["counts"])

    def footprint_bytes(self) -> int:
        """Upper bound on the retained-state footprint, *independent of the
        request count*: sketch tables + the bounded swap deque + counters.
        The memory-bound regression test asserts this stays fixed while
        requests stream through."""
        sketches = sum(h.footprint_bytes()
                       for h in (self._lat, *self._stage.values()))
        return sketches + 64 * self._swaps.maxlen + 4096
