"""Low-overhead request tracing: monotonic spans into a bounded ring buffer.

A :class:`Tracer` records named spans (``perf_counter_ns`` start + duration)
from any thread.  Design constraints, in order:

  1. **Zero cost when disabled.**  ``tracer.span(...)`` returns a shared
     no-op singleton when tracing is off — no allocation, no lock, one
     attribute read on the hot path.  Code that derives spans from
     timestamps it already took (the batcher) guards the span construction
     behind ``tracer.enabled``.
  2. **Bounded memory.**  Completed spans land in a ring buffer
     (``deque(maxlen=capacity)``); old spans fall off the tail.  In-flight
     spans live only on their thread's stack object, so a ring wrap can
     never corrupt a span that hasn't finished.
  3. **Attribution.**  Spans carry an optional request id (``req``) plus
     free-form attributes; per-request timelines and Chrome-trace exports
     are derived views over the ring.

(A copy of the JAX package's ``repro.obs.trace``.)  The serving stages
instrumented end-to-end (see ``repro_torch.serve.batcher``)::

    queue_wait -> admission -> bucket_pad -> device_exec -> topk_slice
               -> resolve

plus named spans around generation hot-swap installs (``swap.install``), WAL
flushes (``wal.flush``) and watchdog restarts (instant events).

The local search call (``repro_torch.index.backends.local_searcher``) is
instrumented from the inside, with live spans and no request id::

    serve.batch                 one batcher run (batch, n, bucket)
      search.call               one ``run()`` (q, storage, ef)
        search.transform        host sPCA, queries copied to the device
        search.descend          upper-level greedy descent (levels, steps,
                                kernel_levels)
        search.beam             one query chunk's beam loop (q, hops,
                                visited_bytes: the chunk's bitmap)
          search.sync           the per-hop termination readback (mark)
          search.hop            one hop's launches and counter sums (mark)
        search.readback         results copied to the host

``serve.batch``'s ``batch`` is a process-wide sequence number that the
batch's ``device_exec`` spans carry too.  The two per-hop blocks are marks
(:meth:`Tracer.mark`): profiler ranges only, kept out of the ring, where
tens of thousands of them would cost the collector full passes.

**One clock with the device trace.**  While a ``torch.profiler`` records, a
live span or a mark also opens a profiler range of its name (torch's C++
``_RecordFunctionFast``), so it stands among the profiler's host events on
the profiler's clock (the wall clock, not ``perf_counter_ns``) and a device
gap can be placed inside it.  The profiler records such ranges on the
threads it profiles (by default the thread that started it).  Stamped spans
(:meth:`Tracer.add_span`) are not mirrored.

Export: :meth:`Tracer.chrome_trace` emits the Chrome ``chrome://tracing`` /
Perfetto JSON format (``{"traceEvents": [{"ph": "X", ...}]}``);
:meth:`Tracer.request_timeline` returns one request's ordered stage list with
millisecond durations.
"""
from __future__ import annotations

import json
import sys
import threading
import time
from collections import deque
from pathlib import Path

__all__ = ["Span", "Tracer", "tracer", "span", "enable_tracing",
           "disable_tracing", "SERVE_STAGES"]

# canonical request lifecycle stage names, in order (the timeline contract)
SERVE_STAGES = ("queue_wait", "admission", "bucket_pad", "device_exec",
                "topk_slice", "resolve")


class Span:
    """One completed span: name, start (perf_counter_ns), duration, thread."""

    __slots__ = ("name", "t0_ns", "dur_ns", "tid", "depth", "req", "attrs")

    def __init__(self, name: str, t0_ns: int, dur_ns: int, tid: int,
                 depth: int = 0, req=None, attrs: dict | None = None):
        self.name = name
        self.t0_ns = t0_ns
        self.dur_ns = dur_ns
        self.tid = tid
        self.depth = depth
        self.req = req
        self.attrs = attrs

    @property
    def t1_ns(self) -> int:
        return self.t0_ns + self.dur_ns

    @property
    def dur_ms(self) -> float:
        return self.dur_ns / 1e6

    def to_dict(self) -> dict:
        d = dict(name=self.name, t0_ns=self.t0_ns, dur_ns=self.dur_ns,
                 tid=self.tid, depth=self.depth)
        if self.req is not None:
            d["req"] = self.req
        if self.attrs:
            d["attrs"] = self.attrs
        return d

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.dur_ms:.3f} ms"
                + (f", req={self.req}" if self.req is not None else "") + ")")


class _NoopSpan:
    """The disabled-path singleton: ``with tracer.span(...):`` costs one
    attribute check and no allocation when tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NOOP = _NoopSpan()


def _profiler_range(name: str):
    """An unentered profiler range named ``name`` (torch's C++
    ``_RecordFunctionFast``, which stands among the profiler's host events
    under ``name``) while a torch profiler records; None otherwise (torch
    not imported, or no profiler on)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd.profiler._is_profiler_enabled:
        return None
    return torch._C._profiler._RecordFunctionFast(name)


class _LiveSpan:
    """Context manager for an in-flight span (enabled path only)."""

    __slots__ = ("_tracer", "name", "req", "attrs", "_t0", "_depth", "_rf")

    def __init__(self, tracer: "Tracer", name: str, req, attrs):
        self._tracer = tracer
        self.name = name
        self.req = req
        self.attrs = attrs or None

    def set(self, **attrs):
        self.attrs = dict(self.attrs or (), **attrs)
        return self

    def __enter__(self):
        stack = self._tracer._stack()
        self._depth = len(stack)
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        self._rf = _profiler_range(self.name)
        if self._rf is not None:
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self._t0
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer._commit(Span(self.name, self._t0, dur,
                                  threading.get_ident(), self._depth,
                                  self.req, self.attrs))
        return False


class Tracer:
    """Span recorder with a bounded ring of completed spans."""

    def __init__(self, capacity: int = 65536, enabled: bool = False):
        self.enabled = enabled
        self.capacity = capacity
        self.dropped = 0            # spans that fell off the ring tail
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()

    # -- recording -----------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _commit(self, s: Span) -> None:
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(s)

    def span(self, name: str, req=None, **attrs):
        """Context manager timing a block; no-op singleton when disabled."""
        if not self.enabled:
            return _NOOP
        return _LiveSpan(self, name, req, attrs)

    def mark(self, name: str):
        """Context manager for a block too frequent to keep in the ring (one
        a hop): a profiler range named ``name`` while tracing is on and a
        torch profiler records, and no span; else the shared no-op."""
        if not self.enabled:
            return _NOOP
        return _profiler_range(name) or _NOOP

    def add_span(self, name: str, t0_ns: int, t1_ns: int, req=None,
                 depth: int = 0, **attrs) -> None:
        """Record a span from timestamps the caller already took (the
        batcher's stage boundaries).  Call only when ``enabled``."""
        if not self.enabled:
            return
        self._commit(Span(name, t0_ns, max(t1_ns - t0_ns, 0),
                          threading.get_ident(), depth, req, attrs or None))

    def instant(self, name: str, req=None, **attrs) -> None:
        """Zero-duration marker (watchdog restart, breaker trip)."""
        if not self.enabled:
            return
        self._commit(Span(name, time.perf_counter_ns(), 0,
                          threading.get_ident(), 0, req, attrs or None))

    # -- lifecycle -----------------------------------------------------------
    def enable(self, capacity: int | None = None) -> "Tracer":
        if capacity is not None and capacity != self.capacity:
            with self._lock:
                self.capacity = capacity
                self._ring = deque(self._ring, maxlen=capacity)
        self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    # -- views ---------------------------------------------------------------
    def spans(self) -> list:
        """Snapshot of completed spans, oldest first."""
        with self._lock:
            return list(self._ring)

    def window(self, t0_s: float, t1_s: float) -> list:
        """Spans overlapping [t0_s, t1_s] on the perf_counter clock — the
        chaos driver uses this to attach the timeline around a fault event."""
        lo, hi = int(t0_s * 1e9), int(t1_s * 1e9)
        return [s for s in self.spans()
                if s.t0_ns <= hi and s.t1_ns >= lo]

    def request_timeline(self, req) -> list:
        """One request's spans as ordered ``{stage, start_ms, dur_ms}`` rows
        (start_ms relative to the request's first span)."""
        mine = sorted((s for s in self.spans() if s.req == req),
                      key=lambda s: s.t0_ns)
        if not mine:
            return []
        t0 = mine[0].t0_ns
        return [dict(stage=s.name, start_ms=(s.t0_ns - t0) / 1e6,
                     dur_ms=s.dur_ms, **(s.attrs or {})) for s in mine]

    # -- export --------------------------------------------------------------
    def chrome_trace(self, spans: list | None = None) -> dict:
        """Chrome-trace/Perfetto JSON (load in ``chrome://tracing``)."""
        events = []
        for s in (self.spans() if spans is None else spans):
            args = dict(s.attrs or ())
            if s.req is not None:
                args["req"] = s.req
            events.append(dict(
                ph="X", name=s.name, cat="repro_torch",
                ts=s.t0_ns / 1e3, dur=s.dur_ns / 1e3,   # microseconds
                pid=0, tid=s.tid, args=args))
        return dict(traceEvents=events, displayTimeUnit="ms")

    def write_chrome_trace(self, path) -> Path:
        path = Path(path)
        path.write_text(json.dumps(self.chrome_trace(), default=str))
        return path


# Process-wide tracer: disabled by default; `launch/serve.py --trace` (or a
# test) enables it.  Every instrumented module shares this instance.
tracer = Tracer()


def span(name: str, req=None, **attrs):
    """``with obs.span("wal.flush"):`` against the process-wide tracer."""
    return tracer.span(name, req=req, **attrs)


def enable_tracing(capacity: int | None = None) -> Tracer:
    return tracer.enable(capacity)


def disable_tracing() -> None:
    tracer.disable()
