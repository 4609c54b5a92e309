"""Unified telemetry registry: typed counters, gauges and quantile sketches.

One :class:`Registry` holds every instrument of one scope under a flat
dotted namespace (``serve.shed``, ``streaming.append_rows``, ...).  The
process-wide default registry (:func:`default_registry`) collects the
library-level counters (core search, streaming mutation, resilience); a
a serving tier owns a *private* registry per server so parallel servers (and
tests) never bleed counts into each other.  (A copy of the JAX package's
``repro.obs.registry``.)

Instruments are typed and get-or-create: ``registry.counter("serve.shed")``
returns the same :class:`Counter` on every call and raises if the name is
already registered as a different type.  All instruments are thread-safe and
**memory-bounded** — in particular :class:`Histogram` wraps a
:class:`QuantileSketch` (streaming log-bucketed quantile estimator, t-digest
style) instead of keeping raw samples, so a server can record a hundred
million requests without growing.

Two exporters ship with the registry: :meth:`Registry.snapshot` (nested JSON
dict, the machine-readable artifact) and :meth:`Registry.expose_text`
(Prometheus-style text exposition).  :class:`PeriodicExporter` is a daemon
thread that writes snapshots of one or more registries to a JSON file on an
interval (``launch/serve.py --metrics-out``).
"""
from __future__ import annotations

import json
import math
import threading
import time
from pathlib import Path

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "QuantileSketch", "Registry",
           "PeriodicExporter", "default_registry"]


class QuantileSketch:
    """Bounded-memory streaming quantile estimator (t-digest style).

    Values land in geometric buckets ``base**i`` with ``base = 2**(1/gamma)``
    (default gamma=32: ~2.2% bucket width, so quantiles are exact to ~1.1%
    relative error — far inside the 5% the perf gates care about).  The
    bucket table is a dict capped at ``max_buckets`` entries; values beyond
    the resolvable range clamp into the edge buckets, and zero/negative
    values (a degenerate latency) go to a dedicated underflow bucket.
    ``count``/``sum``/``min``/``max`` are tracked exactly, so ``mean`` and
    the extreme percentiles' anchors never drift.

    Not internally locked — :class:`Histogram` provides the lock.
    """

    __slots__ = ("gamma", "max_buckets", "_log_base", "_buckets", "count",
                 "sum", "min", "max", "_underflow")

    def __init__(self, gamma: int = 32, max_buckets: int = 4096):
        self.gamma = gamma
        self.max_buckets = max_buckets
        self._log_base = math.log(2.0) / gamma
        self._buckets: dict[int, int] = {}    # bucket index -> count
        self._underflow = 0                   # values <= 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _index(self, x: float) -> int:
        return int(math.floor(math.log(x) / self._log_base))

    def _clamp(self, i: int) -> int:
        # bound the table: indices outside the current span collapse onto the
        # nearest occupied edge once the table is full
        if len(self._buckets) < self.max_buckets or i in self._buckets:
            return i
        keys = self._buckets.keys()
        return min(max(i, min(keys)), max(keys))

    def add(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.sum += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        if x <= 0.0:
            self._underflow += 1
            return
        i = self._clamp(self._index(x))
        self._buckets[i] = self._buckets.get(i, 0) + 1

    def add_many(self, xs) -> None:
        """Vectorized bulk add (numpy bucketing; one pass, bounded memory)."""
        xs = np.asarray(xs, np.float64).ravel()
        if not len(xs):
            return
        self.count += len(xs)
        self.sum += float(xs.sum())
        self.min = min(self.min, float(xs.min()))
        self.max = max(self.max, float(xs.max()))
        pos = xs[xs > 0.0]
        self._underflow += len(xs) - len(pos)
        if not len(pos):
            return
        idx = np.floor(np.log(pos) / self._log_base).astype(np.int64)
        uniq, cnt = np.unique(idx, return_counts=True)
        for i, c in zip(uniq.tolist(), cnt.tolist()):
            i = self._clamp(i)
            self._buckets[i] = self._buckets.get(i, 0) + c

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (q in [0, 1]); NaN when empty."""
        if self.count == 0:
            return math.nan
        if q <= 0.0:
            return self.min
        if q >= 1.0:
            return self.max
        target = q * self.count
        acc = self._underflow
        if acc >= target:
            return min(0.0, self.max)
        for i in sorted(self._buckets):
            acc += self._buckets[i]
            if acc >= target:
                # bucket midpoint in log space, clamped to the exact extremes
                mid = math.exp((i + 0.5) * self._log_base)
                return min(max(mid, self.min), self.max)
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def histogram(self, n_bins: int = 40) -> dict:
        """Log-spaced ``(bins, counts)`` re-binned from the sketch buckets."""
        if not self._buckets:
            return dict(bins=[], counts=[])
        lo_i, hi_i = min(self._buckets), max(self._buckets) + 1
        edges_i = np.unique(np.linspace(lo_i, hi_i, n_bins + 1)
                            .astype(np.int64))
        counts = [0] * (len(edges_i) - 1)
        for i, c in self._buckets.items():
            j = int(np.searchsorted(edges_i, i, side="right") - 1)
            counts[min(j, len(counts) - 1)] += c
        return dict(bins=[math.exp(i * self._log_base) for i in edges_i],
                    counts=counts)

    def footprint_bytes(self) -> int:
        """Upper-bound estimate of the sketch's heap footprint (the memory-
        bound test's observable): ~48 B per dict slot plus the scalars."""
        return 64 * self.max_buckets + 128

    def to_dict(self) -> dict:
        d = dict(count=self.count, sum=self.sum)
        if self.count:
            d.update(mean=self.mean, min=self.min, max=self.max,
                     p50=self.quantile(0.50), p90=self.quantile(0.90),
                     p99=self.quantile(0.99), p999=self.quantile(0.999))
        return d


class _Instrument:
    """Shared name/help plumbing; subclasses define value semantics."""

    kind = "instrument"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()


class Counter(_Instrument):
    """Monotonic float counter."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def to_dict(self) -> dict:
        return dict(type=self.kind, value=self.value)


class Gauge(_Instrument):
    """Last-write-wins scalar (queue depth, cold-start ms, generation)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._value: float | None = None

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float | None:
        with self._lock:
            return self._value

    def to_dict(self) -> dict:
        return dict(type=self.kind, value=self.value)


class Histogram(_Instrument):
    """Locked :class:`QuantileSketch`: bounded-memory value distribution."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", gamma: int = 32,
                 max_buckets: int = 4096):
        super().__init__(name, help)
        self._sketch = QuantileSketch(gamma=gamma, max_buckets=max_buckets)

    def observe(self, x: float) -> None:
        with self._lock:
            self._sketch.add(x)

    def observe_many(self, xs) -> None:
        with self._lock:
            self._sketch.add_many(xs)

    @property
    def count(self) -> int:
        with self._lock:
            return self._sketch.count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sketch.sum

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sketch.mean

    @property
    def max(self) -> float:
        with self._lock:
            return self._sketch.max

    def quantile(self, q: float) -> float:
        with self._lock:
            return self._sketch.quantile(q)

    def percentiles(self, qs=(0.5, 0.99, 0.999)) -> tuple:
        with self._lock:
            return tuple(self._sketch.quantile(q) for q in qs)

    def histogram(self, n_bins: int = 40) -> dict:
        with self._lock:
            return self._sketch.histogram(n_bins)

    def footprint_bytes(self) -> int:
        return self._sketch.footprint_bytes()

    def to_dict(self) -> dict:
        with self._lock:
            return dict(type=self.kind, **self._sketch.to_dict())


class Registry:
    """Flat namespace of typed instruments; get-or-create, thread-safe."""

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self._instruments: dict[str, _Instrument] = {}

    def _get(self, cls, name: str, help: str, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, help, **kw)
            elif not isinstance(inst, cls):
                raise TypeError(f"{name!r} is already registered as "
                                f"{inst.kind}, not {cls.kind}")
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "", **kw) -> Histogram:
        return self._get(Histogram, name, help, **kw)

    def get(self, name: str) -> _Instrument | None:
        with self._lock:
            return self._instruments.get(name)

    def instruments(self) -> list:
        with self._lock:
            return sorted(self._instruments.values(), key=lambda i: i.name)

    def snapshot(self) -> dict:
        """name -> {type, value...} dict (the JSON exporter payload)."""
        return {i.name: i.to_dict() for i in self.instruments()}

    def expose_text(self) -> str:
        """Prometheus-style text exposition (one scrape page)."""
        lines = []
        for inst in self.instruments():
            metric = inst.name.replace(".", "_").replace("-", "_")
            if inst.help:
                lines.append(f"# HELP {metric} {inst.help}")
            lines.append(f"# TYPE {metric} {inst.kind}")
            d = inst.to_dict()
            if inst.kind == "histogram":
                lines.append(f"{metric}_count {d['count']}")
                lines.append(f"{metric}_sum {d['sum']}")
                for q in ("p50", "p90", "p99", "p999"):
                    if q in d:
                        lines.append(
                            f'{metric}{{quantile="{q[1:]}"}} {d[q]}')
            else:
                v = d["value"]
                lines.append(f"{metric} {0 if v is None else v}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()


_default = Registry("default")


def default_registry() -> Registry:
    """The process-wide registry library-level counters land in (core search,
    streaming mutation, resilience).  Serving metrics use a private registry
    per server."""
    return _default


class PeriodicExporter:
    """Daemon thread writing JSON snapshots of named registries to a file.

    The write is atomic (tmp + rename) so a scraper never reads a torn
    snapshot; ``stop()`` writes one final snapshot.
    """

    def __init__(self, registries: dict[str, Registry], path,
                 interval_s: float = 1.0):
        self.registries = dict(registries)
        self.path = Path(path)
        self.interval_s = interval_s
        self.writes = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def write_once(self) -> dict:
        snap = dict(t_unix=time.time(),
                    **{name: reg.snapshot()
                       for name, reg in self.registries.items()})
        tmp = self.path.with_suffix(self.path.suffix + ".tmp")
        tmp.write_text(json.dumps(snap, indent=1, default=str))
        tmp.replace(self.path)
        self.writes += 1
        return snap

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.write_once()

    def start(self) -> "PeriodicExporter":
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="obs-exporter")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.write_once()

    def __enter__(self) -> "PeriodicExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
