"""SLO-aware admission: latency prediction, timeout, ef degradation, and the
failure circuit breaker (the JAX package's ``repro.serve.admission``,
copied).

The controller keeps an EMA of observed service time per
``(group, batch_bucket)`` cell — seeded by the warmup timings, refined by
live traffic — and uses it at batch-formation time to decide, per batch:

  1. requests whose deadline has *already* passed are failed fast with
     ``status="timeout"`` (no device work wasted on a dead request);
  2. if the predicted service time would blow the tightest remaining budget
     in the batch, or the queue is deeper than ``degrade_depth``, the whole
     batch is downgraded to a lower ef bucket (same program family, smaller
     beam -> faster) and every response is stamped ``degraded=True``.

Degrading the whole batch — not single requests — keeps the group key
uniform so the batch still runs as one program.  ``k`` never degrades:
``k_max <= min(ef_buckets)`` guarantees any bucket can serve any k.

The controller also owns a :class:`CircuitBreaker`: when whole batches keep
failing (a wedged device, a poisoned generation — not a single poisoned
request, which bisection isolates), serving every queued request into the
failure only burns deadline budget.  After ``breaker_threshold`` consecutive
total-batch failures the breaker *opens* (requests shed fast, no device
work); after ``breaker_cooldown_s`` it goes *half-open* and lets exactly one
probe batch through — success closes it, failure re-opens.
"""
from __future__ import annotations

import threading
import time


class CircuitBreaker:
    """Consecutive-failure breaker: closed -> open -> half-open -> closed.

    Driven by the single batcher thread (``allow`` before each batch,
    ``record`` after), but locked anyway: a watchdog restart can briefly
    overlap an abandoned batcher's last ``record``.
    """

    def __init__(self, threshold: int, cooldown_s: float):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.state = "closed"             # "closed" | "open" | "half_open"
        self.failures = 0                 # consecutive whole-batch failures
        self.trips = 0
        self._open_until = 0.0
        self._lock = threading.Lock()

    def allow(self, now: float | None = None) -> bool:
        """May the next batch run?  False -> shed it without device work."""
        now = time.perf_counter() if now is None else now
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if now < self._open_until:
                    return False
                self.state = "half_open"  # cooldown over: one probe batch
                return True
            return False                  # half_open: probe already in flight

    def record(self, ok: bool, now: float | None = None) -> bool:
        """Record one batch outcome; returns True when this call tripped
        (closed/half-open -> open) so the caller can log the event."""
        now = time.perf_counter() if now is None else now
        with self._lock:
            if ok:
                self.state = "closed"
                self.failures = 0
                return False
            if self.state == "half_open":
                self.state = "open"       # probe failed: back to shedding
                self._open_until = now + self.cooldown_s
                return True
            self.failures += 1
            if self.state == "closed" and self.failures >= self.threshold:
                self.state = "open"
                self.trips += 1
                self._open_until = now + self.cooldown_s
                return True
            return False


class LatencyModel:
    """EMA of service seconds per (group, batch_bucket) program cell."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self._ema: dict = {}
        self._lock = threading.Lock()

    def observe(self, group, bucket: int, seconds: float) -> None:
        with self._lock:
            key = (group, bucket)
            prev = self._ema.get(key)
            self._ema[key] = (seconds if prev is None
                              else self.alpha * seconds
                              + (1 - self.alpha) * prev)

    def predict(self, group, bucket: int) -> float | None:
        with self._lock:
            est = self._ema.get((group, bucket))
            if est is not None:
                return est
            # unseen cell: fall back to the worst same-group estimate
            same = [v for (g, _), v in self._ema.items() if g == group]
            return max(same) if same else None


class AdmissionController:
    def __init__(self, cfg, model: LatencyModel):
        self.cfg = cfg
        self.model = model
        self.breaker = CircuitBreaker(cfg.breaker_threshold,
                                      cfg.breaker_cooldown_s)

    def plan(self, batch: list, queue_len: int):
        """Split a formed batch into (serve, timeouts) and pick its ef bucket.

        Returns ``(serve, timed_out, ef_bucket, degraded)`` where ``serve``
        keeps arrival order and ``ef_bucket`` is the bucket the batch will
        actually run at.
        """
        cfg = self.cfg
        now = time.perf_counter()
        timed_out = [r for r in batch if r.remaining_ms(now) <= 0]
        serve = [r for r in batch if r.remaining_ms(now) > 0]
        if not serve:
            return [], timed_out, None, False

        group = serve[0].group(cfg)
        ef = group[0]
        degraded = False
        if cfg.degrade:
            ef, degraded = self._maybe_degrade(serve, group, ef,
                                               queue_len, now)
        return serve, timed_out, ef, degraded

    def _maybe_degrade(self, serve, group, ef, queue_len, now):
        cfg = self.cfg
        degraded = False
        # queue pressure: over the degradation depth, drop straight to the
        # floor bucket — drain fast, recover, stop degrading
        if queue_len >= cfg.degrade_depth:
            floor = cfg.ef_buckets[0]
            return floor, floor < ef

        bucket = cfg.batch_bucket(len(serve))
        tightest = min(r.remaining_ms(now) for r in serve)
        while True:
            est = self.model.predict((ef,) + group[1:], bucket)
            if est is None or est * 1e3 <= tightest:
                return ef, degraded
            lower = cfg.lower_bucket(ef)
            if lower is None:
                return ef, degraded     # already at the floor; run anyway
            ef, degraded = lower, True
