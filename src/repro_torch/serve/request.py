"""Request/response envelope of the serving tier (the JAX package's
``repro.serve.request``, copied).

A :class:`Request` is one query vector plus its knobs and deadline; the
server resolves its future with a :class:`Response` carrying the ids/dists
slice, the snapshot generation that served it, and the full latency
breakdown.  ``status`` is one of

  ok       served (check ``deadline_missed`` for a late completion)
  timeout  deadline expired before the batcher could schedule it
  shed     rejected at submit time (queue over budget)

``degraded`` marks a request served at a lower ef bucket than requested —
the backpressure valve of the admission controller.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from concurrent.futures import Future

import numpy as np

_ids = itertools.count()
_ids_lock = threading.Lock()


def _next_id() -> int:
    with _ids_lock:
        return next(_ids)


@dataclasses.dataclass
class Request:
    query: np.ndarray                 # one raw (un-rotated) query vector
    k: int
    ef: int                           # as asked; served at cfg.ef_bucket(ef)
    expand: int
    storage: str
    deadline_ms: float                # per-request SLO budget
    t_submit: float = dataclasses.field(default_factory=time.perf_counter)
    id: int = dataclasses.field(default_factory=_next_id)
    future: Future = dataclasses.field(default_factory=Future)

    def group(self, cfg) -> tuple:
        """Requests in one group run in one program cell (one searcher)."""
        return (cfg.ef_bucket(self.ef), self.expand, self.storage)

    def elapsed_ms(self, now: float | None = None) -> float:
        return ((now or time.perf_counter()) - self.t_submit) * 1e3

    def remaining_ms(self, now: float | None = None) -> float:
        return self.deadline_ms - self.elapsed_ms(now)


@dataclasses.dataclass
class Response:
    id: int
    status: str                       # "ok" | "timeout" | "shed"
    ids: np.ndarray | None = None     # (k,)
    dists: np.ndarray | None = None   # (k,)
    generation: int | None = None     # snapshot generation that served it
    ef_served: int | None = None
    batch_bucket: int | None = None   # padded program width that served it
    degraded: bool = False            # served below the requested ef bucket
    queue_ms: float = 0.0
    service_ms: float = 0.0
    total_ms: float = 0.0
    deadline_missed: bool = False     # served, but past its deadline

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    @property
    def good(self) -> bool:
        """Counts toward goodput: served within its deadline."""
        return self.status == "ok" and not self.deadline_missed
