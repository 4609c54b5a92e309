"""Bounded request queue with group-aware batch extraction (the JAX
package's ``repro.serve.queue``, copied).

One FIFO holds every pending request.  The batcher calls
:meth:`take_group`, which dequeues the *oldest* request and then collects up
to ``max_n - 1`` more requests of the same program group (same ef bucket /
expand / storage) from anywhere in the queue — oldest-first service with
opportunistic coalescing, so a burst of hetero traffic never head-of-line
blocks a group behind another group's slow accumulation.

Admission at the enqueue edge is binary: beyond ``max_queue`` the put either
fails fast (``shed_on_full``) or blocks the submitter — the finer-grained
degradation decisions live in :mod:`repro_torch.serve.admission`.
"""
from __future__ import annotations

import threading
from collections import deque


class RequestQueue:
    def __init__(self, max_queue: int, shed_on_full: bool = True):
        self.max_queue = max_queue
        self.shed_on_full = shed_on_full
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def put(self, req) -> bool:
        """Enqueue; returns False when the request was shed (queue full)."""
        with self._lock:
            if self._closed:
                return False
            if len(self._q) >= self.max_queue:
                if self.shed_on_full:
                    return False
                while len(self._q) >= self.max_queue and not self._closed:
                    self._not_full.wait(0.1)
                if self._closed:
                    return False
            self._q.append(req)
            self._nonempty.notify()
            return True

    def take_group(self, group_of, max_n: int, timeout: float = 0.05,
                   linger: float = 0.0) -> list:
        """Oldest request plus up to ``max_n - 1`` group-mates.

        Waits up to ``timeout`` for a first request; with ``linger`` > 0 and a
        single-request batch it waits that long for coalescing company before
        giving up (bounded batch-formation window).
        """
        with self._lock:
            if not self._q:
                self._nonempty.wait(timeout)
            if not self._q:
                return []
            head = self._q.popleft()
            key = group_of(head)
            batch = [head]
            self._collect_locked(batch, group_of, key, max_n)
            if len(batch) == 1 and linger > 0 and max_n > 1:
                self._nonempty.wait(linger)
                self._collect_locked(batch, group_of, key, max_n)
            self._not_full.notify_all()
            return batch

    def _collect_locked(self, batch, group_of, key, max_n):
        if len(batch) >= max_n or not self._q:
            return
        keep = deque()
        while self._q and len(batch) < max_n:
            r = self._q.popleft()
            (batch if group_of(r) == key else keep).append(r)
        keep.extend(self._q)       # preserve arrival order of the rest
        self._q = keep

    def drain(self) -> list:
        """Remove and return everything pending (used at shutdown)."""
        with self._lock:
            out = list(self._q)
            self._q.clear()
            self._not_full.notify_all()
            return out

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._nonempty.notify_all()
            self._not_full.notify_all()
