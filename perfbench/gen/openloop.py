"""An open-loop driver: requests go out at their due times whatever the
system does, and each is timed from when it was due.

The port's ``serve/loadgen.py::run_load`` is the pattern, with two changes:
a request's latency runs from its due time (not from ``submit()``), so a
stalled generator or a slow ``submit()`` shows in the latency of every
request behind it; and every request's lateness (how long after its due
time it was sent) is recorded.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class OpenLoopRecord:
    """Arrays only: a record that kept every future and reply as Python
    objects would grow the collector's oldest generation by tens of
    thousands of objects a window, and its full collections (~0.1 s with
    torch loaded) would stall the server under test."""
    due: np.ndarray          # (n,) due times, perf_counter seconds
    picks: np.ndarray        # (n,) the query each request sends
    sent: np.ndarray         # (n,) when submit() was entered (nan: not yet)
    done: np.ndarray         # (n,) when the request resolved (nan: not yet)
    ok: np.ndarray           # (n,) resolved with an answer
    ids: np.ndarray          # (n, k) the answer's ids (-1: none)
    dists: np.ndarray        # (n, k) the answer's distances (nan: none)
    errors: list             # repr of each exception a future raised

    @property
    def lateness_s(self) -> np.ndarray:
        return self.sent - self.due

    @property
    def latency_s(self) -> np.ndarray:
        """Due time to resolution; nan for a request that never resolved."""
        return self.done - self.due


def new_record(due_s: np.ndarray, picks: np.ndarray, t0: float,
               k: int = 1) -> OpenLoopRecord:
    """The record of a schedule whose window starts at ``t0`` (perf_counter
    seconds): ``due_s`` are offsets from it; answers are ``k`` wide."""
    n = len(due_s)
    return OpenLoopRecord(due=t0 + np.asarray(due_s, np.float64),
                          picks=np.asarray(picks, np.int64),
                          sent=np.full(n, np.nan), done=np.full(n, np.nan),
                          ok=np.zeros(n, bool), ids=np.full((n, k), -1, np.int64),
                          dists=np.full((n, k), np.nan), errors=[])


def send(rec: OpenLoopRecord, submit, queries: np.ndarray, lo: int = 0,
         hi: int | None = None, *, answer, sleep_span=None,
         submit_span=None) -> None:
    """Send requests ``lo:hi`` of ``rec`` through ``submit(query) -> Future``
    at their due times, without waiting for any reply.  As each future
    resolves, ``answer(result)`` gives ``(ids, dists)``, or None for a reply
    that carries no answer (shed, timed out); the record keeps them and the
    time.  ``sleep_span`` / ``submit_span`` (context-manager factories)
    label the sleeps and the submits in a trace."""
    def resolver(i):
        def on_done(fut):
            err = fut.exception()
            if err is not None:
                rec.errors.append(repr(err))
            else:
                got = answer(fut.result())
                if got is not None:
                    rec.ids[i], rec.dists[i] = got
                    rec.ok[i] = True
            rec.done[i] = time.perf_counter()
        return on_done

    for i in range(lo, len(rec.due) if hi is None else hi):
        delay = rec.due[i] - time.perf_counter()
        if delay > 0:
            if sleep_span is None:
                time.sleep(delay)
            else:
                with sleep_span():
                    time.sleep(delay)
        rec.sent[i] = time.perf_counter()
        if submit_span is None:
            fut = submit(queries[rec.picks[i]])
        else:
            with submit_span():
                fut = submit(queries[rec.picks[i]])
        fut.add_done_callback(resolver(i))


def wait_all(rec: OpenLoopRecord, deadline: float) -> int:
    """Wait until every sent request is resolved and stamped, or until
    ``deadline`` (perf_counter seconds); returns how many are not."""
    pending = lambda: int((np.isnan(rec.done) & ~np.isnan(rec.sent)).sum())
    while pending() and time.perf_counter() < deadline:
        time.sleep(0.002)
    return pending()
