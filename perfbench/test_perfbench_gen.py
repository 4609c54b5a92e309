"""The inputs made from the seed: the vector sets, the arrival schedules,
and the open-loop driver's timing from due time."""
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from perfbench.gen import arrivals, openloop
from perfbench.gen.data import make_vectors, stream_seed

SPEC = dict(name="t", n=500, dim=24, metric="l2", n_queries=20, n_train=40,
            spectrum_decay=0.9, n_clusters=8, cluster_spread=0.5,
            query_noise=0.25, base_seed=0)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_vectors_repeat_from_the_seed(metric):
    spec = dict(SPEC, metric=metric)
    a = make_vectors(spec, 2**31 + 7, "cpu")
    b = make_vectors(spec, 2**31 + 7, "cpu")
    c = make_vectors(spec, 2**31 + 8, "cpu")
    for x, y in ((a.rows, b.rows), (a.queries, b.queries), (a.train, b.train)):
        assert torch.equal(x, y)
    assert not torch.equal(a.rows, c.rows)
    assert a.rows.shape == (500, 24) and a.queries.shape == (20, 24)
    assert a.train.shape == (40, 24) and a.rows.dtype == torch.float32
    if metric == "ip":
        assert torch.allclose(a.rows.norm(dim=1), torch.ones(500), atol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_seeds_turn_one_data_set(metric):
    """Two seeds: other numbers, the same distances, so the same work."""
    spec = dict(SPEC, metric=metric)
    a, b = make_vectors(spec, 1, "cpu"), make_vectors(spec, 2, "cpu")
    assert (a.rows - b.rows).abs().max() > 0.1
    dist = lambda x, y: ((x[:, None].double() - y[None].double()) ** 2).sum(-1)
    for x, y in ((a.rows, b.rows), (a.queries, b.queries)):
        assert torch.allclose(dist(x[:100], x[:100]), dist(y[:100], y[:100]),
                              atol=1e-4)
    assert torch.allclose(a.queries @ a.rows.T, b.queries @ b.rows.T, atol=1e-4)
    other = make_vectors(dict(spec, base_seed=1), 1, "cpu")
    assert not torch.allclose(dist(a.rows[:50], a.rows[:50]),
                              dist(other.rows[:50], other.rows[:50]), atol=1e-2)


def test_spectrum_decays_as_configured():
    spec = dict(SPEC, n=20000, dim=32, n_clusters=64, cluster_spread=1.0)
    v = make_vectors(spec, 3, "cpu").rows.double()
    ev = torch.linalg.eigvalsh(torch.cov(v.T)).flip(0)
    assert ev[0] > 4 * ev[15] > 0           # steep: i^-0.9 over 32 dims


def test_stream_seeds_are_independent_and_stable():
    assert stream_seed(5, "a") == stream_seed(5, "a")
    assert stream_seed(5, "a") != stream_seed(5, "b") != stream_seed(6, "a")
    assert 0 <= stream_seed(2**33, "x") < 2**63


@pytest.mark.parametrize("kind", ["poisson", "burst"])
def test_schedule_rate_and_repeat(kind):
    t = dict(arrivals=kind, rate_per_s=200.0, burst_size=8, base_seed=0)
    due, picks = arrivals.schedule(t, 11, 30.0, 1000)
    due2, picks2 = arrivals.schedule(t, 11, 30.0, 1000)
    assert np.array_equal(due, due2) and np.array_equal(picks, picks2)
    # another seed deals the same gaps and queries in another order
    due3, picks3 = arrivals.schedule(t, 12, 30.0, 1000)
    assert not np.array_equal(due, due3) and not np.array_equal(picks, picks3)
    assert np.allclose(np.sort(np.diff(due, prepend=0)),
                       np.sort(np.diff(due3, prepend=0)), atol=1e-9)
    assert np.array_equal(np.sort(picks), np.sort(picks3))
    assert np.all(np.diff(due) >= 0) and due[-1] < 30.0
    assert abs(len(due) / 30.0 - 200.0) < 20.0
    assert picks.min() >= 0 and picks.max() < 1000
    if kind == "burst":
        assert len(np.unique(due)) * 8 == len(due)


def test_permutations_cover_the_pool_and_repeat():
    a, b = arrivals.permutations(4, 50), arrivals.permutations(4, 50)
    p1, p2 = next(a), next(a)
    assert np.array_equal(np.sort(p1), np.arange(50)) and not np.array_equal(p1, p2)
    assert np.array_equal(p1, next(b))


class FakeServer:
    """One worker thread serving requests in order, ``service_s`` each;
    request ``stall_at`` takes ``stall_s`` more."""

    def __init__(self, service_s, stall_at=None, stall_s=0.0):
        self.service_s, self.stall_at, self.stall_s = service_s, stall_at, stall_s
        self.jobs, self.n = [], 0
        self.cv = threading.Condition()
        self.stop = False
        self.thread = threading.Thread(target=self.loop, daemon=True)
        self.thread.start()

    def submit(self, query):
        fut = Future()
        with self.cv:
            self.jobs.append((self.n, fut))
            self.n += 1
            self.cv.notify()
        return fut

    def loop(self):
        while True:
            with self.cv:
                while not self.jobs and not self.stop:
                    self.cv.wait()
                if self.stop and not self.jobs:
                    return
                i, fut = self.jobs.pop(0)
            time.sleep(self.service_s + (self.stall_s if i == self.stall_at else 0))
            fut.set_result(i)

    def close(self):
        with self.cv:
            self.stop = True
            self.cv.notify()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


ANSWER = lambda i: (np.array([i]), np.array([0.0]))   # the fake's reply: its index


def _run(server, n=30, gap=0.02):
    due = np.arange(n) * gap
    rec = openloop.new_record(due, np.zeros(n, np.int64), time.perf_counter() + 0.02)
    openloop.send(rec, server.submit, np.zeros((1, 2)), answer=ANSWER)
    assert openloop.wait_all(rec, time.perf_counter() + 10) == 0
    server.close()
    return rec


def test_open_loop_times_from_due_time_and_shows_a_stall():
    steady = _run(FakeServer(0.002))
    lat = steady.latency_s
    assert np.all(lat >= 0.002) and np.max(lat) < 0.05
    assert np.all(steady.lateness_s >= 0) and np.max(steady.lateness_s) < 0.05
    stalled = _run(FakeServer(0.002, stall_at=10, stall_s=0.4))
    lat = stalled.latency_s
    # every request queued behind the stall waits for it: latency from due
    # time, not from the moment the generator finally sent it
    assert lat[10] >= 0.4
    assert np.all(lat[11:16] > 0.2)
    assert lat[15] < lat[11]              # the queue drains a gap at a time
    assert np.max(stalled.lateness_s) < 0.05    # the generator itself kept time
    assert stalled.ok.all() and list(stalled.ids[:, 0]) == list(range(30))


def test_open_loop_counts_a_late_generator():
    server = FakeServer(0.001)
    due = np.arange(10) * 0.005
    rec = openloop.new_record(due, np.zeros(10, np.int64), time.perf_counter())
    time.sleep(0.1)                       # the generator starts 0.1 s late
    openloop.send(rec, server.submit, np.zeros((1, 2)), answer=ANSWER)
    openloop.wait_all(rec, time.perf_counter() + 10)
    server.close()
    assert rec.lateness_s[0] >= 0.1 and np.all(rec.latency_s >= rec.lateness_s)
