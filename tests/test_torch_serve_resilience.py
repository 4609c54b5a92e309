"""Self-healing serving on the port (the serving cases of
``tests/test_resilience.py`` restated) and the port's chaos driver.

A poisoned request in a batch of 32 fails exactly one future (bisection),
an injected crash is never healed, the circuit breaker trips only on
whole-batch failures, a failed generation install rolls back to the previous
serving snapshot (re-uploaded in full: the in-place splice may have
overwritten its tensors), and the watchdog replaces a dead and a stalled
batcher.  ``repro_torch.launch.chaos --check`` runs its three phases (serve
under faults, crash recovery of the WAL, corruption sweep) on the unit index
on the CPU and passes every gate.
"""
import json
import time

import numpy as np
import pytest
import torch

from repro_torch.index import Index
from repro_torch.launch import chaos
from repro_torch.resilience import FaultPlan, FaultSpec, InjectedCrash, active_plan
from repro_torch.serve import CircuitBreaker, Metrics, ServeConfig, Server
from repro_torch.serve.batcher import resolve_batch_safe
from repro_torch.serve.request import Request
from repro_torch.serve.swap import GenerationInstaller
from repro_torch.streaming import MutableIndex


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_index(unit_index, tmp_path_factory):
    path = unit_index.save(tmp_path_factory.mktemp("serve_res") / "i.naszip")
    return Index.load(path, device="cpu")


def _requests(db, n, cfg):
    return [Request(query=np.asarray(db.vectors[i], np.float32), k=5, ef=16,
                    expand=cfg.expand, storage="f32", deadline_ms=60_000.0)
            for i in range(n)]


def test_submit_validates_query(port_index):
    srv = Server(port_index, ServeConfig(ef_buckets=(16, 32), k_max=8))
    dim = port_index.dim
    with pytest.raises(ValueError, match="dim"):
        srv.submit(np.zeros(dim + 1, np.float32))
    with pytest.raises(ValueError, match="NaN"):
        srv.submit(np.full(dim, np.nan, np.float32))
    with pytest.raises(ValueError, match="NaN"):
        srv.submit(np.r_[np.zeros(dim - 1, np.float32), np.inf])
    with pytest.raises(ValueError, match="float vector"):
        srv.submit(["not", "a", "vector"])
    f = srv.submit(np.zeros(dim, np.float32))  # valid, server not started
    assert f.result(timeout=10).status == "shed"


def test_bisection_isolates_one_poisoned_request(unit_db, port_index):
    cfg = ServeConfig(ef_buckets=(16, 32), batch_buckets=(1, 4, 8, 32), k_max=8)
    serve = _requests(unit_db, 32, cfg)
    metrics = Metrics(slo_ms=60_000.0)
    plan = FaultPlan({"serve.batch_exec": FaultSpec("poison", at=(0,))},
                     seed=11)
    with active_plan(plan):
        n_ok, n_failed = resolve_batch_safe(port_index, cfg, serve, 16,
                                            False, metrics=metrics)
    assert (n_ok, n_failed) == (31, 1)         # the acceptance bound: 1 of 32
    excs = [r.future.exception(timeout=10) for r in serve]
    assert sum(e is not None for e in excs) == 1
    (bad,) = [r for r, e in zip(serve, excs) if e is not None]
    assert str(bad.id) in str(bad.future.exception(timeout=10))
    ok = [r.future.result(timeout=10) for r, e in zip(serve, excs) if e is None]
    assert all(r.status == "ok" for r in ok)
    assert metrics.summary()["errors"] == 1
    # the poison was consumed at the batch-of-one: a clean retry succeeds
    with active_plan(plan):
        n_ok, n_failed = resolve_batch_safe(port_index, cfg,
                                            _requests(unit_db, 1, cfg), 16, False)
    assert (n_ok, n_failed) == (1, 0)


def test_injected_crash_is_never_healed(unit_db, port_index):
    cfg = ServeConfig(ef_buckets=(16, 32), batch_buckets=(1, 4), k_max=8)
    serve = _requests(unit_db, 4, cfg)
    with active_plan(FaultPlan({"serve.batch_exec":
                                FaultSpec("crash", at=(0,))})):
        with pytest.raises(InjectedCrash):     # propagates, no bisection
            resolve_batch_safe(port_index, cfg, serve, 16, False)


def test_circuit_breaker_state_machine():
    b = CircuitBreaker(threshold=3, cooldown_s=10.0)
    t = 1000.0
    assert b.allow(t)
    assert not b.record(False, t) and not b.record(False, t)
    assert b.record(True, t) is False and b.failures == 0   # success resets
    for _ in range(2):
        assert b.record(False, t) is False
    assert b.record(False, t) is True          # third consecutive: trips
    assert b.state == "open" and b.trips == 1
    assert not b.allow(t + 9.9)                # still cooling down
    assert b.allow(t + 10.1)                   # half-open: one probe
    assert b.state == "half_open" and not b.allow(t + 10.2)
    assert b.record(False, t + 10.3) is True   # probe failed: re-open
    assert not b.allow(t + 10.4)
    assert b.allow(t + 20.4)                   # next probe
    b.record(True, t + 20.5)
    assert b.state == "closed" and b.allow(t + 20.6)


def test_metrics_errors_and_events():
    m = Metrics(slo_ms=50.0)
    m.record_error(RuntimeError("x"))
    m.record_event("breaker_trip")
    m.record_event("breaker_shed", 7)
    s = m.summary()
    assert s["errors"] == 1
    assert s["errors_by_type"] == {"RuntimeError": 1}
    assert s["events"] == {"breaker_trip": 1, "breaker_shed": 7}
    assert "events" not in Metrics(slo_ms=50.0).summary()   # only when any


def test_swap_install_failure_rolls_back(unit_db, port_index):
    """A failed install leaves the previous generation serving, re-uploaded
    in full, with its own results; a retry lands."""
    cfg = ServeConfig(ef_buckets=(16, 32), k_max=8)
    mi = MutableIndex(port_index, reserve=0.5)
    inst = GenerationInstaller(cfg)
    s0 = mi.freeze()
    assert inst.install(s0) is not None and inst.serving is s0
    q = unit_db.queries[:4]
    want = s0.search(q, ef=32, k=8)

    mi.append(np.zeros((4, port_index.dim), np.float32))
    s1 = mi.freeze()
    with active_plan(FaultPlan({"serve.swap.install":
                                FaultSpec("raise", at=(0,))})):
        assert inst.install(s1) is None        # failed install: rolled back
    assert inst.serving is s0 and inst.rollbacks == 1
    cache = inst.caches["f32"]
    assert cache._prev is s0 and s0._device[("adj", "cpu")] is cache._adj
    got = s0.search(q, ef=32, k=8)
    assert np.array_equal(got.ids, want.ids)
    assert np.array_equal(got.dists, want.dists)

    stats = inst.install(s1)                   # retry without faults: lands
    assert stats is not None and inst.serving is s1


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_watchdog_restarts_dead_and_stalled_batcher(unit_db, port_index):
    # the injected serve.loop crash kills that batcher thread by design;
    # the watchdog restarting it is exactly what this test asserts
    cfg = ServeConfig(ef_buckets=(16,), batch_buckets=(1, 4), k_max=8,
                      watchdog_poll_s=0.05, watchdog_stall_s=0.3)
    q = np.asarray(unit_db.vectors[0], np.float32)
    srv = Server(port_index, cfg).start()
    try:
        assert srv.submit(q, deadline_ms=10_000).result(timeout=30).status == "ok"
        e0 = srv._epoch
        with active_plan(FaultPlan({"serve.loop": FaultSpec("crash", at=(1,))})):
            t_end = time.monotonic() + 5
            while srv._epoch == e0 and time.monotonic() < t_end:
                time.sleep(0.05)
        assert srv._epoch > e0                 # dead batcher respawned
        assert srv.submit(q, deadline_ms=10_000).result(timeout=30).status == "ok"
        e1 = srv._epoch
        with active_plan(FaultPlan({"serve.batch_exec":
                                    FaultSpec("delay", at=(0,), delay_s=1.0)})):
            f = srv.submit(q, deadline_ms=10_000)
            t_end = time.monotonic() + 5
            while srv._epoch == e1 and time.monotonic() < t_end:
                time.sleep(0.05)
            assert f.result(timeout=30).status == "ok"   # the wedged batch
        assert srv._epoch > e1                 # ...resolves; thread replaced
        ev = srv.metrics.summary()["events"]
    finally:
        srv.stop()
    assert ev.get("watchdog_restart_dead", 0) >= 1
    assert ev.get("watchdog_restart_stalled", 0) >= 1


def test_chaos_check_passes_on_the_unit_index(tmp_path, capsys):
    rc = chaos.main(["--device", "cpu", "--check", "--duration", "4",
                     "--workdir", str(tmp_path / "work"),
                     "--report", str(tmp_path / "chaos.json"),
                     "--events", str(tmp_path / "events.json")])
    out = capsys.readouterr().out
    assert rc == 0, out
    report = json.loads((tmp_path / "chaos.json").read_text())
    assert set(report) >= {"serve", "crash_recovery", "corruption"}
    assert report["serve"]["unresolved"] == 0
    assert report["corruption"]["detected"] == report["corruption"]["attempted"] == 5
    events = json.loads((tmp_path / "events.json").read_text())
    assert {e["point"] for e in events} >= {"serve.batch_exec", "serve.loop",
                                            "serve.swap.install"}
