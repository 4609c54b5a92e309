"""The port's telemetry (``repro_torch.obs``) vs the JAX package's.

``repro_torch.obs`` is a copy of ``repro.obs``; the registry, sketch and
tracer cases of ``tests/test_obs.py`` are restated on it.  Where a
reference case drives a module the port has not ported yet, the case drives
the same instruments through what the port has: the serving tier's
``Metrics`` façade (ROADMAP queue A, item 8) becomes a private registry with
the façade's instruments, and its FEE exit fraction comes from the port
searcher's ``search.*`` counters.  The reference's regression-gate cases
test ``benchmarks/check_regression.py``, a script of the JAX side, and are
not restated.  The port's and the reference's local searchers, on one
index carried across, leave equal ``search.*`` counters.
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

import repro.index as jix
from repro import obs as jobs
from repro_torch import obs
from repro_torch.index import Index, SearchParams
from repro_torch.obs import PeriodicExporter, QuantileSketch, Registry, Tracer

SEARCH_COUNTERS = ("search.queries", "search.hops", "search.lanes_evaluated",
                   "search.dims_touched", "search.dims_possible",
                   "search.residual_fetches")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work here is many small operations: run them on one
    thread, so that they neither wait on a pool nor crowd the other test
    processes (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def carried(unit_db, unit_index, tmp_path_factory):
    path = unit_index.save(tmp_path_factory.mktemp("base") / "i.naszip")
    return unit_db, unit_index, Index.load(path, device="cpu")


# ---------------------------------------------------------------------------
# quantile sketch
# ---------------------------------------------------------------------------
def test_sketch_quantile_accuracy():
    rng = np.random.default_rng(0)
    vals = rng.lognormal(1.0, 1.0, 200_000)
    s = QuantileSketch()
    s.add_many(vals)
    for q in (0.5, 0.9, 0.99, 0.999):
        est, true = s.quantile(q), float(np.quantile(vals, q))
        assert abs(est - true) / true < 0.05, (q, est, true)
    assert s.count == len(vals)
    assert s.min == pytest.approx(vals.min())
    assert s.max == pytest.approx(vals.max())
    # the copy estimates what the reference estimates
    js = jobs.QuantileSketch()
    js.add_many(vals)
    assert [s.quantile(q) for q in (0.5, 0.99)] == [js.quantile(q)
                                                    for q in (0.5, 0.99)]


def test_sketch_memory_is_bounded():
    s = QuantileSketch(max_buckets=128)
    rng = np.random.default_rng(1)
    s.add_many(rng.lognormal(0.0, 4.0, 500_000))   # huge dynamic range
    assert len(s._buckets) <= 128
    assert s.count == 500_000
    qs = [s.quantile(q) for q in (0.01, 0.5, 0.99)]
    assert qs == sorted(qs)
    assert s.min <= qs[0] and qs[-1] <= s.max


def test_sketch_histogram_rebin():
    s = QuantileSketch()
    s.add_many(np.linspace(0.1, 100.0, 10_000))
    h = s.histogram(20)
    assert len(h["counts"]) == len(h["bins"]) - 1 == 20
    assert sum(h["counts"]) == 10_000


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
def test_registry_typed_instruments():
    r = Registry("t")
    c = r.counter("serve.shed", "sheds")
    c.inc()
    c.inc(3)
    assert c.value == 4
    with pytest.raises(ValueError):
        c.inc(-1)                       # counters are monotonic
    with pytest.raises(TypeError):
        r.gauge("serve.shed")           # kind mismatch on an existing name
    assert r.counter("serve.shed") is c  # get-or-create returns the same one
    g = r.gauge("queue.depth")
    g.set(7)
    assert g.value == 7
    h = r.histogram("lat_ms")
    h.observe_many([1.0, 2.0, 3.0, 4.0])
    assert h.count == 4 and h.mean == pytest.approx(2.5)

    snap = r.snapshot()
    assert snap["serve.shed"]["value"] == 4
    assert snap["lat_ms"]["count"] == 4
    text = r.expose_text()
    assert "serve_shed 4" in text
    assert "lat_ms_count 4" in text and 'quantile="99"' in text


def test_periodic_exporter_atomic_snapshot(tmp_path):
    r = Registry("x")
    r.counter("a").inc(5)
    path = tmp_path / "metrics.json"
    with PeriodicExporter({"x": r}, path, interval_s=0.05) as ex:
        time.sleep(0.2)
        r.counter("a").inc(5)
    snap = json.loads(path.read_text())
    assert snap["x"]["a"]["value"] == 10
    assert ex.writes >= 2
    assert not path.with_suffix(".json.tmp").exists()


# ---------------------------------------------------------------------------
# the serving façade's instruments, on a private registry
# ---------------------------------------------------------------------------
def _serving_registry(n_ok=100):
    """What the reference's ``Metrics`` records, kept in a private registry:
    status counters, a latency histogram and per-stage histograms."""
    r = Registry("serve")
    for i in range(n_ok):
        total = 5.0 + i * 0.1
        r.counter("requests").inc()
        r.counter("ok").inc()
        r.histogram("latency_ms").observe(total)
        for st, share in (("queue", 0.2), ("exec", 0.7), ("resolve", 0.1)):
            r.histogram(f"stage.{st}_ms").observe(total * share)
    for status in ("shed", "timeout"):
        r.counter("requests").inc()
        r.counter(status).inc()
    return r


def test_metrics_summary_keys_and_stages():
    r = _serving_registry()
    other = _serving_registry(3)              # a second server: no bleed
    snap = r.snapshot()
    assert snap["requests"]["value"] == 102 and snap["ok"]["value"] == 100
    assert snap["shed"]["value"] == 1 and snap["timeout"]["value"] == 1
    assert other.snapshot()["ok"]["value"] == 3
    for st in ("queue", "exec", "resolve"):
        h = snap[f"stage.{st}_ms"]
        assert h["p50"] >= 0 and h["p99"] >= h["p50"] * 0.9
    for key in ("count", "sum", "mean", "min", "max", "p50", "p90", "p99",
                "p999"):
        assert key in snap["latency_ms"], key
    h = r.histogram("latency_ms").histogram(16)
    assert sum(h["counts"]) == 100 and len(h["bins"]) == 17


def test_metrics_errors_by_type():
    r = Registry("serve")
    for e in (ValueError("bad query"), ValueError("again"),
              RuntimeError("backend down"), None):
        r.counter("errors").inc()
        r.counter(f"errors.{type(e).__name__ if e else 'unknown'}").inc()
    snap = r.snapshot()
    assert snap["errors"]["value"] == 4
    assert {k: v["value"] for k, v in snap.items() if k.startswith("errors.")} \
        == {"errors.ValueError": 2, "errors.RuntimeError": 1,
            "errors.unknown": 1}


def test_metrics_fee_exit_fraction(carried):
    """The FEE exit fraction from the port searcher's counters."""
    db, _, port = carried
    reg = obs.default_registry()
    before = {k: reg.counter(k).value for k in SEARCH_COUNTERS}
    res = port.search(db.queries[:32], SearchParams(ef=32, k=10))
    d = {k: reg.counter(k).value - before[k] for k in SEARCH_COUNTERS}
    frac = 1 - d["search.dims_touched"] / d["search.dims_possible"]
    want = 1 - res.dims.sum() / (res.n_eval.sum() * port.dim)
    assert frac == pytest.approx(want) and 0.0 < frac < 1.0


def test_metrics_memory_bounded_at_1m_records():
    r = Registry("serve")
    hists = [r.histogram(n) for n in ("latency_ms", "stage.queue_ms",
                                      "stage.exec_ms", "stage.resolve_ms")]
    bound = sum(h.footprint_bytes() for h in hists)
    assert bound < 2 << 20                      # the bound itself is small
    lat = np.random.default_rng(2).lognormal(1.5, 0.7, 1_000_000)
    for h, share in zip(hists, (1.0, 0.2, 0.7, 0.1)):
        h.observe_many(lat * share)
    for _ in range(1000):
        hists[0].observe(5.0)                   # the scalar path too
    assert sum(h.footprint_bytes() for h in hists) == bound
    assert all(len(h._sketch._buckets) <= h._sketch.max_buckets for h in hists)
    assert hists[0].count == 1_001_000
    assert hists[0].quantile(0.99) > 0


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------
def test_spans_nest_and_order():
    tr = Tracer(enabled=True)
    with tr.span("outer", req=7):
        with tr.span("inner", req=7):
            time.sleep(0.001)
    spans = tr.spans()
    assert [s.name for s in spans] == ["inner", "outer"]   # completion order
    inner, outer = spans
    assert inner.depth == 1 and outer.depth == 0
    assert outer.t0_ns <= inner.t0_ns
    assert inner.t1_ns <= outer.t1_ns + 1000
    tl = tr.request_timeline(7)
    assert [row["stage"] for row in tl] == ["outer", "inner"]  # start order


def test_spans_across_threads_do_not_interleave_depth():
    tr = Tracer(enabled=True)

    def work(tid):
        with tr.span("outer", req=tid):
            with tr.span("inner", req=tid):
                time.sleep(0.002)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans = tr.spans()
    assert len(spans) == 16
    for tid in range(8):
        mine = [s for s in spans if s.req == tid]
        assert {s.name: s.depth for s in mine} == {"outer": 0, "inner": 1}
        inner = next(s for s in mine if s.name == "inner")
        outer = next(s for s in mine if s.name == "outer")
        assert outer.t0_ns <= inner.t0_ns and inner.t1_ns <= outer.t1_ns + 1000


def test_disabled_tracer_is_allocation_free_singleton():
    tr = Tracer(enabled=False)
    a = tr.span("x", req=1, attr="v")
    b = tr.span("y")
    assert a is b                                # one shared no-op object
    with a:
        pass
    assert tr.spans() == []
    tr.instant("z")
    tr.add_span("w", 0, 10)
    assert tr.spans() == []


def test_disabled_hot_path_cost_is_negligible():
    tr = Tracer(enabled=False)
    n = 50_000

    def bare():
        pass

    t0 = time.perf_counter()
    for _ in range(n):
        bare()
    t_bare = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        tr.span("x")
    t_span = time.perf_counter() - t0
    assert t_span < max(t_bare * 10, 0.05), (t_span, t_bare)


def test_ring_wraps_without_corrupting_inflight_spans():
    tr = Tracer(capacity=16, enabled=True)
    with tr.span("inflight", req=99) as live:
        for i in range(64):
            with tr.span(f"s{i}"):
                pass
        assert tr.dropped == 64 - 16 + 0        # oldest fell off
        assert live.name == "inflight"          # untouched by the wrap
    spans = tr.spans()
    assert len(spans) == 16
    assert spans[-1].name == "inflight"         # committed after the wrap
    assert spans[-1].req == 99
    assert all(s.dur_ns >= 0 for s in spans)


def test_ring_capacity_resize_and_clear():
    tr = Tracer(capacity=8, enabled=True)
    for i in range(12):
        tr.instant(f"e{i}")
    assert len(tr.spans()) == 8
    tr.enable(capacity=32)
    assert len(tr.spans()) == 8                 # survivors kept on resize
    tr.clear()
    assert tr.spans() == [] and tr.dropped == 0


def test_chrome_trace_export(tmp_path):
    tr = Tracer(enabled=True)
    with tr.span("stage", req=3, ef=32):
        pass
    path = tr.write_chrome_trace(tmp_path / "trace.json")
    doc = json.loads(path.read_text())
    (ev,) = doc["traceEvents"]
    assert ev["ph"] == "X" and ev["name"] == "stage"
    assert ev["args"] == {"ef": 32, "req": 3}
    assert ev["dur"] >= 0 and ev["pid"] == 0


def test_window_view():
    tr = Tracer(enabled=True)
    t0 = time.perf_counter()
    tr.instant("a")
    time.sleep(0.02)
    tr.instant("b")
    t_mid = time.perf_counter()
    assert {s.name for s in tr.window(t0, t_mid)} == {"a", "b"}
    assert tr.window(t_mid + 10.0, t_mid + 11.0) == []


# ---------------------------------------------------------------------------
# library-level counters land in the default registry
# ---------------------------------------------------------------------------
def test_fault_fires_counted_in_default_registry():
    from repro_torch.resilience import (FaultPlan, FaultSpec, InjectedFault,
                                        active_plan, fault_point)

    counter = obs.default_registry().counter("resilience.faults.raise")
    before = counter.value
    plan = FaultPlan({"test.point": FaultSpec("raise", at=(0,))})
    with active_plan(plan):
        with pytest.raises(InjectedFault):
            fault_point("test.point")
    assert counter.value == before + 1


@pytest.mark.parametrize("storage", ["f32", "packed"])
def test_search_counters_match_jax(carried, storage):
    """One batch through each package's local searcher moves each package's
    ``search.*`` counters by the same amounts."""
    db, ref, port = carried
    params = SearchParams(ef=32, k=10, storage=storage)
    jparams = jix.SearchParams(ef=32, k=10, storage=storage)
    deltas = []
    for reg, run in ((obs.default_registry(), port.searcher("local", params)),
                     (jobs.default_registry(), ref.searcher("local", jparams))):
        before = {k: reg.counter(k).value for k in SEARCH_COUNTERS}
        run(db.queries[:64])
        deltas.append({k: reg.counter(k).value - before[k]
                       for k in SEARCH_COUNTERS})
    assert deltas[0] == deltas[1]
    assert deltas[0]["search.queries"] == 64
