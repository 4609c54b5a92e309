"""The spans inside the port's search call (``repro_torch.obs.tracer``): their
nesting, the per-hop marks (profiler ranges, no spans) against the beam
loop's own count, results unchanged by tracing, nothing recorded with
tracing off, the ``torch.profiler`` ranges that mirror the spans, and the
serving batch's number carried into each request's ``device_exec`` span.
CPU, on the port's own unit index.
"""
import gc
from collections import Counter

import numpy as np
import pytest
import torch

from perfbench.yard.launches import is_launch
from repro_torch import obs
from repro_torch.core import search as search_mod
from repro_torch.data.synthetic import make_dataset
from repro_torch.index import Index, IndexSpec, SearchParams
from repro_torch.obs import trace as trace_mod
from repro_torch.serve import ServeConfig, Server

CALL_PARTS = ("search.transform", "search.descend", "search.beam",
              "search.readback")
COUNTERS = ("search.queries", "search.hops", "search.lanes_evaluated",
            "search.dims_touched", "search.dims_possible")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def unit():
    db = make_dataset("unit", device="cpu")
    idx = Index.build(db, IndexSpec.for_db(db, m=8, dfloat_recall_target=None),
                      device="cpu")
    return db, idx


@pytest.fixture()
def traced():
    obs.enable_tracing(capacity=1 << 16)
    obs.tracer.clear()
    yield obs.tracer
    obs.disable_tracing()
    obs.tracer.clear()


def _search(unit, storage="f32", trace=False, n=40):
    db, idx = unit
    run = idx.searcher("local", SearchParams(ef=32, k=10, storage=storage,
                                             trace=trace), device="cpu")
    return run(db.queries[:n])


def test_one_call_nests_its_parts(unit, traced):
    _search(unit)
    spans = traced.spans()
    calls = [s for s in spans if s.name == "search.call"]
    assert len(calls) == 1
    call = calls[0]
    assert call.depth == 0 and call.req is None
    assert call.attrs == {"q": 40, "storage": "f32", "ef": 32}
    parts = sorted((s for s in spans if s.depth == call.depth + 1),
                   key=lambda s: s.t0_ns)
    assert [s.name for s in parts] == list(CALL_PARTS)
    for a, b in zip(parts, parts[1:]):
        assert a.t1_ns <= b.t0_ns
    assert all(call.t0_ns <= s.t0_ns and s.t1_ns <= call.t1_ns for s in spans)
    assert all(s.req is None for s in spans)
    descend = parts[1]
    assert descend.attrs["levels"] == len(unit[1].graph.levels) - 1
    assert descend.attrs["steps"] >= descend.attrs["levels"]


HOP_MARKS = ("search.hop", "search.sync")


def _host_ranges(run):
    """``run()`` under a CPU profiler: its host events named ``search.*``
    as (name, start ns, end ns), sorted by start."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # a process's first range pays the profiler's one-time set-up
        with torch.profiler.record_function("warm"):
            pass
        out = run()
    evs = prof.profiler.kineto_results.events()
    host = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in evs if e.name().startswith("search.")),
                  key=lambda r: r[1])
    return host, out


def test_beam_hops_match_the_loop(unit, traced, monkeypatch):
    n_body = []
    body = search_mod._hop_body

    def counted(*a, **k):
        n_body.append(1)
        return body(*a, **k)

    monkeypatch.setattr(search_mod, "_hop_body", counted)
    host, res = _host_ranges(lambda: _search(unit))
    beam = next(s for s in traced.spans() if s.name == "search.beam")
    n_words = -(-unit[1].n // 32)
    assert beam.attrs == {"q": 40, "hops": len(n_body), "graph_hops": 0,
                          "frontier_hops": 0, "visited_bytes": 4 * n_words * 40}
    names = Counter(n for n, _, _ in host)
    assert names["search.hop"] == len(n_body) == int(res.hops.max())
    assert names["search.sync"] == len(n_body) + 1
    # the marks lie inside the beam's range and keep no span in the ring
    _, b0, b1 = next(r for r in host if r[0] == "search.beam")
    assert all(b0 <= s and e <= b1 for n, s, e in host if n in HOP_MARKS)
    assert not any(s.name in HOP_MARKS for s in traced.spans())


def test_fixed_length_trace_has_hops_and_no_sync(unit, traced):
    host, _ = _host_ranges(lambda: _search(unit, trace=True))
    names = Counter(n for n, _, _ in host)
    beam = next(s for s in traced.spans() if s.name == "search.beam")
    assert names["search.sync"] == 0
    idx = unit[1]
    assert names["search.hop"] == beam.attrs["hops"] == SearchParams(
        ef=32, k=10).to_config(idx.metric, idx.seg).hops()


@pytest.mark.parametrize("storage", ["f32", "packed"])
def test_results_equal_with_tracing_on_and_off(unit, storage):
    reg = obs.default_registry()
    outs = []
    for on in (False, True):
        if on:
            obs.enable_tracing()
        try:
            before = {k: reg.counter(k).value for k in COUNTERS}
            res = _search(unit, storage=storage)
            delta = {k: reg.counter(k).value - before[k] for k in COUNTERS}
        finally:
            obs.disable_tracing()
            obs.tracer.clear()
        outs.append((res, delta))
    (a, da), (b, db_) = outs
    assert np.array_equal(a.ids, b.ids)
    assert np.array_equal(a.dists.view(np.int32), b.dists.view(np.int32))
    assert da == db_ and da["search.queries"] == 40


def test_tracing_off_records_nothing(unit):
    obs.disable_tracing()
    obs.tracer.clear()
    host, _ = _host_ranges(lambda: _search(unit))
    assert obs.tracer.spans() == [] and host == []
    assert obs.tracer.mark("search.hop") is obs.tracer.span("search.sync")


def _mirrored(unit, tracer):
    """One search under a CPU profiler: the host ranges of the tracer's
    spans (the per-hop marks left out) and the spans, each as sorted
    (start ns, name)."""
    tracer.clear()
    host, _ = _host_ranges(lambda: _search(unit))
    host = [(s, n) for n, s, _ in host if n not in HOP_MARKS]
    return host, sorted((s.t0_ns, s.name) for s in tracer.spans())


def test_profiler_ranges_mirror_the_spans(unit, traced):
    # the host is shared with other test processes: a try descheduled
    # between a span's two stamps is tried again, and the collector, which
    # would pause between them too, is off while it runs
    worst = []
    gc.disable()
    try:
        for _ in range(3):
            host, mine = _mirrored(unit, traced)
            assert [n for _, n in host] == [n for _, n in mine]
            assert len(host) > 4
            assert not any(is_launch(n) for _, n in host)
            diff = np.array([h - m for (h, _), (m, _) in zip(host, mine)], np.int64)
            worst.append(int(np.abs(diff - int(np.median(diff))).max()))
            if worst[-1] < 200_000:
                break
    finally:
        gc.enable()
    assert min(worst) < 200_000, worst


def test_a_range_opens_only_under_a_profiler(traced):
    from torch.profiler import ProfilerActivity, profile

    assert trace_mod._profiler_range("search.hop") is None
    assert traced.mark("search.hop") is trace_mod._NOOP
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with traced.mark("search.hop"):
            pass
        with traced.span("search.call"):
            pass
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("search.hop") == 1 and names.count("search.call") == 1
    assert [s.name for s in traced.spans()] == ["search.call"]
    assert trace_mod._profiler_range("search.hop") is None
    assert traced.mark("search.hop") is trace_mod._NOOP


def test_serving_batches_carry_their_number(unit, traced):
    db, idx = unit
    cfg = ServeConfig(ef_buckets=(32,), batch_buckets=(1, 4, 8), k_max=10,
                      slo_ms=5000.0)
    srv = Server(idx, cfg).start()
    traced.clear()
    try:
        futs = [srv.submit(db.queries[i], k=10, ef=32, deadline_ms=5000.0)
                for i in range(24)]
        resps = [f.result(timeout=60) for f in futs]
    finally:
        srv.stop()
    assert all(r.status == "ok" for r in resps)
    spans = traced.spans()
    batches = {s.attrs["batch"]: s for s in spans if s.name == "serve.batch"}
    execs = [s for s in spans if s.name == "device_exec"]
    assert len(execs) == 24
    per_batch = Counter(s.attrs["batch"] for s in execs)
    assert set(per_batch) == set(batches)
    for s in execs:
        b = batches[s.attrs["batch"]]
        assert s.t0_ns <= b.t0_ns and b.t1_ns <= s.t1_ns
        assert b.attrs["n"] == per_batch[s.attrs["batch"]]
        assert b.attrs["bucket"] >= b.attrs["n"]
    calls = [s for s in spans if s.name == "search.call"]
    assert len(calls) == len(batches)
    depth = {b.depth for b in batches.values()}
    assert len(depth) == 1 and {c.depth for c in calls} == {depth.pop() + 1}
    assert all(s.req is None for s in spans if s.name.startswith("search."))
