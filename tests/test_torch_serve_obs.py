"""Serving-path observability on the port (``tests/test_serve_obs.py``
restated), and the serving CLI against the JAX package's.

A live server under tracing produces, for every request, a complete ordered
stage timeline whose durations sum to the reported ``total_ms`` (5%
tolerance; exact by construction, because ``total_ms`` is stamped at the end
of the traced resolve stage).  Also: serve counters in the per-server
registry, search counters in the process-wide one, hot-swap install spans,
and a dark hot path with tracing off.  ``repro_torch.launch.serve`` on the
unit index writes a report with the JAX package's keys.
"""
import json
import time

import numpy as np
import pytest
import torch

from repro.launch import serve as jserve_cli
from repro_torch import obs
from repro_torch.index import Index
from repro_torch.launch import serve as serve_cli
from repro_torch.serve import ServeConfig, Server
from repro_torch.streaming import MutableIndex

K = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_index(unit_index, tmp_path_factory):
    path = unit_index.save(tmp_path_factory.mktemp("serve_obs") / "i.naszip")
    return Index.load(path, device="cpu")


@pytest.fixture()
def traced():
    """Fresh process-wide tracer state around each test (the tracer is a
    module global shared with launch/serve.py)."""
    obs.enable_tracing(capacity=65536)
    obs.tracer.clear()
    yield obs.tracer
    obs.disable_tracing()
    obs.tracer.clear()


def test_request_timeline_sums_to_total_ms(unit_db, port_index, traced):
    cfg = ServeConfig(ef_buckets=(16, 32), batch_buckets=(1, 4, 8), k_max=K,
                      slo_ms=5000.0)
    srv = Server(port_index, cfg).start()
    try:
        futs = [srv.submit(unit_db.queries[i % len(unit_db.queries)],
                           k=K, ef=16 if i % 2 else 32, deadline_ms=5000.0)
                for i in range(40)]
        resps = [f.result(timeout=60) for f in futs]
        summary = srv.metrics.summary()
        snap = srv.metrics.registry.snapshot()
    finally:
        srv.stop()

    assert all(r.status == "ok" for r in resps)
    for r in resps:
        tl = traced.request_timeline(r.id)
        stages = [row["stage"] for row in tl if row["stage"] in obs.SERVE_STAGES]
        # complete, ordered lifecycle: queue_wait ... resolve
        assert stages == list(obs.SERVE_STAGES), (r.id, stages)
        stage_sum_ms = sum(row["dur_ms"] for row in tl
                           if row["stage"] in obs.SERVE_STAGES)
        assert stage_sum_ms == pytest.approx(r.total_ms, rel=0.05), \
            (r.id, stage_sum_ms, r.total_ms)

    assert set(summary["stages"]) == {"queue", "exec", "resolve"}
    assert snap["serve.requests"]["value"] == 40
    assert snap["serve.latency_ms"]["count"] == 40
    assert obs.default_registry().counter("search.queries").value > 0
    assert obs.default_registry().counter("search.hops").value > 0


def test_stage_spans_share_batch_boundaries(unit_db, port_index, traced):
    """Requests co-batched into one device execution share the same traced
    device_exec window."""
    cfg = ServeConfig(ef_buckets=(32,), batch_buckets=(8,), k_max=K,
                      slo_ms=5000.0)
    srv = Server(port_index, cfg).start()
    try:
        futs = [srv.submit(unit_db.queries[i], k=K, ef=32, deadline_ms=5000.0)
                for i in range(8)]
        [f.result(timeout=60) for f in futs]
    finally:
        srv.stop()
    execs = [s for s in traced.spans() if s.name == "device_exec"]
    assert execs
    by_window = {}
    for s in execs:
        by_window.setdefault((s.t0_ns, s.dur_ns), []).append(s.req)
    assert len(by_window) < len(execs)
    assert any(len(reqs) > 1 for reqs in by_window.values())


def test_swap_install_span_and_counters(unit_db, port_index, traced):
    cfg = ServeConfig(ef_buckets=(32,), batch_buckets=(1, 4), k_max=K,
                      slo_ms=5000.0, swap_poll_s=0.05)
    mi = MutableIndex(port_index, ef_build=32, sub_batch=64)
    rng = np.random.default_rng(0)
    srv = Server(mi, cfg).start()
    try:
        f = srv.submit(unit_db.queries[0], k=K, ef=32, deadline_ms=5000.0)
        assert f.result(timeout=60).status == "ok"
        gen = srv.generation
        mi.append(rng.standard_normal((4, unit_db.dim)).astype(np.float32))
        t_end = time.monotonic() + 30
        while srv.generation == gen and time.monotonic() < t_end:
            time.sleep(0.01)
        snap = srv.metrics.registry.snapshot()
    finally:
        srv.stop()
    installs = [s for s in traced.spans() if s.name == "swap.install"]
    assert len(installs) >= 2, "no swap.install span after an append"
    assert all(s.attrs and "generation" in s.attrs for s in installs)
    assert snap["serve.swap.installs"]["value"] >= 2
    assert snap["serve.swap.delta_installs"]["value"] >= 1


def test_disabled_tracing_serves_identically(unit_db, port_index):
    obs.disable_tracing()
    obs.tracer.clear()
    cfg = ServeConfig(ef_buckets=(32,), batch_buckets=(1, 4), k_max=K,
                      slo_ms=5000.0)
    srv = Server(port_index, cfg).start()
    try:
        futs = [srv.submit(unit_db.queries[i], k=K, ef=32, deadline_ms=5000.0)
                for i in range(8)]
        resps = [f.result(timeout=60) for f in futs]
    finally:
        srv.stop()
    assert all(r.status == "ok" for r in resps)
    assert obs.tracer.spans() == []


def test_serve_cli_report_has_jax_keys(tmp_path):
    """Both drivers on the unit index with live churn: the same report keys
    (``args`` differs by the port's ``--device`` and the reference's
    ``--cache-dir``), and every request of the port's run ok."""
    argv = ["--dataset", "unit", "--rps", "20", "--duration", "1",
            "--ef", "32", "--batch-buckets", "1,4", "--slo-ms", "10000",
            "--mutate", "8", "--check-no-failures"]
    assert serve_cli.main(argv + ["--device", "cpu",
                                  "--report", str(tmp_path / "port.json")]) == 0
    assert jserve_cli.main(argv + ["--report", str(tmp_path / "jax.json")]) == 0
    port, ref = (json.loads((tmp_path / f"{n}.json").read_text())
                 for n in ("port", "jax"))
    assert set(port) == set(ref) == {"args", "summary", "histogram"}
    assert set(port["args"]) - {"device"} == set(ref["args"]) - {"cache_dir"}
    assert set(port["summary"]) == set(ref["summary"])
    assert set(port["summary"]["swaps"]) == set(ref["summary"]["swaps"])
    assert set(port["histogram"]) == set(ref["histogram"])
    assert port["summary"]["requests"] == port["summary"]["ok"] > 0
