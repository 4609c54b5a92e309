"""The ten-million-row configuration, the tiered cell and the readers of a
call's query chunks.

The deep configuration's file carries its source, its assumptions, its
limits and no cut, and names the partitioned kNN build; its cell and the
tiered cell run whole on the CPU at a tiny size and come out correct.  The
readers of ``search.chunks_per_call.batch`` and
``search.visited_gib_per_call.batch`` read known values off synthetic
spans, and nothing off the card, in the other loop, where no call holds a
beam span, or (the bitmap) where the beam spans carry no ``visited_bytes``
(as the program did before it reported them).
"""
import json

import pytest
import torch

from perfbench import harness
from perfbench import test_perfbench_faults as base
from perfbench.yard import chunks
from repro_torch.obs import Span

DEEP = "deep-image-96-angular.batch-packed"
TIERED = "sift-128-euclidean.batch-tiered"
CUDA = torch.device("cuda")   # a device object: no card needed
S = 1_000_000_000             # a second in ns
GIB = 2**30


def test_deep_config_file():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entry, = [c for c in spec["configs"] if c["name"] == "deep-image-96-angular"]
    cfg = json.loads((harness.ROOT / entry["file"]).read_text())
    assert cfg["reduced"] == [] == entry["reduced"]
    assert cfg["source"].startswith("http://ann-benchmarks.com/deep-image-96-angular.hdf5")
    assert entry["source"].startswith("http://ann-benchmarks.com/deep-image-96-angular.hdf5")
    data = cfg["data"]
    assert (data["n"], data["dim"], data["metric"], data["n_queries"], data["gt_k"]) == (
        9_990_000, 96, "ip", 10_000, 100)
    assert cfg["index"]["knn"] == "partitioned"
    assert {"spectrum_decay", "n_clusters", "cluster_spread", "queries", "n_train",
            "index", "m"} <= set(cfg["assumed"])
    assert all(isinstance(v, str) and v for v in cfg["assumed"].values())
    lim = cfg["limits"]
    assert lim["missing"] == lim["malformed"] == 0
    assert 0 < lim["gap_mean"] < lim["gap_max"] and 0 < lim["recall_at_10"] < 1


def test_deep_index_section_names_the_partitioned_build():
    """The configuration's ``index`` section goes to ``IndexSpec.for_db`` as
    the harness hands it over: 16-dim FEE segments, the partitioned build,
    a graph of degree 32."""
    from repro_torch.data.synthetic import VecDB
    from repro_torch.index import IndexSpec

    cfg = harness.load_cell(DEEP).config
    db = VecDB(name="d", vectors=torch.zeros(4, 96).numpy(), queries=None,
               train_queries=None, metric="ip", gt=None)
    spec = IndexSpec.for_db(db, **cfg["index"])
    assert (spec.seg, spec.knn, spec.metric, spec.m) == (16, "partitioned", "ip", 32)


def test_tiered_traffic_is_the_packed_batch_on_tiers():
    tiered = harness.load_cell(TIERED).traffic
    packed = harness.load_cell("sift-128-euclidean.batch-packed").traffic
    assert tiered["params"] == dict(packed["params"], storage="tiered")
    assert {k: v for k, v in tiered.items() if k != "params"} == {
        k: v for k, v in packed.items() if k != "params"}


def tiny_deep():
    """The deep cell at 6,000 rows: three k-means lists, each row in all of
    them, and its 96 dims in 6 FEE segments."""
    cell = base.tiny(DEEP)
    cell.config["data"].update(n=6000, n_clusters=8)
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_deep_run_is_correct(trace):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cell = tiny_deep()
        out = harness.run_cell(cell, base.SEED, 0.4, trace, device="cpu")
    finally:
        torch.set_num_threads(n)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    if not trace:
        assert {"recall_at_10", "setup_s"} <= set(out["metrics"])


def test_tiny_tiered_run_is_correct():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = harness.run_cell(base.tiny(TIERED), base.SEED, 0.4, False, device="cpu")
    finally:
        torch.set_num_threads(n)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


# -- the readers ---------------------------------------------------------------

def call(t0, q):
    return Span("search.call", t0, S // 2, 1, attrs=dict(q=q, storage="packed", ef=64))


def beam(t0, q, visited=None):
    attrs = dict(q=q, hops=50)
    if visited is not None:
        attrs["visited_bytes"] = visited
    return Span("search.beam", t0, S // 10, 1, attrs=attrs)


def ctx(spans, cell=DEEP, loop="closed", device=CUDA, n_calls=5):
    """A closed loop of ``n_calls`` calls, call i in [i, i + 0.5) s; the
    first three are the profiled ones."""
    calls = [(None, None, None, float(i), i + 0.5) for i in range(n_calls)]
    return harness.Context(cell=harness.load_cell(cell), device=device,
                           setup_s=1.0, window_s=5.0, loop=loop, calls=calls,
                           spans=list(spans))


def read(metric, c):
    return harness.reader(metric).read(c)


def test_chunks_per_call_is_the_profiled_calls_mean():
    """Beams counted inside each profiled call: 3, 3 and 2; the fourth call
    (after the profiled ones) and a beam outside every call count nothing."""
    spans = [call(i * S, 10_000) for i in range(4)]
    for i, n in enumerate((3, 3, 2, 9)):
        spans += [beam(i * S + (j + 1) * 1000, 3_439, 4 << 30) for j in range(n)]
    spans.append(beam(S // 2 + 1000, 3_439, 4 << 30))      # between two calls
    assert read("search.chunks_per_call.batch", ctx(spans)) == pytest.approx(8 / 3)


def test_visited_gib_sums_a_calls_beams():
    words = 312_188                                        # ceil(9,990,000 / 32)
    spans = [call(i * S, 10_000) for i in range(4)]
    for i in range(4):
        for j, q in enumerate((3_439, 3_439, 3_122)):
            spans.append(beam(i * S + (j + 1) * 1000, q, 4 * words * q))
    want = 4 * words * 10_000 / GIB
    assert read("search.visited_gib_per_call.batch", ctx(spans)) == pytest.approx(want)
    assert want == pytest.approx(11.63, abs=0.01)
    # one beam a call: sift's 1M rows in one chunk
    one = [call(0, 10_000), beam(100, 10_000, 4 * 31_250 * 10_000)]
    got = read("search.visited_gib_per_call.batch",
               ctx(one, cell="sift-128-euclidean.batch-packed"))
    assert got == pytest.approx(1.164, abs=1e-3)


@pytest.mark.parametrize("metric", ["search.chunks_per_call.batch",
                                    "search.visited_gib_per_call.batch"])
def test_nothing_read_off_the_card_in_the_other_loop_or_without_the_attribute(metric):
    sound = [call(0, 8), beam(10, 4, 64), beam(20, 4, 64)]
    assert read(metric, ctx(sound)) is not None
    assert read(metric, ctx(sound, device=torch.device("cpu"))) is None
    assert read(metric, ctx(sound, loop="open")) is None
    # beams without ``visited_bytes`` (the program before it reported them):
    # their count still reads, their bitmap does not
    bare = ctx([call(0, 8), beam(10, 4), beam(20, 4)])
    if metric == "search.chunks_per_call.batch":
        assert read(metric, bare) == 2
    else:
        assert read(metric, bare) is None
    assert read(metric, ctx([call(0, 8)])) is None           # no beam in a call
    assert read(metric, ctx([])) is None
    assert read(metric, ctx(sound, n_calls=2)) is None     # fewer calls than profiled


def test_profiled_calls_are_the_first_traced_ones():
    spans = [call(i * S, 10) for i in range(5)]
    got = chunks.profiled_calls(ctx(spans), spans)
    assert [s.t0_ns for s in got] == [0, S, 2 * S]
