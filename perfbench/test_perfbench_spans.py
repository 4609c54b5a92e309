"""The readers of the program's search spans, on synthetic contexts: known
values, and nothing read off the card or where the program records no such
span (as the program did before it had them)."""
import pytest
import torch

from perfbench import harness
from perfbench.yard import spans as spans_mod
from repro_torch.obs import Span

CUDA = torch.device("cuda")   # a device object: no card needed
BATCH = "sift-128-euclidean.batch-packed"
SERVE = "sift-128-euclidean.poisson-packed"
MS = 1_000_000


def span(name, t0, dur, tid=1, **attrs):
    return Span(name, t0, dur, tid, attrs=attrs or None)


def closed_ctx(spans=(), trace=None, device=CUDA, n_calls=5):
    # call i runs over [i, i + 0.5] s; the first 3 are profiled
    calls = [(None, None, None, float(i), i + 0.5) for i in range(n_calls)]
    return harness.Context(cell=harness.load_cell(BATCH), device=device,
                           setup_s=1.0, window_s=float(n_calls), loop="closed",
                           calls=calls, spans=list(spans), trace=trace)


def open_ctx(spans=(), trace=None, device=CUDA):
    return harness.Context(cell=harness.load_cell(SERVE), device=device,
                           setup_s=1.0, window_s=12.0, loop="open",
                           spans=list(spans), trace=trace, slice=[10.0, 12.0])


def read(metric, ctx):
    return harness.reader(metric).read(ctx)


def test_host_us_per_hop_batch_reads_the_calls_after_the_profiled_ones():
    s = 1_000_000_000
    beams = [span("search.beam", i * s + 1000, 50 * MS, q=10, hops=5)
             for i in range(3)]                       # profiled: left out
    beams += [span("search.beam", 3 * s + 1000, 2 * MS, q=10, hops=4),
              span("search.beam", 4 * s + 1000, 4 * MS, q=10, hops=8)]
    hops = [span("search.hop", 3 * s + 2000, MS)]     # not read here
    got = read("search.host_us_per_hop.batch", closed_ctx(beams + hops))
    assert got == pytest.approx(6 * MS / 12 / 1e3)    # 500 us a hop
    assert read("search.host_us_per_hop.batch",
                closed_ctx(beams, n_calls=3)) is None


def test_host_us_per_hop_serve_reads_before_the_slice():
    s = 1_000_000_000
    beams = [span("search.beam", 2 * s, 3 * MS, hops=6),
             span("search.beam", 9 * s, 1 * MS, hops=2),
             span("search.beam", 10 * s - MS // 2, MS, hops=100),   # crosses
             span("search.beam", 11 * s, 9 * MS, hops=1)]
    got = read("search.host_us_per_hop.serve", open_ctx(beams))
    assert got == pytest.approx(4 * MS / 8 / 1e3)


def test_prologue_ms_serve_is_the_mean_over_calls():
    s = 1_000_000_000
    out = []
    for i, (tr, de) in enumerate([(1 * MS, 3 * MS), (2 * MS, 2 * MS)]):
        t = (i + 1) * s
        out += [span("search.call", t, 20 * MS, q=4, storage="packed", ef=64),
                span("search.transform", t + 10, tr),
                span("search.descend", t + 10 + tr, de, levels=2, steps=5),
                span("search.beam", t + 20 + tr + de, MS, hops=3)]
    # another thread's descent inside the first call's time is not its own
    out.append(span("search.descend", 1 * s + 100, 7 * MS, tid=2))
    # a call after the slice's start is left out
    out += [span("search.call", 11 * s, 20 * MS),
            span("search.transform", 11 * s + 10, 50 * MS)]
    got = read("search.prologue_ms.serve", open_ctx(out))
    assert got == pytest.approx(4.0)


def test_beam_idle_pct_counts_the_uncovered_share_of_the_beam_ranges():
    tr = harness.Trace(device=[("k1", 0, 50), ("k2", 40, 60), ("k3", 250, 400)],
                       host=[("search.beam", 0, 100), ("search.beam", 200, 300),
                             ("search.hop", 0, 10), ("bench.window", 0, 400)],
                       lo=0, hi=400)
    got = read("search.beam_idle_pct.batch", closed_ctx(trace=tr))
    assert got == pytest.approx(100.0 * (1 - (60 + 50) / 200))


def test_launch_calls_per_hop_counts_launches_inside_hops():
    tr = harness.Trace(device=[("k", 0, 5)],
                       host=[("search.hop", 0, 10), ("search.hop", 20, 30),
                             ("cudaLaunchKernel", 1, 2), ("cudaLaunchKernel", 5, 6),
                             ("cudaGraphLaunch", 25, 26),
                             ("cudaLaunchKernel", 15, 16),     # between hops
                             ("aten::add", 2, 3), ("search.sync", 10, 20)],
                       lo=0, hi=30)
    got = read("search.launch_calls_per_hop.batch", closed_ctx(trace=tr))
    assert got == pytest.approx(3 / 2)


NEW = ["search.host_us_per_hop.batch", "search.host_us_per_hop.serve",
       "search.prologue_ms.serve", "search.beam_idle_pct.batch",
       "search.launch_calls_per_hop.batch"]


def _full(metric, device):
    """A context with something to read for ``metric`` on ``device``."""
    s = 1_000_000_000
    if metric.endswith(".serve"):
        return open_ctx([span("search.call", s, 9 * MS),
                         span("search.transform", s + 1, MS),
                         span("search.beam", s + MS + 2, MS, hops=3)],
                        device=device)
    tr = harness.Trace(device=[("k", 0, 5)],
                       host=[("search.beam", 0, 40), ("search.hop", 0, 10),
                             ("cudaLaunchKernel", 1, 2)], lo=0, hi=40)
    return closed_ctx([span("search.beam", 4 * s, MS, hops=3)], trace=tr,
                      device=device)


@pytest.mark.parametrize("metric", NEW)
def test_nothing_read_off_the_card(metric):
    assert read(metric, _full(metric, CUDA)) is not None
    assert read(metric, _full(metric, torch.device("cpu"))) is None


@pytest.mark.parametrize("metric", NEW)
def test_nothing_read_without_the_spans(metric):
    """The parent program records no search spans: each reader gives None
    and does not raise."""
    ctx = _full(metric, CUDA)
    ctx.spans = [s for s in ctx.spans if not s.name.startswith("search.")]
    if ctx.trace is not None:
        ctx.trace.host = [h for h in ctx.trace.host
                          if not h[0].startswith("search.")]
    assert read(metric, ctx) is None


def test_spans_inside_pairs_children_with_their_call_on_a_thread():
    calls = [span("c", 0, 100), span("c", 200, 100), span("c", 50, 10, tid=2)]
    kids = [span("k", 10, 5), span("k", 250, 5), span("k", 120, 5),
            span("k", 52, 3, tid=2), span("k", 95, 10)]
    got = spans_mod.inside(calls, kids)
    assert [[k.t0_ns for k in g] for g in got] == [[10], [250], [52]]
    assert spans_mod.count_inside([(20, 30), (0, 10)], [0, 10, 11, 25, 31]) == 3
