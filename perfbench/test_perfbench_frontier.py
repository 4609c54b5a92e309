"""The readers of ``search.frontier_kernel_share.batch`` and ``.serve`` on
synthetic contexts: known values, nothing read off the card or in the other
loop, and nothing where the program's ``search.beam`` spans carry no
``frontier_hops`` (as the program did before its frontier step had a
kernel)."""
import pytest
import torch

from perfbench import harness
from perfbench.yard import frontier_hops
from repro_torch.obs import Span

CUDA = torch.device("cuda")   # a device object: no card needed
BATCH = "sift-128-euclidean.batch-packed"
SERVE = "sift-128-euclidean.poisson-packed"
METRICS = {"search.frontier_kernel_share.batch": "closed",
           "search.frontier_kernel_share.serve": "open"}
MS = 1_000_000
S = 1_000_000_000


def beam(t0, hops, frontier=None, tid=1):
    attrs = dict(q=4, hops=hops, graph_hops=hops)
    if frontier is not None:
        attrs["frontier_hops"] = frontier
    return Span("search.beam", t0, MS, tid, attrs=attrs)


def ctx(loop, spans, device=CUDA):
    if loop == "closed":
        calls = [(None, None, None, float(i), i + 0.5) for i in range(5)]
        return harness.Context(cell=harness.load_cell(BATCH), device=device,
                               setup_s=1.0, window_s=5.0, loop="closed",
                               calls=calls, spans=list(spans))
    return harness.Context(cell=harness.load_cell(SERVE), device=device,
                           setup_s=1.0, window_s=12.0, loop="open",
                           spans=list(spans), slice=[10.0, 12.0])


def read(metric, c):
    return harness.reader(metric).read(c)


@pytest.mark.parametrize("metric", METRICS)
def test_share_is_frontier_hops_over_hops(metric):
    loop = METRICS[metric]
    spans = [beam(1 * S, 55, 55), beam(2 * S, 61, 61), beam(3 * S, 4, 0, tid=2),
             Span("search.hop", 1 * S + 10, MS, 1),        # not read
             Span("search.call", 1 * S, 9 * MS, 1, attrs=dict(q=4))]
    assert read(metric, ctx(loop, spans)) == pytest.approx(116 / 120)
    assert read(metric, ctx(loop, [beam(i * S, 28, 28) for i in range(1, 9)])) == 1.0
    assert read(metric, ctx(loop, [beam(i * S, 28, 0) for i in range(1, 9)])) == 0.0


@pytest.mark.parametrize("metric", METRICS)
def test_nothing_read_off_the_card_or_in_the_other_loop(metric):
    loop = METRICS[metric]
    spans = [beam(1000, 10, 10)]
    assert read(metric, ctx(loop, spans)) == 1.0
    assert read(metric, ctx(loop, spans, device=torch.device("cpu"))) is None
    other = "open" if loop == "closed" else "closed"
    assert read(metric, ctx(other, spans)) is None


@pytest.mark.parametrize("metric", METRICS)
def test_nothing_read_without_the_attribute(metric):
    """The parent program's ``search.beam`` spans carry ``hops`` and
    ``graph_hops`` and no ``frontier_hops``: the reader gives None and does
    not raise; so it does with no span, or with spans of no hop."""
    loop = METRICS[metric]
    assert read(metric, ctx(loop, [beam(1000, 10), beam(5000, 12)])) is None
    assert read(metric, ctx(loop, [])) is None
    assert read(metric, ctx(loop, [beam(1000, 0, 0)])) is None


def test_share_counts_only_tagged_spans():
    spans = [Span("search.beam", 0, 5, 1, attrs=dict(hops=10)),
             Span("search.beam", 10, 5, 1, attrs=dict(hops=4, frontier_hops=3)),
             Span("search.beam", 20, 5, 1, attrs=None)]
    assert frontier_hops.share(spans) == pytest.approx(0.75)
