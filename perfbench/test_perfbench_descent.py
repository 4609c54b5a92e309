"""The readers of ``search.descent_kernel_share.batch`` and ``.serve`` on
synthetic contexts: known values, nothing read off the card or in the other
loop, and nothing where the program's ``search.descend`` spans carry no
``kernel_levels`` (as the program did before its descent had a kernel), no
span, or no level."""
import pytest
import torch

from perfbench import harness
from perfbench.yard import descent_levels
from repro_torch.obs import Span

CUDA = torch.device("cuda")   # a device object: no card needed
BATCH = "sift-128-euclidean.batch-packed"
SERVE = "sift-128-euclidean.poisson-packed"
METRICS = {"search.descent_kernel_share.batch": "closed",
           "search.descent_kernel_share.serve": "open"}
MS = 1_000_000
S = 1_000_000_000


def descend(t0, levels, kernel=None, tid=1, steps=None):
    attrs = dict(levels=levels, steps=levels + 3 if steps is None else steps)
    if kernel is not None:
        attrs["kernel_levels"] = kernel
    return Span("search.descend", t0, MS, tid, attrs=attrs)


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
def test_share_is_kernel_levels_over_levels(metric):
    loop = METRICS[metric]
    spans = [descend(1 * S, 4, 4), descend(2 * S, 4, 4), descend(3 * S, 3, 0, tid=2),
             Span("search.beam", 1 * S + 10, MS, 1, attrs=dict(q=4, hops=9)),  # not read
             Span("search.call", 1 * S, 9 * MS, 1, attrs=dict(q=4))]
    assert read(metric, ctx(loop, spans)) == pytest.approx(8 / 11)
    assert read(metric, ctx(loop, [descend(i * S, 4, 4) for i in range(1, 9)])) == 1.0
    assert read(metric, ctx(loop, [descend(i * S, 4, 0) for i in range(1, 9)])) == 0.0


@pytest.mark.parametrize("metric", METRICS)
def test_nothing_read_off_the_card_or_in_the_other_loop(metric):
    loop = METRICS[metric]
    spans = [descend(1000, 4, 4)]
    assert read(metric, ctx(loop, spans)) == 1.0
    assert read(metric, ctx(loop, spans, device=torch.device("cpu"))) is None
    other = "open" if loop == "closed" else "closed"
    assert read(metric, ctx(other, spans)) is None


@pytest.mark.parametrize("metric", METRICS)
def test_nothing_read_without_the_attribute_a_span_or_a_level(metric):
    """The parent program's ``search.descend`` spans carry ``levels`` and
    ``steps`` and no ``kernel_levels``: the reader gives None and does not
    raise; so it does with no span, or with spans of no level (a graph with
    no upper level)."""
    loop = METRICS[metric]
    assert read(metric, ctx(loop, [descend(1000, 4), descend(5000, 4)])) is None
    assert read(metric, ctx(loop, [])) is None
    assert read(metric, ctx(loop, [descend(1000, 0, 0, steps=0)])) is None


def test_share_counts_only_tagged_spans():
    spans = [Span("search.descend", 0, 5, 1, attrs=dict(levels=4, steps=20)),
             Span("search.descend", 10, 5, 1, attrs=dict(levels=4, steps=9,
                                                          kernel_levels=4)),
             Span("search.descend", 20, 5, 1, attrs=dict(levels=4, steps=9,
                                                          kernel_levels=0)),
             Span("search.descend", 30, 5, 1, attrs=None)]
    assert descent_levels.share(spans) == pytest.approx(0.5)
