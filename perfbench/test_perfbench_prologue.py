"""The reader of ``search.prologue_ms.batch`` on synthetic contexts: a known
value, and nothing read off the card, in the open loop, or where the
program records no search spans (as the program did before it had them)."""
import pytest
import torch

from perfbench import harness
from repro_torch.obs import Span

CUDA = torch.device("cuda")   # a device object: no card needed
BATCH = "sift-128-euclidean.batch-packed"
SERVE = "sift-128-euclidean.poisson-packed"
METRIC = "search.prologue_ms.batch"
MS = 1_000_000
S = 1_000_000_000


def span(name, t0, dur, tid=1, **attrs):
    return Span(name, t0, dur, tid, attrs=attrs or None)


def closed_ctx(spans=(), device=CUDA, n_calls=5):
    # call i runs over [i, i + 0.5] s; the first 3 are profiled
    calls = [(None, None, None, float(i), i + 0.5) for i in range(n_calls)]
    return harness.Context(cell=harness.load_cell(BATCH), device=device,
                           setup_s=1.0, window_s=float(n_calls), loop="closed",
                           calls=calls, spans=list(spans))


def read(ctx):
    return harness.reader(METRIC).read(ctx)


def calls(prologues):
    """One ``search.call`` a second, each holding a transform, a descent and
    a beam of the given lengths."""
    out = []
    for i, (tr, de) in enumerate(prologues):
        t = i * S + 1000
        out += [span("search.call", t, 40 * MS, q=4, storage="packed", ef=64),
                span("search.transform", t + 10, tr),
                span("search.descend", t + 10 + tr, de, levels=2, steps=5),
                span("search.beam", t + 20 + tr + de, MS, hops=3)]
    return out


def test_prologue_ms_batch_is_the_mean_over_the_calls_after_the_profiled_ones():
    out = calls([(9 * MS, 9 * MS)] * 3 + [(3 * MS, 1 * MS), (5 * MS, 3 * MS)])
    # another thread's transform inside the last call's time is not its own
    out.append(span("search.transform", 4 * S + 2000, 7 * MS, tid=2))
    assert read(closed_ctx(out)) == pytest.approx(6.0)
    assert read(closed_ctx(out, n_calls=3)) is None


@pytest.mark.parametrize("case", ["cuda", "cpu", "open_loop", "no_spans"])
def test_nothing_read_off_the_card_in_the_open_loop_or_without_the_spans(case):
    """Read on the card in the closed loop only; the parent program records
    no search spans, and then the reader gives None and does not raise."""
    out = calls([(2 * MS, 2 * MS)] * 5)
    if case == "cuda":
        assert read(closed_ctx(out)) == pytest.approx(4.0)
        return
    if case == "cpu":
        ctx = closed_ctx(out, device=torch.device("cpu"))
    elif case == "open_loop":
        ctx = harness.Context(cell=harness.load_cell(SERVE), device=CUDA,
                              setup_s=1.0, window_s=12.0, loop="open",
                              spans=out, slice=[10.0, 12.0])
    else:
        ctx = closed_ctx([s for s in out if not s.name.startswith("search.")])
    assert read(ctx) is None
