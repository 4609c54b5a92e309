"""A whole run on the CPU at a tiny size, past the harness's look for a
card: sound, it comes out correct; with the timed path broken underneath,
or with the control (the reference in bfloat16) in the program's place, it
does not.

The tiny cells keep the shape of the real ones (sift's 128 dims, L2, its
generator statistics and index spec) at 2,000 rows, and the limits of the
sift configuration's file.
"""
import copy

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.ref import exact

SEED = 2**31 + 123


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny(cell_name: str):
    cell = harness.load_cell(cell_name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["data"].update(n=2000, n_queries=64, n_train=128)
    if cell.traffic["loop"] == "open":
        cell.traffic = dict(cell.traffic, rate_per_s=60, latency_limit_ms=20000,
                            trace={"seconds": 0.2})
    return cell


def run(cell_name: str, patch=None, trace=False):
    return harness.run_cell(tiny(cell_name), SEED, 0.4, trace, device="cpu",
                            patch=patch)


CELLS = ["sift-128-euclidean.batch-packed", "sift-128-euclidean.poisson-packed"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, trace):
    out = run(cell, trace=trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    if trace:
        # no card here: the readers of device numbers return nothing
        assert out["device"]["window_s"] > 0 and "breakdown" in out
        assert set(out["metrics"]) <= {"search.dims_per_eval", "serve.queue_p95_ms",
                                       "serve.batch_fill"}
    else:
        assert {"recall_at_10", "setup_s"} <= set(out["metrics"])


def _hop_keeps_its_beam(monkeypatch):
    from repro_torch.core import search

    hop = search._hop_body

    def stuck(state, *a, **k):
        new, trace = hop(state, *a, **k)
        # the beam comes back as it went in; only the loop's own marks move
        return (state[0], state[1], torch.ones_like(state[2]), new[3]), trace

    monkeypatch.setattr(search, "_hop_body", stuck)


def _halve(run_fn):
    def halved(queries):
        n = len(queries)
        res = run_fn(queries[: max(1, n // 2)])
        fill = np.arange(n) % len(res.ids)
        res.ids, res.dists = res.ids[fill], res.dists[fill]
        return res
    return halved


def _alter(run_fn):
    def altered(queries):
        res = run_fn(queries)
        ids = np.array(res.ids)
        ids[0, 0] = next(i for i in range(2000) if i not in ids[0])
        res.ids = ids
        return res
    return altered


def _wrap_searchers(wrap):
    def patch(index, program):
        make = index.searcher
        index.searcher = lambda *a, **k: wrap(make(*a, **k))
    return patch


FAULTS = {
    "beam_unchanged": None,
    "half_the_batch": _wrap_searchers(_halve),
    "answer_altered": _wrap_searchers(_alter),
}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    if fault == "beam_unchanged":
        _hop_keeps_its_beam(monkeypatch)
    if fault == "half_the_batch" and "poisson" in cell:
        # the serving path's batches: half of each padded batch left out
        from repro_torch.serve import batcher
        bucketed = batcher.run_bucketed

        def half(snapshot, cfg, queries, *a, **k):
            n = len(queries)
            ids, dists, gen, s, res = bucketed(snapshot, cfg, queries[: max(1, n // 2)],
                                               *a, **k)
            fill = np.arange(n) % len(ids)
            return ids[fill], dists[fill], gen, s, res

        monkeypatch.setattr(batcher, "run_bucketed", half)
        out = run(cell)
    else:
        out = run(cell, patch=FAULTS[fault])
    assert not out["correct"], out["checks"]


def test_control_in_the_programs_place_is_not_correct():
    def control(index, program):
        rows = torch.from_numpy(np.ascontiguousarray(index.db_rot))

        def make(*a, **k):
            def run_fn(queries):
                q = torch.from_numpy(index.transform_queries(np.asarray(queries)))
                ids, d = exact.control_topk(rows, q, 10, "l2")
                return type("R", (), dict(ids=ids.numpy(), dists=d.numpy()))
            return run_fn
        index.searcher = make

    out = run("sift-128-euclidean.batch-packed", patch=control)
    assert not out["correct"], out["checks"]
    assert out["checks"]["gap_mean"]["value"] > out["checks"]["gap_mean"]["limit"]
