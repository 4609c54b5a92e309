"""The partitioned base-level kNN build (``core/graph.py``, ``knn=
"partitioned"``) against the exact scan, on the CPU at small sizes.

With one list it is the exact scan bit for bit; with several it finds at
least 95% of the exact lists on clustered rows; its lists are nearest
first, free of self loops and repeats, and in range; two builds agree, and
so do builds of rows that differ by an axis's sign.  ``IndexSpec.knn``
rides through ``save``/``load``, and ``knn="exact"`` leaves the graph
cache's path and the saved spec as they were.  No JAX here.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import graph as gmod
from repro_torch.data.synthetic import VecDB
from repro_torch.index import Index, IndexSpec

K = 32


def clustered(n, d, clusters, seed, decay=1.0, spread=0.5):
    """Gaussian clusters with a falling spectrum (``i^-decay``), f32."""
    g = torch.Generator().manual_seed(seed)
    scale = torch.arange(1, d + 1, dtype=torch.float64).pow(-decay)
    scale = (scale / scale.sum() * d).sqrt().float()
    centers = torch.randn(clusters, d, generator=g) * scale
    rows = centers[torch.randint(0, clusters, (n,), generator=g)]
    return rows + spread * torch.randn(n, d, generator=g) * scale


@pytest.fixture(scope="module")
def many():
    """20,000 x 32 clustered rows (10 lists of the partition) and their
    partitioned lists."""
    x = clustered(20_000, 32, 4, seed=3)
    return x, gmod._partitioned_knn(x, K, "l2", seed=0)


def _exact(x, metric="l2"):
    return torch.from_numpy(gmod._knn_adjacency(x, K, metric)).long()


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_one_list_is_the_exact_scan(metric):
    x = clustered(1_500, 16, 3, seed=1)
    assert -(-len(x) // gmod.LIST_ROWS) == 1
    got = gmod._partitioned_knn(x, K, metric, seed=0).to(torch.int32).numpy()
    assert np.array_equal(got, gmod._knn_adjacency(x, K, metric))


def test_one_list_builds_the_exact_graph():
    x = clustered(1_200, 16, 3, seed=2).numpy()
    exact = gmod.build_graph(x, m=8, device="cpu")
    part = gmod.build_graph(x, m=8, device="cpu", knn="partitioned")
    assert len(exact.levels) == len(part.levels) and exact.entry == part.entry
    for (ia, aa), (ib, ab) in zip(exact.levels, part.levels):
        assert np.array_equal(ia, ib) and np.array_equal(aa, ab)
    assert part.timings["knn_recall"] == 1.0
    assert {"knn_s", "prune_s", "levels_s"} <= set(exact.timings)


def test_several_lists_find_the_exact_lists(many):
    x, ids = many
    assert -(-len(x) // gmod.LIST_ROWS) == 10
    exact = _exact(x)
    found = np.mean([len(set(a.tolist()) & set(b.tolist())) / K
                     for a, b in zip(ids, exact)])
    assert found >= 0.95
    # the build's own check reads the same share on its sample
    assert gmod.knn_recall(x, ids, "l2", seed=0, n_rows=2_000) == pytest.approx(found, abs=0.01)


def test_lists_are_nearest_first_without_self_or_repeat(many):
    x, ids = many
    n = len(x)
    assert ids.shape == (n, K) and ids.dtype == torch.int64
    assert int(ids.min()) >= 0 and int(ids.max()) < n
    assert not (ids == torch.arange(n)[:, None]).any()
    srt = ids.sort(1).values
    assert not (srt[:, 1:] == srt[:, :-1]).any()
    sq = (x ** 2).sum(1)
    d = sq[:, None] + sq[ids] - 2 * torch.einsum("nd,nkd->nk", x, x[ids])
    # the exact scan's score, up to its product's rounding
    assert (d[:, 1:] >= d[:, :-1] - 1e-4 * d.abs().max()).all()


def test_deterministic_and_blind_to_an_axis_sign(many):
    x, ids = many
    assert torch.equal(gmod._partitioned_knn(x, K, "l2", seed=0), ids)
    flip = x.clone()
    flip[:, [0, 5, 17]] *= -1
    assert torch.equal(gmod._partitioned_knn(flip, K, "l2", seed=0), ids)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_batched_lists_equal_lists_scanned_alone(metric, monkeypatch):
    """Lists scored together in a batched product (the default) and each
    scanned alone (a score budget under one list's square) give the same
    lists, up to the products' rounding at near ties."""
    x = clustered(12_000, 24, 3, seed=4)
    if metric == "ip":
        x = x / x.norm(dim=1, keepdim=True)
    batched = gmod._partitioned_knn(x, K, metric, seed=1)
    scan, scanned = gmod._knn_scores, []

    def spy(*a, **kw):
        scanned.append(a[0].shape[0])
        return scan(*a, **kw)

    monkeypatch.setattr(gmod, "_knn_scores", spy)
    alone = gmod._partitioned_knn(x, K, metric, seed=1, block_bytes=1 << 20)
    assert len(scanned) == -(-len(x) // gmod.LIST_ROWS) and sum(scanned) == gmod.LIST_PROBES * len(x)
    same = np.mean([set(a.tolist()) == set(b.tolist()) for a, b in zip(batched, alone)])
    assert same >= 0.99


def test_rows_of_small_lists_take_the_exact_scan(monkeypatch):
    """A hundred lists, each row in 3 of them, hold fewer than ``k``
    others for some rows: each row whose lists fall short gets the exact
    scan's lists, so none holds a -1."""
    monkeypatch.setattr(gmod, "LIST_ROWS", 6)
    monkeypatch.setattr(gmod, "LIST_PROBES", 3)
    scan, rescanned = gmod._knn_scores, []

    def spy(*a, rows=None, **kw):
        if rows is not None:
            rescanned.append(rows.clone())
        return scan(*a, rows=rows, **kw)

    monkeypatch.setattr(gmod, "_knn_scores", spy)
    x = clustered(600, 8, 5, seed=5)
    ids = gmod._partitioned_knn(x, 16, "l2", seed=0)
    assert int(ids.min()) >= 0 and len(rescanned) == 1
    short = rescanned[0]
    assert 0 < len(short) < len(x)
    want = torch.from_numpy(gmod._knn_adjacency(x, 16, "l2")).long()
    assert torch.equal(ids[short], want[short])


def test_unknown_build_is_refused():
    with pytest.raises(ValueError, match="knn="):
        gmod.build_graph(np.zeros((10, 4), np.float32), m=2, device="cpu", knn="ivf")


def _db(n=3_000, d=16, metric="l2"):
    x = clustered(n, d, 4, seed=6).numpy()
    q = clustered(64, d, 4, seed=7).numpy()
    return VecDB(name="t", vectors=x, queries=q[:32], train_queries=q[32:],
                 metric=metric, gt=None)


def test_spec_knn_rides_through_save_and_load(tmp_path):
    db = _db()
    spec = IndexSpec.for_db(db, m=8, dfloat_recall_target=None, knn="partitioned")
    assert IndexSpec.from_json(spec.to_json()) == spec
    idx = Index.build(db, spec, device="cpu")
    assert -(-db.n // gmod.LIST_ROWS) == 2
    assert {"knn_s", "knn_recall", "prune_s", "levels_s"} <= set(idx.timings)
    assert 0.95 <= idx.timings["knn_recall"] <= 1.0
    path = idx.save(tmp_path / "part.naszip")
    assert json.loads((path / "spec.json").read_text())["spec"]["knn"] == "partitioned"
    back = Index.load(path, device="cpu")
    assert back.spec == spec
    for (ia, aa), (ib, ab) in zip(idx.graph.levels, back.graph.levels):
        assert np.array_equal(ia, ib) and np.array_equal(aa, ab)


def test_exact_spec_is_saved_without_knn(tmp_path):
    """An exact build's spec is the one the JAX package writes and reads:
    no ``knn`` key, and loading it gives ``knn="exact"``."""
    db = _db(600)
    spec = IndexSpec.for_db(db, m=8, dfloat_recall_target=None)
    assert spec.knn == "exact" and "knn" not in spec.to_dict()
    assert "knn" not in json.loads(spec.to_json())
    path = Index.build(db, spec, device="cpu").save(tmp_path / "exact.naszip")
    assert "knn" not in json.loads((path / "spec.json").read_text())["spec"]
    assert Index.load(path, device="cpu").spec == spec


@pytest.mark.parametrize("knn,tail", [("exact", "/v1"), ("partitioned", "/knn-partitioned/v1")])
def test_graph_cache_path(monkeypatch, knn, tail):
    """``knn="exact"`` keeps the cache path every existing graph was saved
    under; the partitioned build adds its own part.  Neither caches its
    timings: a graph read back from the cache reports none."""
    keys, stored = [], {}

    def cached(key, make):
        keys.append(key)
        stored[key] = make()
        return stored[key]

    monkeypatch.setattr(gmod, "cached_npz", cached)
    x = clustered(300, 8, 2, seed=8).numpy()
    built = gmod.build_graph(x, m=4, metric="l2", cache_key="k", device="cpu", knn=knn)
    assert keys == [f"torch/graph/k/m4/l2/pTrue/l2{tail}"]
    assert {"knn_s", "prune_s", "levels_s"} <= set(built.timings)
    assert not any(k.startswith("timing") for k in stored[keys[0]])
    monkeypatch.setattr(gmod, "cached_npz", lambda key, make: stored[key])
    back = gmod.build_graph(x, m=4, metric="l2", cache_key="k", device="cpu", knn=knn)
    assert back.timings == {}
    assert np.array_equal(back.base_adjacency, built.base_adjacency)
