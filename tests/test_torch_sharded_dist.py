"""``GroupShards``: the port's sharded search with one shard per rank of a
4-rank gloo process group on the CPU, against ``LocalShards(4)`` (the four
shards stacked in one process) over the same saved index.

The ranks run in a subprocess (``tests/torch_sharded_ranks.py``, started by
``torch.multiprocessing.spawn``, meeting through a file store: no network).
Every rank must return the whole result, and its ids and distances must
equal ``LocalShards(4)``'s bit for bit, in sync and overlap mode, for f32
and packed storage, over an index with tombstoned rows.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.data.synthetic import make_dataset
from repro_torch.index import Index, IndexSpec, SearchParams

HERE = Path(__file__).parent
WORLD = 4
# case: [index (0 plain, 1 tombstoned), SearchParams fields, overlap]
CASES = {
    "f32-sync": [0, dict(ef=48, k=10), False],
    "f32-sync-compact1-tomb": [1, dict(ef=48, k=10, compact=1.0), False],
    "f32-overlap-tomb": [1, dict(ef=48, k=10), True],
    "packed-sync-tomb": [1, dict(ef=48, k=10, storage="packed"), False],
    "packed-overlap-tomb": [1, dict(ef=48, k=10, storage="packed"), True],
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(indexes, queries, dead ids, [per-rank {case: (ids, dists)}])."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        db = make_dataset("unit", device="cpu", cache=False)
        idx = Index.build(db, IndexSpec.for_db(db, m=8, dfloat_recall_target=0.8,
                                               dfloat_proxy=True), device="cpu")
    finally:
        torch.set_num_threads(n)
    root = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(3)
    dead = rng.choice(db.n, db.n // 20, replace=False)
    words = np.zeros(-(-db.n // 32), np.uint32)
    np.bitwise_or.at(words, dead >> 5, np.uint32(1) << (dead & 31).astype(np.uint32))
    paths = [idx.save(root / "plain.naszip")]
    idx.tombstone = words
    paths.append(idx.save(root / "dead.naszip"))
    q = db.queries[:30]                 # not a multiple of the 4 ranks: padded
    np.save(paths[0] / "queries.npy", q)
    out = root / "out"
    out.mkdir()
    env = {**os.environ, "PYTHONPATH": str(HERE.parent / "src")}
    r = subprocess.run([sys.executable, str(HERE / "torch_sharded_ranks.py"),
                        ",".join(map(str, paths)), str(out), str(WORLD),
                        json.dumps(CASES)], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-2500:])
    results = []
    for rank in range(WORLD):
        with np.load(out / f"rank{rank}.npz") as z:
            results.append({c: (z[c + "/ids"], z[c + "/dists"]) for c in CASES})
    indexes = [Index.load(p, device="cpu") for p in paths]
    return indexes, q, dead, results


@pytest.mark.parametrize("case", list(CASES))
def test_group_shards_equal_local_shards(ranks, case):
    indexes, q, dead, results = ranks
    which, fields, overlap = CASES[case]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = indexes[which].searcher("sharded", SearchParams(**fields), n_shards=WORLD,
                                       overlap=overlap)(q)
    finally:
        torch.set_num_threads(n)
    for rank, res in enumerate(results):
        ids, dists = res[case]
        assert np.array_equal(ids, want.ids), rank
        assert np.array_equal(dists, want.dists), rank
    if which:
        assert not np.isin(want.ids, dead).any()
