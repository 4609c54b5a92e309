"""Port beam search vs the JAX package's on one index carried across.

The JAX package builds a unit index (with a Dfloat layout, so the packed
bitstream is not the fp32 one) and saves it; the port reads the same
``spec.json`` dict and arrays through ``convert.from_arrays``.  Both then
search the same queries with the same ``SearchParams``.

Tolerance: the two packages sum each segment's distance in different orders,
so a distance differs in its last bits and a candidate at a tie may land on
the other side of a beam bound.  Each case must therefore show mean id
overlap@k >= 0.99, recall@10 within 0.005 of the reference, distances of
shared ids within rtol 3e-5 / atol 2e-4, and equal ``hops`` / ``n_eval`` /
``dims`` on >= 95% of queries.  Within the port, ``storage="packed"`` must
give exactly the ids and distances of ``storage="f32"``.
"""
import dataclasses
import json
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.index as jix
from repro.core import search as jsearch
from repro.data.synthetic import VecDB as JaxVecDB
from repro_torch.core import search as tsearch
from repro_torch.data.synthetic import DATASETS, _generate, recall_at_k
from repro_torch.index import SearchParams, from_arrays

RTOL, ATOL = 3e-5, 2e-4
BASE = SearchParams(ef=48, k=10)


def _overlap(a, b):
    return float(np.mean([len(set(x.tolist()) & set(y.tolist())) / a.shape[1]
                          for x, y in zip(a, b)]))


def _unit(name):
    """One dataset, made once and handed to both packages as numpy arrays."""
    spec = DATASETS[name]
    d = _generate(spec, 0, device="cpu")
    nq = spec.n_queries
    return JaxVecDB(name=name, vectors=d["vectors"], queries=d["queries"][:nq],
                    train_queries=d["queries"][nq:], metric=spec.metric,
                    gt=d["gt"])


def _artifact(path):
    meta = json.loads((path / "spec.json").read_text())
    with np.load(path / "arrays.npz") as z:
        return meta, {k: z[k] for k in z.files}


def _tombstone(n, seed):
    rng = np.random.default_rng(seed)
    dead = rng.choice(n, n // 20, replace=False)
    words = np.zeros(-(-n // 32), np.uint32)
    np.bitwise_or.at(words, dead >> 5, np.uint32(1) << (dead & 31).astype(np.uint32))
    return words, dead


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """{metric: (db, jax index, port index, jax tombstoned, port tombstoned,
    dead ids)} over one JAX-built index per metric."""
    out = {}
    for metric, name in (("l2", "unit"), ("ip", "unit_ip")):
        db = _unit(name)
        spec = jix.IndexSpec.for_db(db, m=8, dfloat_recall_target=0.8,
                                    dfloat_proxy=True)
        ref = jix.Index.build(db, spec, cache_key=f"torch-parity/{name}/"
                              f"{zlib.crc32(db.vectors.tobytes())}")
        assert ref.dfloat_cfg.segments[0].n_man < 23      # a real Dfloat layout
        path = tmp_path_factory.mktemp(f"jax_{name}")
        ref.save(path)
        meta, arrays = _artifact(path)
        port = from_arrays(meta, arrays, "cpu")
        tomb, dead = _tombstone(db.n, 7)
        ref_dead = jix.Index.load(path)
        ref_dead.tombstone = tomb
        port_dead = from_arrays(meta, {**arrays, "tombstone": tomb}, "cpu")
        out[metric] = (db, ref, port, ref_dead, port_dead, dead)
    return out


CASES = {
    "l2-e4-f32": ("l2", dict()),
    "l2-e4-packed": ("l2", dict(storage="packed")),
    "l2-e1-f32": ("l2", dict(expand=1)),
    "l2-e1-packed-trace": ("l2", dict(expand=1, storage="packed", trace=True)),
    "l2-e4-c1-f32-tomb": ("l2", dict(compact=1.0, tomb=True)),
    "l2-e4-c1-packed-tomb-trace": ("l2", dict(compact=1.0, storage="packed",
                                              tomb=True, trace=True)),
    "l2-e4-f32-trace": ("l2", dict(trace=True)),
    # 32 popped lists x M=10 lanes = 320 >= 256: the sort arm of the dedup
    "l2-e32-wide-f32": ("l2", dict(expand=32, ef=64, compact=1.0)),
    "ip-e4-f32": ("ip", dict()),
    "ip-e4-packed-tomb": ("ip", dict(storage="packed", tomb=True)),
    "ip-e1-c1-f32-trace": ("ip", dict(expand=1, compact=1.0, trace=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_search_matches_jax_on_carried_index(pair, case):
    metric, opts = CASES[case]
    tomb = opts.get("tomb", False)
    fields = {k: v for k, v in opts.items() if k != "tomb"}
    db, ref, port, ref_dead, port_dead, dead = pair[metric]
    if tomb:
        ref, port = ref_dead, port_dead
    params = dataclasses.replace(BASE, **fields)
    want = ref.search(db.queries, jix.SearchParams(**dataclasses.asdict(params)))
    got = port.search(db.queries, params)

    assert got.ids.shape == want.ids.shape
    assert _overlap(got.ids, want.ids) >= 0.99
    assert abs(recall_at_k(got.ids, db.gt, 10)
               - recall_at_k(want.ids, db.gt, 10)) <= 0.005
    for gi, gd, wi, wd in zip(got.ids, got.dists, want.ids, want.dists):
        shared = np.intersect1d(gi[gi >= 0], wi[wi >= 0])
        g = dict(zip(gi.tolist(), gd.tolist()))
        w = dict(zip(wi.tolist(), wd.tolist()))
        np.testing.assert_allclose([g[i] for i in shared], [w[i] for i in shared],
                                   rtol=RTOL, atol=ATOL)
    for key in ("hops", "n_eval", "dims"):
        assert np.mean(getattr(got, key) == getattr(want, key)) >= 0.95, key
    if tomb:
        assert not np.isin(got.ids, dead).any()
    if params.trace:
        for key in ("node", "nbrs", "segs", "cand_d", "src"):
            assert got.trace[key].shape == want.trace[key].shape, key
        same = (got.trace["nbrs"] == want.trace["nbrs"]).all((1, 2))
        assert same.mean() >= 0.95
    if params.storage == "packed":
        f32 = port.search(db.queries, dataclasses.replace(params, storage="f32"))
        assert np.array_equal(got.ids, f32.ids)
        assert np.array_equal(got.dists, f32.dists)


# ---------------------------------------------------------------------------
# the hop's building blocks, element for element on random inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [40, 320])           # pairwise arm, sort arm
def test_first_occurrence_mask_matches_jax(n):
    rng = np.random.default_rng(n)
    ids = rng.integers(0, n // 4, (6, n)).astype(np.int32)
    valid = rng.random((6, n)) < 0.8
    got = tsearch.first_occurrence_mask(torch.from_numpy(ids),
                                        torch.from_numpy(valid)).numpy()
    for i in range(6):
        want = np.asarray(jsearch.first_occurrence_mask(jnp.asarray(ids[i]),
                                                        jnp.asarray(valid[i])))
        assert np.array_equal(got[i], want)


def test_pop_and_merge_break_ties_like_jax():
    """Integer-valued distances force ties: the beam must win them and the
    pop must take the lower slot, as ``lax.top_k`` does."""
    rng = np.random.default_rng(3)
    q, ef, c = 5, 16, 24
    beam_ids = rng.integers(0, 1000, (q, ef)).astype(np.int32)
    beam_d = np.sort(rng.integers(0, 6, (q, ef)).astype(np.float32), axis=1)
    beam_d[:, -3:] = jsearch.BIG
    expanded = rng.random((q, ef)) < 0.3
    cand_ids = rng.integers(0, 1000, (q, c)).astype(np.int32)
    cand_d = rng.integers(0, 6, (q, c)).astype(np.float32)
    t = lambda a: torch.from_numpy(a)
    nodes, sel, exp2 = tsearch.pop_frontier(t(beam_ids), t(beam_d), t(expanded), 4)
    merged = tsearch.merge_beam(t(beam_ids), t(beam_d), t(expanded), t(cand_ids),
                                t(cand_d))
    for i in range(q):
        jn, js, je = jsearch.pop_frontier(jnp.asarray(beam_ids[i]),
                                          jnp.asarray(beam_d[i]),
                                          jnp.asarray(expanded[i]), 4)
        assert np.array_equal(nodes[i].numpy(), np.asarray(jn))
        assert np.array_equal(sel[i].numpy(), np.asarray(js))
        assert np.array_equal(exp2[i].numpy(), np.asarray(je))
        jm = jsearch.merge_beam(jnp.asarray(beam_ids[i]), jnp.asarray(beam_d[i]),
                                jnp.asarray(expanded[i]), jnp.asarray(cand_ids[i]),
                                jnp.asarray(cand_d[i]))
        for a, b in zip(merged, jm):
            assert np.array_equal(a[i].numpy(), np.asarray(b))


def test_exclude_dead_matches_jax():
    rng = np.random.default_rng(5)
    beam_ids = rng.integers(-1, 200, (4, 12)).astype(np.int32)
    beam_d = np.sort(rng.random((4, 12)).astype(np.float32), axis=1)
    tomb, _ = _tombstone(200, 9)
    got = tsearch.exclude_dead(torch.from_numpy(beam_ids), torch.from_numpy(beam_d),
                               torch.from_numpy(tomb.view(np.int32)))
    for i in range(4):
        want = jsearch.exclude_dead(jnp.asarray(beam_ids[i]), jnp.asarray(beam_d[i]),
                                    jnp.asarray(tomb))
        for a, b in zip(got, want):
            assert np.array_equal(a[i].numpy(), np.asarray(b))


def test_unported_paths_raise_naming_the_queue(pair):
    _, _, port, *_ = pair["l2"]
    with pytest.raises(NotImplementedError, match="queue"):
        port.searcher("local", dataclasses.replace(BASE, storage="tiered"))
    with pytest.raises(NotImplementedError, match="queue B"):
        port.searcher("local", dataclasses.replace(BASE, fee_backend="pallas_skip_dma"))
    for backend in ("sharded", "ndpsim"):
        with pytest.raises(NotImplementedError, match="queue A"):
            port.searcher(backend, BASE)
