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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.index as jix
import torch_beam_cases as beam_cases
from repro.core import search as jsearch
from repro.data.synthetic import VecDB as JaxVecDB
from repro_torch.core import search as tsearch
from repro_torch.data.synthetic import DATASETS, _generate, recall_at_k
from repro_torch.index import SearchParams, from_arrays
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

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


def jax_frontier(nodes, sel, adj, visited, width):
    """One query's frontier step as the JAX package's ``_hop_body`` writes
    it, on its pieces: ``first_occurrence_mask``, the stable fresh-first
    partition (``lax.top_k`` of the fresh mask) and the visited add."""
    e, m = nodes.shape[0], adj.shape[1]
    nbrs = adj[jnp.maximum(nodes, 0)].reshape(e * m)
    valid = (nbrs >= 0) & jnp.repeat(sel, m)
    safe = jnp.maximum(nbrs, 0)
    bit = lambda ids: jnp.uint32(1) << (ids & 31).astype(jnp.uint32)
    seen = (visited[safe >> 5] & bit(safe)) != 0
    fresh = valid & ~seen & jsearch.first_occurrence_mask(safe, valid)
    if e > 1:
        _, keep = jax.lax.top_k(fresh.astype(jnp.float32), width)
        nbrs, safe, fresh = nbrs[keep], safe[keep], fresh[keep]
        src = keep // m
    else:
        src = jnp.arange(e * m, dtype=jnp.int32) // m
    visited = visited.at[safe >> 5].add(jnp.where(fresh, bit(safe), jnp.uint32(0)))
    return nbrs, safe, fresh, src, visited


@pytest.mark.parametrize("compact", [0.5, 1.0])
@pytest.mark.parametrize("e,m", [(1, 20), (4, 20), (8, 16), (16, 20)])
def test_frontier_plain_twin_matches_jax_hop_pieces(e, m, compact):
    """The frontier step's plain version (``ref.frontier_ref``, what the CPU
    runs) against the JAX package's hop pieces, bit for bit, at E*M = 20
    (E = 1: no compaction), 80, 128 (the pairwise arm of
    ``first_occurrence_mask``) and 320 (its sort arm): the compacted ids,
    clamped ids, fresh lanes, pop slots and the visited words after."""
    nodes, sel, adj, visited = beam_cases.frontier_inputs(37, e, m, e * m)
    width = tsearch.compact_width(m, e, compact)
    assert width == jsearch.compact_width(m, e, compact)
    t = torch.from_numpy
    vis = t(visited.copy())
    got = kref.frontier_ref(t(nodes), t(sel), t(adj), vis, width)
    want = jax.vmap(jax_frontier, in_axes=(0, 0, None, 0, None))(
        jnp.asarray(nodes), jnp.asarray(sel), jnp.asarray(adj),
        jnp.asarray(visited.view(np.uint32)), width)
    for name, a, b in zip(("nbrs", "safe", "fresh", "src"), got, want):
        assert a.shape == (37, width), name
        assert np.array_equal(a.numpy(), np.asarray(b)), name
    assert np.array_equal(vis.numpy().view(np.uint32), np.asarray(want[4]))
    assert int(got[2].sum()) > 0 and not bool(got[2][0].any())
    if e > 1:
        assert not np.array_equal(vis.numpy(), visited)


@pytest.mark.parametrize("backend", kops.BACKENDS)
def test_frontier_dispatch_takes_the_plain_twin_on_the_cpu(backend):
    """``kops.frontier`` on CPU tensors is the plain version under every
    backend, visited update included."""
    nodes, sel, adj, visited = (torch.from_numpy(a)
                                for a in beam_cases.frontier_inputs(5, 4, 20, 3))
    vis_a, vis_b = visited.clone(), visited.clone()
    got = kops.frontier(nodes, sel, adj, vis_a, 40, backend=backend)
    want = kref.frontier_ref(nodes, sel, adj, vis_b, 40)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(vis_a, vis_b)
    assert not kops.frontier_on_card(torch.device("cpu"), backend)


FRONTIER_CASES = {"auto": True, "pallas": True, "pallas_skip_dma": True, "jnp": False}


@pytest.mark.parametrize("backend", list(FRONTIER_CASES))
def test_frontier_kernel_decision_reads_device_and_backend(backend):
    """On a CUDA device the frontier step takes the kernel under every
    backend but ``"jnp"`` (a device object needs no card), traced or not:
    the decision reads nothing else."""
    assert kops.frontier_on_card(torch.device("cuda"), backend) is FRONTIER_CASES[backend]


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
    """Every backend of the JAX package is ported: tiered storage, the
    skip-DMA backend, the ndpsim and the sharded backends build searchers
    (their search is held against the JAX package in
    ``test_torch_tiered.py``, below, in ``test_torch_ndpsim.py`` and in
    ``test_torch_sharded*.py``), and an unknown backend raises."""
    _, _, port, *_ = pair["l2"]
    port.searcher("local", dataclasses.replace(BASE, storage="tiered"))
    port.searcher("local", dataclasses.replace(BASE, fee_backend="pallas_skip_dma"))
    port.searcher("ndpsim", BASE)
    port.searcher("sharded", BASE, n_shards=2)
    with pytest.raises(ValueError, match="unknown backend"):
        port.searcher("gpu_cluster", BASE)


@pytest.mark.parametrize("storage", ["f32", "packed"])
def test_skip_dma_search_matches_jax(pair, storage):
    """``fee_backend="pallas_skip_dma"`` against the JAX package's manual-DMA
    kernels (interpret mode, so few queries at a small ef, as
    ``tests/test_packed.py`` runs them), with this file's tolerances; within
    the port the skip-DMA kernels' contract is the default backend's, so the
    ids and distances are the same."""
    db, ref, port, *_ = pair["l2"]
    params = dataclasses.replace(BASE, ef=16, storage=storage,
                                 fee_backend="pallas_skip_dma")
    q = db.queries[:4]
    want = ref.search(q, jix.SearchParams(**dataclasses.asdict(params)))
    got = port.search(q, params)
    assert _overlap(got.ids, want.ids) >= 0.99
    for gi, gd, wi, wd in zip(got.ids, got.dists, want.ids, want.dists):
        shared = np.intersect1d(gi[gi >= 0], wi[wi >= 0])
        g = dict(zip(gi.tolist(), gd.tolist()))
        w = dict(zip(wi.tolist(), wd.tolist()))
        np.testing.assert_allclose([g[i] for i in shared], [w[i] for i in shared],
                                   rtol=RTOL, atol=ATOL)
    for key in ("hops", "n_eval", "dims"):
        assert np.mean(getattr(got, key) == getattr(want, key)) >= 0.95, key
    auto = port.search(q, dataclasses.replace(params, fee_backend="auto"))
    assert np.array_equal(got.ids, auto.ids)
    assert np.array_equal(got.dists, auto.dists)


@pytest.mark.parametrize("n_q", [0, 3])
@pytest.mark.parametrize("storage,trace", [("f32", False), ("packed", False),
                                           ("f32", True)])
def test_result_shapes_and_dtypes_match_jax(pair, storage, trace, n_q):
    """Ids, distances and counters have the reference's shapes and dtypes,
    for a batch of no queries too (the port's chunked search loop once
    raised IndexError on it, and its traced counters were int64)."""
    db, ref, port, *_ = pair["l2"]
    params = dataclasses.replace(BASE, storage=storage, trace=trace)
    want = ref.search(db.queries[:n_q], jix.SearchParams(**dataclasses.asdict(params)))
    got = port.search(db.queries[:n_q], params)
    for key in ("ids", "dists", "hops", "n_eval", "dims"):
        assert getattr(got, key).shape == np.asarray(getattr(want, key)).shape, key
        assert getattr(got, key).dtype == np.asarray(getattr(want, key)).dtype, key


# ---------------------------------------------------------------------------
# the descent over the upper levels on the device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("storage", beam_cases.STORAGES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_device_descent_equals_the_host_descent(pair, metric, storage):
    """The descent over the device levels (on the CPU, the plain version,
    reading rows through the storage's row rule) against the descent as it
    ran on the host (levels copied and mapped a call, whole levels read):
    the entries and the greedy steps bit for bit, and no level walked by
    the kernel."""
    from repro_torch import obs

    db, _, port, *_ = pair[metric]
    params = dataclasses.replace(BASE, storage=storage)
    dev = torch.device("cpu")
    q = torch.from_numpy(port.transform_queries(db.queries))
    vectors = port.device_db(params.use_dfloat, storage, dev)
    obs.enable_tracing()
    obs.tracer.clear()
    try:
        got = tsearch.descend_entry(port.device_levels(dev), vectors, storage,
                                    beam_cases.backends._dfloat_cfg(port, params), q,
                                    port.metric)
        span, = [s.attrs for s in obs.tracer.spans() if s.name == "search.descend"]
    finally:
        obs.disable_tracing()
        obs.tracer.clear()
    want, steps = beam_cases.parent_descent(port, q, params, dev)
    assert got.dtype == torch.int32 and got.device == dev
    assert np.array_equal(got.numpy(), want)
    assert span == dict(levels=len(port.graph.levels) - 1, steps=steps, kernel_levels=0)
    assert steps > span["levels"] > 0 and len(np.unique(want)) > 1


def test_device_levels_flat_layout(pair):
    """``DeviceLevels`` holds the upper levels in one flat layout: the ids
    and the adjacency end to end, bottom level first, and a table of each
    level's offsets and sizes (on the device, and as host ints) whose views
    give each level's ids and adjacency exactly as ``graph.levels[1:]``."""
    _, _, port, *_ = pair["l2"]
    ups = port.graph.levels[1:]
    levels = tsearch.DeviceLevels.of(port.graph, torch.device("cpu"))
    assert levels.entry == port.graph.entry == int(ups[-1][0][0])
    assert levels.ids.dtype == levels.adj.dtype == torch.int32
    assert levels.ids.dim() == levels.adj.dim() == 1
    assert np.array_equal(levels.ids.numpy(), np.concatenate([ids for ids, _ in ups]))
    assert np.array_equal(levels.adj.numpy(), np.concatenate([a.ravel() for _, a in ups]))
    assert levels.table.dtype == torch.int64
    assert levels.table.tolist() == [list(s) for s in levels.spans]
    i0 = a0 = 0
    for (ids, adj), span, (vi, va) in zip(ups, levels.spans, levels.levels):
        assert span == (i0, len(ids), a0, adj.shape[1])
        i0, a0 = i0 + len(ids), a0 + adj.size
        assert np.array_equal(vi.numpy(), ids) and np.array_equal(va.numpy(), adj)
        assert vi.data_ptr() == levels.ids[span[0]:].data_ptr()   # views, no copies
        assert va.data_ptr() == levels.adj[span[2]:].data_ptr()
    assert len(levels.levels) == len(ups) > 1


def test_descent_of_a_graph_without_upper_levels():
    """A graph with no upper level descends to its entry node for every
    query, with a span of no level and no step."""
    from repro_torch import obs
    from repro_torch.core.graph import GraphIndex

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((40, 8)).astype(np.float32))
    graph = GraphIndex(levels=[(np.arange(40, dtype=np.int32),
                                rng.integers(0, 40, (40, 4)).astype(np.int32))],
                       entry=7, m=4)
    levels = tsearch.DeviceLevels.of(graph, torch.device("cpu"))
    assert levels.spans == () and tuple(levels.table.shape) == (0, 4)
    obs.enable_tracing()
    obs.tracer.clear()
    try:
        got = tsearch.descend_entry(levels, x, "f32", None, x[:5], "l2")
        span, = [s.attrs for s in obs.tracer.spans() if s.name == "search.descend"]
    finally:
        obs.disable_tracing()
        obs.tracer.clear()
    assert got.tolist() == [7] * 5 and got.dtype == torch.int32
    assert span == dict(levels=0, steps=0, kernel_levels=0)



@pytest.mark.parametrize("storage", beam_cases.STORAGES)
def test_descend_dispatch_takes_the_plain_version_on_the_cpu(pair, storage):
    """``kops.descend`` and the kernel's wrapper on CPU tensors are the
    plain version (the kernel's launch count does not move, and the wrapper
    reports no level walked in the kernel), with no backend to choose.  The
    per-level moves are the plain loop's steps less one, bottom level
    first."""
    from repro_torch.kernels import descend as descend_kernel

    db, _, port, *_ = pair["ip"]
    params = dataclasses.replace(BASE, storage=storage)
    dev = torch.device("cpu")
    q = torch.from_numpy(port.transform_queries(db.queries[:50]))
    args = (port.device_levels(dev), port.device_db(params.use_dfloat, storage, dev),
            storage, beam_cases.backends._dfloat_cfg(port, params), q, port.metric)
    before = descend_kernel.descend.launches
    got = kops.descend(*args)
    assert kops.descend is descend_kernel.descend
    entries, moves, walked = got
    want_e, want_m = kref.descend_ref(*args)
    assert walked == 0 and torch.equal(entries, want_e) and torch.equal(moves, want_m)
    assert descend_kernel.descend.launches == before
    assert entries.dtype == moves.dtype == torch.int32
    assert moves.shape == (len(port.graph.levels) - 1,) and int(moves.min()) >= 0
    want, steps = beam_cases.parent_descent(port, q, params, dev)
    assert np.array_equal(entries.numpy(), want)
    assert steps == len(moves) + int(moves.sum())


def test_device_levels_are_built_once(pair, monkeypatch):
    """Two calls of a local searcher read the one ``device_levels`` of the
    index (the same tensors), the second converts no graph array, and
    ``drop_device`` releases them."""
    db, _, port, *_ = pair["l2"]
    idx = dataclasses.replace(port, _searchers={}, _device={})
    dev = torch.device("cpu")
    built, seen = [], []
    of, descend = tsearch.DeviceLevels.of, tsearch.descend_entry
    monkeypatch.setattr(tsearch.DeviceLevels, "of",
                        classmethod(lambda cls, *a: built.append(1) or of(*a)))
    monkeypatch.setattr(tsearch, "descend_entry",
                        lambda levels, *a: seen.append(levels) or descend(levels, *a))
    run = idx.searcher("local", BASE)
    first = run(db.queries)
    graph_arrays = [a for level in idx.graph.levels[1:] for a in level]
    converted = []
    for name in ("from_numpy", "as_tensor"):
        def record(x, *a, _fn=getattr(torch, name), **k):
            if isinstance(x, np.ndarray) and any(np.may_share_memory(x, g)
                                                 for g in graph_arrays):
                converted.append(x.shape)
            return _fn(x, *a, **k)
        monkeypatch.setattr(torch, name, record)
    second = run(db.queries)
    assert not converted and built == [1]
    levels = idx.device_levels(dev)
    assert len(seen) == 2 and seen[0] is seen[1] is levels
    assert len(levels.levels) == len(idx.graph.levels) - 1
    for (ids, adj), (hi, ha) in zip(levels.levels, idx.graph.levels[1:]):
        assert ids.dtype == adj.dtype == torch.int32
        assert np.array_equal(ids.numpy(), hi) and np.array_equal(adj.numpy(), ha)
    assert np.array_equal(first.ids, second.ids)
    assert np.array_equal(first.dists, second.dists)
    idx.drop_device()
    assert ("levels", str(dev)) not in idx._device
    assert idx.device_levels(dev) is not levels and built == [1, 1]


# ---------------------------------------------------------------------------
# the untraced loop's in-place step and the choice of its loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tomb", [False, True])
@pytest.mark.parametrize("storage", beam_cases.STORAGES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_in_place_step_equals_the_loop_it_replaced(pair, metric, storage, tomb):
    """The untraced loop's in-place step, run eagerly, gives the ids,
    distances and counters (hops, n_eval, dims, n_resid) of the loop it
    replaced, where each hop made a new state and the host computed the
    termination test between hops: bit for bit, on the same inputs."""
    db, _, port, _, port_dead, _ = pair[metric]
    idx = port_dead if tomb else port
    params = dataclasses.replace(BASE, storage=storage)
    args, kw = beam_cases.beam_inputs(idx, db.queries, params, torch.device("cpu"))
    got = tsearch._search_batch(*args, **kw, loop=tsearch._eager_loop)
    beam_cases.assert_same(got, beam_cases.parent_loop(*args, **kw))
    assert int(got["hops"].max()) > 0
    if tomb:
        assert args[3] is not None


@pytest.mark.parametrize("storage", beam_cases.STORAGES)
def test_untraced_hop_returns_counters_only(pair, storage):
    """The untraced hop returns its counters as one (Q, C) tensor and builds
    no trace: from the same state, hop after hop, they equal the traced
    hop's named counters and its popped-a-node test, and both hops leave the
    same state."""
    db, _, port, *_ = pair["l2"]
    params = dataclasses.replace(BASE, storage=storage)
    args, kw = beam_cases.beam_inputs(port, db.queries, params, torch.device("cpu"))
    vectors, adj, fee, tomb, q, entries = args
    cfg, dfl_cfg = kw["cfg"], kw["dfl_cfg"]
    names = tsearch.counter_names(cfg)
    assert names == (beam_cases.CNT_KEYS if storage == "tiered"
                     else beam_cases.CNT_KEYS[:2])
    n_words = -(-tsearch._lead(vectors).shape[0] // 32)
    plain = tsearch._init_state(q, entries, vectors, cfg, n_words, dfl_cfg)
    traced = tuple(t.clone() for t in plain)
    popped = 0
    for _ in range(6):
        plain, cnt = tsearch._hop_body(plain, vectors, adj, q, fee, cfg, dfl_cfg, tomb)
        traced, t = tsearch._hop_body(traced, vectors, adj, q, fee, cfg, dfl_cfg,
                                      tomb, trace=True)
        assert isinstance(cnt, torch.Tensor) and cnt.shape == (len(q), len(names) + 1)
        assert set(t) == {"node", "nbrs", "segs", "cand_d", "src", *names}
        want = torch.stack([t[k] for k in names]
                           + [(t["node"] >= 0).any(1).to(torch.int32)], dim=1)
        assert torch.equal(cnt, want.to(cnt.dtype))
        for a, b in zip(plain, traced):
            assert torch.equal(a, b)
        popped += int(cnt[:, -1].sum())
    assert popped > 0 and int(cnt[:, 0].sum()) >= 0


CAPTURE_CASES = {          # (device, SearchConfig fields, trace) -> captures
    "cuda": ("cuda", {}, False, True),
    "cuda-skip-dma": ("cuda", dict(fee_backend="pallas_skip_dma"), False, True),
    "cuda-no-fee": ("cuda", dict(use_fee=False, storage="packed"), False, True),
    "cpu": ("cpu", {}, False, False),
    "cuda-trace": ("cuda", {}, True, False),
    "cuda-jnp": ("cuda", dict(fee_backend="jnp"), False, False),
}


@pytest.mark.parametrize("case", list(CAPTURE_CASES))
def test_capture_decision_reads_device_trace_and_backend(case):
    """The hop is captured as a CUDA graph only for CUDA tensors, on the
    untraced path, with the port's kernels: never on the CPU, for
    ``trace=True`` or for the plain ``"jnp"`` backend (a device object
    needs no card)."""
    dev, fields, trace, want = CAPTURE_CASES[case]
    cfg = tsearch.SearchConfig(**fields)
    assert tsearch._captures(torch.device(dev), cfg, trace) is want


@pytest.mark.parametrize("trace", [False, True])
def test_graph_hops_is_zero_on_the_cpu(pair, trace):
    """On the CPU every ``search.beam`` span reports ``graph_hops`` 0 beside
    its ``hops`` (the loop's iterations: the most hops a query took)."""
    from repro_torch import obs

    db, _, port, *_ = pair["l2"]
    obs.enable_tracing()
    obs.tracer.clear()
    try:
        res = port.search(db.queries, dataclasses.replace(BASE, trace=trace))
        beams = [s.attrs for s in obs.tracer.spans() if s.name == "search.beam"]
    finally:
        obs.disable_tracing()
        obs.tracer.clear()
    assert len(beams) == 1 and beams[0]["graph_hops"] == 0
    want = BASE.to_config(port.metric, port.seg).hops() if trace else int(res.hops.max())
    assert beams[0]["hops"] == want


@pytest.mark.parametrize("backend", ["auto", "jnp"])
@pytest.mark.parametrize("trace", [False, True])
def test_frontier_hops_is_zero_on_the_cpu(pair, trace, backend):
    """On the CPU every ``search.beam`` span reports ``frontier_hops`` 0
    beside its ``hops``: the frontier step ran its plain version."""
    from repro_torch import obs

    db, _, port, *_ = pair["l2"]
    obs.enable_tracing()
    obs.tracer.clear()
    try:
        port.search(db.queries[:16], dataclasses.replace(BASE, trace=trace,
                                                         fee_backend=backend))
        beams = [s.attrs for s in obs.tracer.spans() if s.name == "search.beam"]
    finally:
        obs.disable_tracing()
        obs.tracer.clear()
    assert len(beams) == 1 and beams[0]["hops"] > 0
    assert beams[0]["frontier_hops"] == 0


def test_collector_pause_nests_and_restores():
    """The capture's pause of the garbage collector nests (overlapping
    captures) and restores the collector's state as it found it."""
    import gc

    pause = tsearch._CollectorPause()
    assert gc.isenabled()
    with pause:
        assert not gc.isenabled()
        with pause:
            assert not gc.isenabled()
        assert not gc.isenabled()
    assert gc.isenabled()
    gc.disable()
    try:
        with pause:
            assert not gc.isenabled()
        assert not gc.isenabled()
    finally:
        gc.enable()


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("storage", beam_cases.STORAGES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_query_chunks_equal_one_chunk(pair, metric, storage, trace, monkeypatch):
    """A visited-bitmap budget of 21 queries splits a call of 64 into four
    chunks (21, 21, 21, 1), searched one after another: ids, distances,
    counters and the trace equal one chunk's bit for bit; the call's
    ``search.call`` span holds four ``search.beam`` spans, each with its
    chunk's bitmap in ``visited_bytes``."""
    from repro_torch import obs
    from repro_torch.index import backends

    db, _, port, *_ = pair[metric]
    params = dataclasses.replace(BASE, storage=storage, trace=trace)
    cpu = torch.device("cpu")
    n_q, n_words = len(db.queries), -(-port.n // 32)
    chunk = (n_q - 1) // 3
    whole = backends.local_searcher(port, params, device=cpu)
    assert n_q <= tsearch._VISITED_BYTES // (4 * n_words)       # one chunk
    want = whole(db.queries)
    monkeypatch.setattr(tsearch, "_VISITED_BYTES", 4 * n_words * chunk)
    obs.enable_tracing()
    obs.tracer.clear()
    try:
        got = backends.local_searcher(port, params, device=cpu)(db.queries)
        spans = obs.tracer.spans()
    finally:
        obs.disable_tracing()
        obs.tracer.clear()
    for f in ("ids", "dists", "hops", "n_eval", "dims", "n_resid"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None) and (a is None or (
            a.dtype == b.dtype and np.array_equal(a, b))), f
    if trace:
        assert set(got.trace) == set(want.trace)
        for k in want.trace:
            assert np.array_equal(got.trace[k], want.trace[k]), k
    call, = [s for s in spans if s.name == "search.call"]
    beams = [s.attrs for s in spans if s.name == "search.beam"
             and call.t0_ns <= s.t0_ns <= call.t0_ns + call.dur_ns]
    assert [b["q"] for b in beams] == [chunk] * 3 + [n_q - 3 * chunk]
    assert [b["visited_bytes"] for b in beams] == [4 * n_words * b["q"] for b in beams]


def test_empty_call_is_one_chunk(pair):
    """A call of no queries is one chunk of none: one beam span of no
    bitmap."""
    from repro_torch import obs
    from repro_torch.index import backends

    db, _, port, *_ = pair["l2"]
    obs.enable_tracing()
    obs.tracer.clear()
    try:
        res = backends.local_searcher(port, BASE, device=torch.device("cpu"))(db.queries[:0])
        spans = obs.tracer.spans()
    finally:
        obs.disable_tracing()
        obs.tracer.clear()
    assert res.ids.shape == (0, BASE.k)
    assert [s.name for s in spans].count("search.call") == 1
    assert [s.attrs["visited_bytes"] for s in spans if s.name == "search.beam"] == [0]
