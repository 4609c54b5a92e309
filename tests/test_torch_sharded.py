"""The port's query-owner sharded search against its local search and the
JAX package's, in process on the CPU.

The JAX package builds the unit indexes (a Dfloat layout, so packed rows
are not the fp32 ones) and the port reads the same artifact through
``convert.from_arrays``, as in ``tests/test_torch_search.py``.

Tolerances: within the port the sharded search at ``compact=1.0`` must give
the local search's ids, distances and hops bit for bit (``LocalShards``, C
in {1, 2, 4, 8}).  Against the JAX package's local search at
``compact=1.0`` (the reference makes its sharded search bit-identical to
that) the file's tolerances hold: mean id overlap@10 >= 0.99 and distances
of shared ids within rtol 3e-5 / atol 2e-4 (the packages sum a segment's
distance in different orders).  FEE outputs are held by
``repro_torch.kernels.check``; the DaM layout, the ownership of a
``ShardedMutableIndex`` and ``collective_payload`` must equal the
reference's exactly.
"""
import dataclasses
import json
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.index as jix
from fee_cases import inputs
from repro.core import dfloat as jdfl
from repro.core import graph as jgraph
from repro.core import search as jsearch
from repro.core.search import SearchConfig as JaxSearchConfig
from repro.data.synthetic import VecDB as JaxVecDB
from repro.distributed import retrieval as jrt
from repro.kernels import ops as jops
from repro.streaming import ShardedMutableIndex as JaxShardedMutableIndex
from repro_torch.core import dfloat as dfl
from repro_torch.core import graph as tgraph
from repro_torch.core import search as tsearch
from repro_torch.data.synthetic import DATASETS, _generate
from repro_torch.distributed import LocalShards
from repro_torch.distributed import retrieval as trt
from repro_torch.index import Index, SearchParams, from_arrays
from repro_torch.kernels import ops
from repro_torch.kernels.check import ATOL, RTOL, compare_fee, near_threshold
from repro_torch.streaming import ShardedMutableIndex

BASE = SearchParams(ef=48, k=10, expand=4, compact=1.0)
N_Q = 32
OVERLAP = 0.99


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU operations: run them on one thread, so that they
    neither wait on a pool nor crowd the other test processes (restored
    afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _tombstone(n, seed):
    rng = np.random.default_rng(seed)
    dead = rng.choice(n, n // 20, replace=False)
    words = np.zeros(-(-n // 32), np.uint32)
    np.bitwise_or.at(words, dead >> 5, np.uint32(1) << (dead & 31).astype(np.uint32))
    return words, dead


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """{metric: (db, {tomb: (jax index, port index)}, dead ids)} over one
    JAX-built index per metric, and the same index with 5% of its rows
    tombstoned."""
    out = {}
    for metric, name in (("l2", "unit"), ("ip", "unit_ip")):
        db = _unit(name)
        spec = jix.IndexSpec.for_db(db, m=8, dfloat_recall_target=0.8,
                                    dfloat_proxy=True)
        ref = jix.Index.build(db, spec, cache_key=f"torch-parity/{name}/"
                              f"{zlib.crc32(db.vectors.tobytes())}")
        path = tmp_path_factory.mktemp(f"jax_{name}")
        ref.save(path)
        meta = json.loads((path / "spec.json").read_text())
        with np.load(path / "arrays.npz") as z:
            arrays = {k: z[k] for k in z.files}
        tomb, dead = _tombstone(db.n, 7)
        ref_dead = jix.Index.load(path)
        ref_dead.tombstone = tomb
        out[metric] = (db, {False: (ref, from_arrays(meta, arrays, "cpu")),
                            True: (ref_dead, from_arrays(
                                meta, {**arrays, "tombstone": tomb}, "cpu"))}, dead)
    return out


# -- fee_distance_stale -------------------------------------------------------

def _stale_case(storage, metric, seed):
    """One query's lanes in both packages' forms: the JAX arguments (q (D,),
    rows, layouts) and the port's (db, (1, C) ids, (1, D) query, layouts),
    with the rows the lanes decode to."""
    c, d, seg = 96, 64, 16
    q, x, thr, alpha, beta, margin = inputs(c, d, seg, metric, seed)
    if storage == "f32":
        jx, jcfg, tx, cfg, rows = x, None, torch.from_numpy(x), None, x
    else:
        runs = [(16, 5, d // 2), (12, 4, d - d // 2)]
        jlay, lay = jdfl.make_config(d, runs, x), dfl.make_config(d, runs, x)
        packed = jdfl.pack_db(x, jlay)
        rows = jdfl.unpack_db(packed, jlay)
        if storage == "packed":
            jx, jcfg = packed, jlay
            tx, cfg = torch.from_numpy(packed.view(np.int32)), lay
        else:
            jcfg = jdfl.split_config(jlay, 2 * seg)
            cfg = dfl.split_config(lay, 2 * seg)
            jx = jdfl.pack_tiers(x, jlay, 2 * seg)
            tx = tuple(torch.from_numpy(t.view(np.int32))
                       for t in dfl.pack_tiers(x, lay, 2 * seg))
    return (q, rows, thr, alpha, beta, margin, seg, jx, jcfg, tx, cfg)


def _stale_both(case, metric, exit_thr, admit_thr):
    q, rows, _, alpha, beta, margin, seg, jx, jcfg, tx, cfg = case
    want = jops.fee_distance_stale(
        jnp.asarray(q), jx, jnp.float32(exit_thr), jnp.float32(admit_thr),
        jnp.asarray(alpha), jnp.asarray(beta), jnp.asarray(margin), seg=seg,
        metric=metric, dfloat_cfg=jcfg)
    ids = torch.arange(rows.shape[0], dtype=torch.int32)[None]
    got = ops.fee_distance_stale(
        tx, ids, torch.from_numpy(q)[None], torch.tensor([exit_thr]),
        torch.tensor([admit_thr]), *(torch.from_numpy(a) for a in (alpha, beta, margin)),
        seg=seg, metric=metric, dfloat_cfg=cfg)
    return [t.numpy()[0] for t in got], [np.asarray(t) for t in want]


@pytest.mark.parametrize("storage", ["f32", "packed", "tiered"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_fee_distance_stale_matches_jax(storage, metric):
    """The port's ``fee_distance_stale`` against the JAX package's on the
    same lanes, at a fresh and at stale exit thresholds: ``admit`` and
    ``segs_used`` equal except near a threshold, distances within the
    tolerance."""
    case = _stale_case(storage, metric, 11)
    q, rows, thr, alpha, beta, margin, seg = case[:7]
    admit_thr = thr
    for exit_thr in (thr, thr + abs(thr) * 0.5, 3.0e38):
        got, want = _stale_both(case, metric, exit_thr, admit_thr)
        near = near_threshold(rows, q, np.float32(exit_thr), alpha, beta, margin,
                              seg=seg, metric=metric).numpy()
        near |= np.abs(want[0] - admit_thr) <= ATOL + RTOL * abs(admit_thr)
        compare_fee((got[0], ~got[1], got[2]), (want[0], ~want[1], want[2]), near,
                    f"fee_distance_stale {storage}")


def _port_fee_args(seed, metric="l2"):
    q, x, thr, alpha, beta, margin = inputs(96, 64, 16, metric, seed)
    t = [torch.from_numpy(a) for a in (x, q[None], alpha, beta, margin)]
    ids = torch.arange(96, dtype=torch.int32)[None]
    exact = ((x - q) ** 2).sum(-1)
    return t, ids, exact


def test_stale_exit_admits_superset():
    """Exiting against a stale (>=) threshold only admits more lanes, and
    with no exit the admitted lanes are exactly those under the admit
    threshold, with their full distances (``tests/test_sharded.py``'s
    property, on the port)."""
    (x, q, alpha, beta, margin), ids, exact = _port_fee_args(0)
    fresh = float(np.quantile(exact, 0.3))
    admit = float(np.quantile(exact, 0.6))
    stale = lambda e: ops.fee_distance_stale(
        x, ids, q, torch.tensor([e]), torch.tensor([admit]), alpha, beta, margin,
        seg=16)
    a_fresh = stale(fresh)[1].numpy()
    for e in (fresh * 1.5, fresh * 4.0, 3.0e38):
        a_stale = stale(e)[1].numpy()
        assert (a_stale | ~a_fresh).all(), "stale exit dropped a fresh-admitted lane"
    d_s, a_s, _ = (t.numpy()[0] for t in stale(3.0e38))
    assert np.array_equal(a_s, exact < admit)
    np.testing.assert_allclose(d_s[a_s], exact[a_s], rtol=1e-5)


def test_stale_equal_thresholds_match_sync_path():
    """``fee_distance_stale(thr, thr)`` is ``fee_distance`` plus the
    ``dist < thr`` filter, bit for bit."""
    (x, q, alpha, beta, margin), ids, exact = _port_fee_args(1)
    thr = torch.tensor([float(np.quantile(exact, 0.5))])
    d0, rej, s0 = ops.fee_distance(x, ids, q, thr, alpha, beta, margin, seg=16)
    d1, adm, s1 = ops.fee_distance_stale(x, ids, q, thr, thr, alpha, beta, margin,
                                         seg=16)
    assert torch.equal(d0, d1) and torch.equal(s0, s1)
    assert torch.equal(adm, ~rej & (d0 < thr[:, None]))


# -- local_topk_reduce --------------------------------------------------------

@pytest.mark.parametrize("r", [1, 7, 40])
def test_local_topk_reduce_matches_jax_with_ties(r):
    """The shard-local top-r against the JAX package's, row by row, on
    distances drawn from a few values (ties everywhere) with BIG lanes."""
    rng = np.random.default_rng(r)
    d = rng.integers(0, 5, (6, 40)).astype(np.float32)
    d[rng.random(d.shape) < 0.3] = 3.0e38
    ids = np.where(d < 3.0e38, rng.integers(0, 1000, d.shape), -1).astype(np.int32)
    got_ids, got_d = tsearch.local_topk_reduce(torch.from_numpy(ids),
                                               torch.from_numpy(d), r)
    for i in range(len(d)):
        want_ids, want_d = jsearch.local_topk_reduce(jnp.asarray(ids[i]),
                                                     jnp.asarray(d[i]), r)
        assert np.array_equal(got_ids[i].numpy(), np.asarray(want_ids))
        assert np.array_equal(got_d[i].numpy(), np.asarray(want_d))


# -- the device layout and the payload model ----------------------------------

def _dam(index, c):
    owner = tgraph.map_owners(index.n, c, "shuffle", seed=0)
    return (tgraph.build_dam(index.graph.base_adjacency, owner, c),
            jgraph.build_dam(index.graph.base_adjacency, owner, c))


@pytest.mark.parametrize("storage", ["f32", "packed", "tiered"])
@pytest.mark.parametrize("c", [2, 4])
def test_build_sharded_db_matches_jax(pair, storage, c):
    """Every array of ``build_sharded_db`` (row shards of each storage, the
    tier pair, local ids, partitions, per-shard tombstone words) equals the
    reference's, words compared through a uint32 view."""
    _, idx, _ = pair["l2"]
    ref, port = idx[True]
    dam, jdam = _dam(port, c)
    if storage == "f32":
        vec, jvec = port.db_q, ref.db_q
    elif storage == "packed":
        vec, jvec = port.db_packed, ref.db_packed
    else:
        vec, jvec = port.tier_arrays(), ref.tier_arrays()
    got = trt.build_sharded_db(vec, dam, tombstone=port.tombstone, device="cpu")
    want = jrt.build_sharded_db(jvec, jdam, tombstone=ref.tombstone)
    as_np = lambda t: (t.numpy().view(np.uint32) if t.dtype == torch.int32
                       else t.numpy())
    pairs = (list(zip(got.vectors, want.vectors)) if storage == "tiered"
             else [(got.vectors, want.vectors)])
    pairs += [(got.local_ids, want.local_ids), (got.part_adj, want.part_adj),
              (got.tombstone, want.tombstone)]
    for g, w in pairs:
        w = np.asarray(w)
        g = as_np(g) if w.dtype != np.int32 else g.numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # one rank's shard of the same layout
    one = trt.build_sharded_db(vec, dam, tombstone=port.tombstone, shards=(1,),
                               device="cpu")
    assert torch.equal(one.local_ids[0], got.local_ids[1])
    assert torch.equal(one.tombstone[0], got.tombstone[1])


@pytest.mark.parametrize("c", [1, 4, 8])
@pytest.mark.parametrize("expand,compact", [(4, 0.5), (4, 1.0), (1, 0.5), (8, 0.25)])
def test_collective_payload_matches_jax(c, expand, compact):
    cfg = tsearch.SearchConfig(ef=48, expand=expand, compact=compact)
    jcfg = JaxSearchConfig(ef=48, expand=expand, compact=compact)
    for mc in (3, 10, 16):
        assert trt.collective_payload(cfg, mc, c) == jrt.collective_payload(jcfg, mc, c)


# -- the sharded search -------------------------------------------------------

def _jax_local(pair, metric, tomb, fields, _cache={}):
    """The JAX package's local search of the first N_Q queries (cached per
    case across the parametrized tests)."""
    key = (metric, tomb, tuple(sorted(fields.items())))
    if key not in _cache:
        db, idx, _ = pair[metric]
        params = jix.SearchParams(**dataclasses.asdict(
            dataclasses.replace(BASE, **fields)))
        _cache[key] = idx[tomb][0].search(db.queries[:N_Q], params)
    return _cache[key]


def _shared_dists_close(got, want):
    """Distances of the ids both results hold, within the tolerance."""
    for gi, gd, wi, wd in zip(got.ids, got.dists, want.ids, want.dists):
        shared = np.intersect1d(gi[gi >= 0], wi[wi >= 0])
        a = gd[[gi.tolist().index(s) for s in shared]]
        b = wd[[wi.tolist().index(s) for s in shared]]
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("c", [1, 2, 4, 8])
@pytest.mark.parametrize("storage", ["f32", "packed", "tiered"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_sharded_bit_identical_to_local(pair, metric, storage, c):
    """At ``compact=1.0`` the port's sharded search equals its local search
    bit for bit (ids, distances, hops) at expand 4 and 1 and over the
    tombstoned index (no dead id), and is held to the JAX package's local
    search with this file's tolerances."""
    db, idx, dead = pair[metric]
    q = db.queries[:N_Q]
    for expand, tomb in ((4, False), (1, False), (4, True)):
        port = idx[tomb][1]
        fields = dict(storage=storage, expand=expand)
        params = dataclasses.replace(BASE, **fields)
        want = port.searcher("local", params)(q)
        run = port.searcher("sharded", params, n_shards=c)
        got = run(q)
        assert np.array_equal(got.ids, want.ids), (expand, tomb)
        assert np.array_equal(got.dists, want.dists), (expand, tomb)
        assert np.array_equal(got.hops, want.hops), (expand, tomb)
        if tomb:
            assert not np.isin(got.ids, dead).any()
        ref = _jax_local(pair, metric, tomb, fields)
        assert _overlap(got.ids, ref.ids) >= OVERLAP, (expand, tomb)
        _shared_dists_close(got, ref)
        assert run.payload["n_shards"] == c


def test_sharded_pads_and_chunks_queries(pair):
    """Query counts that are not a multiple of C (padded with the first
    query, cut back) and an empty batch."""
    db, idx, _ = pair["l2"]
    port = idx[False][1]
    want = port.searcher("local", BASE)(db.queries[:13])
    got = port.searcher("sharded", BASE, n_shards=4)(db.queries[:13])
    assert np.array_equal(got.ids, want.ids) and np.array_equal(got.dists, want.dists)
    empty = port.searcher("sharded", BASE, n_shards=4)(db.queries[:0])
    assert empty.ids.shape == (0, BASE.k) and empty.dists.shape == (0, BASE.k)


def test_sharded_options_raise(pair):
    """``trace=True`` and a JAX ``mesh=`` raise; the device defaults to
    ``"cuda"`` and raises without a card."""
    _, idx, _ = pair["l2"]
    port = idx[False][1]
    with pytest.raises(ValueError, match="traces"):
        port.searcher("sharded", dataclasses.replace(BASE, trace=True))
    with pytest.raises(TypeError, match="n_shards"):
        port.searcher("sharded", BASE, mesh=object())
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda default does not raise")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.searcher("sharded", BASE, device="cuda")
    dam, _ = _dam(port, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trt.build_sharded_db(port.db_rot, dam)
    from repro_torch.launch import search as search_cli

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        search_cli.main(["--dataset", "unit", "--backend", "sharded"])


def test_make_sharded_searcher_direct(pair):
    """The searcher on a hand-built layout: ``n_total`` and the shard count
    are checked against the db, and a tombstone flag needs tombstone words."""
    _, idx, _ = pair["l2"]
    port = idx[False][1]
    cfg = BASE.to_config(port.metric, port.seg)
    dam, _ = _dam(port, 4)
    sdb = trt.build_sharded_db(port.db_rot, dam, device="cpu")
    fee = port.fee.params("cpu")
    with pytest.raises(ValueError, match="nodes"):
        trt.make_sharded_searcher(LocalShards(4), cfg, port.n + 1, fee)(
            sdb, np.zeros((4, port.dim), np.float32), np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="shards"):
        trt.make_sharded_searcher(LocalShards(2), cfg, port.n, fee)(
            sdb, np.zeros((4, port.dim), np.float32), np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="tombstone"):
        trt.make_sharded_searcher(LocalShards(4), cfg, port.n, fee, tombstone=True)(
            sdb, np.zeros((4, port.dim), np.float32), np.zeros(4, np.int32))


# -- ShardedMutableIndex and the DaM of a mutable snapshot ---------------------

@pytest.fixture(scope="module")
def churned(pair, tmp_path_factory):
    """The same appends and deletes on both packages' ShardedMutableIndex
    over the l2 unit index (the port's loaded from the reference's save)."""
    db, idx, _ = pair["l2"]
    ref = idx[False][0]
    path = ref.save(tmp_path_factory.mktemp("jax_base"))
    jsm = JaxShardedMutableIndex(jix.Index.load(path), 4, ef_build=32, sub_batch=64)
    tsm = ShardedMutableIndex(Index.load(path, device="cpu"), 4, ef_build=32,
                              sub_batch=64)
    rng = np.random.default_rng(0)
    new = db.vectors[rng.integers(0, db.n, 64)] + 0.05 * rng.standard_normal(
        (64, db.dim)).astype(np.float32)
    dead = rng.choice(db.n, 150, replace=False)
    before = tsm.owner_of(np.arange(db.n)).copy()
    appended = [sm.append(new) for sm in (jsm, tsm)]
    for sm in (jsm, tsm):
        sm.delete(dead)
    assert np.array_equal(*appended)
    assert np.array_equal(tsm.owner_of(np.arange(db.n)), before)   # no migration
    return db, jsm, tsm, appended[1], dead


def test_sharded_mutable_owners_loads_words_match_jax(churned):
    """``owner_of``, ``shard_load`` and ``touched_words`` equal the
    reference's after the same appends and deletes; existing rows never
    migrate and each id's visibility flip dirties one word of one shard."""
    db, jsm, tsm, new_ids, dead = churned
    every = np.arange(tsm.mutable.capacity)
    assert np.array_equal(tsm.owner_of(every), jsm.owner_of(every))
    assert np.array_equal(tsm.shard_load(), jsm.shard_load())
    probe = np.concatenate([new_ids, dead[:40], np.arange(0, db.n, 97)])
    got, want = tsm.touched_words(probe), jsm.touched_words(probe)
    assert got.keys() == want.keys()
    for c in want:
        assert np.array_equal(got[c], want[c])
    for i in new_ids[:8].tolist():
        (shard, words), = tsm.touched_words([i]).items()
        assert shard == int(tsm.owner_of([i])[0]) and len(words) == 1


@pytest.mark.parametrize("overlap", [False, True])
def test_sharded_mutable_search_equals_local_on_snapshot(churned, overlap):
    """The tombstoned sharded search of a churned index equals the port's
    local search on its snapshot (sync: bit for bit; overlap: id overlap
    >= 0.99), with no dead id; the searcher is cached per generation."""
    db, _, tsm, _, dead = churned
    q = db.queries[:N_Q]
    snap = tsm.freeze()
    want = snap.searcher("local", BASE)(q)
    run = tsm.searcher(BASE, overlap=overlap)
    got = run(q)
    assert run is tsm.searcher(BASE, overlap=overlap)
    assert not np.isin(got.ids, dead).any()
    assert got.generation == snap.generation
    if overlap:
        assert _overlap(got.ids, want.ids) >= OVERLAP
    else:
        assert np.array_equal(got.ids, want.ids) and np.array_equal(got.dists, want.dists)


def test_build_dam_maps_padding_to_the_last_row_like_jax(churned):
    """A mutable snapshot's reserved capacity rows are whole rows of -1
    pads.  ``build_dam`` indexes ``owner[adj]`` and ``local_of[adj]``
    without masking them, so every pad becomes the slot of row ``n - 1`` in
    its owner's partition, in the reference as in the port.  Row ``n - 1``
    is a dead reserved slot, so no result changes (the sharded search
    above equals the local one)."""
    _, _, tsm, _, _ = churned
    snap = tsm.freeze()
    adj, n = snap.graph.base_adjacency, snap.n
    pad_rows = np.nonzero((adj < 0).any(1))[0]
    assert len(pad_rows) > 0
    owner = tsm.owner_of(np.arange(n))
    dam = tgraph.build_dam(adj, owner, 4)
    jdam = jgraph.build_dam(adj, owner, 4)
    for c in range(4):
        assert np.array_equal(dam.part_adj[c], jdam.part_adj[c])
    last = dam.part_adj[owner[n - 1]][pad_rows]
    assert (last == dam.local_of[n - 1]).any(1).all()
    tomb = snap.tombstone.view(np.uint32)
    assert (tomb[(n - 1) >> 5] >> np.uint32((n - 1) & 31)) & 1
