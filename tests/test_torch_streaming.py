"""The port's streaming mutation (``repro_torch.streaming``) vs the JAX
package's.

Each metric's reference unit index (``tests/conftest.py``), and a
tier-native L2 index with compressed Dfloat rows, is carried into the port
through its artifact (``Index.load(ref.save(...), device="cpu")``),
and one seeded op sequence of appends, deletes and searches runs in both
packages.  The mutation logic is host numpy in both, so the capacity rows
(``_rot``, ``_packed``), the tombstones and the counters must be equal bit
for bit; the candidate search takes its distances in torch here and in jnp
there, so the adjacency may differ only at near-ties: >= 99% of rows equal
(the build's tolerance, ``tests/test_torch_index.py``), search ids overlap
>= 0.99.  A WAL written by either package replays in the other, and gives
that package's own live arrays.

The cases of ``tests/test_streaming.py`` are restated on the port: churn
recall within 1 point of a fresh build over the survivors, tombstones never
in results (``local`` and ``ndpsim``; the sharded backend is not ported),
packed equal to f32, bit-identical WAL replay, snapshot isolation, capacity
doubling, lazy and idempotent deletes, and the guards.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.index as jix
from repro.index import index as jindex_mod
from repro.streaming import MutableIndex as JMutableIndex
from repro_torch.core import dfloat as dfl
from repro_torch.data.synthetic import VecDB, exact_topk, recall_at_k
from repro_torch.index import Index, IndexSpec, SearchParams
from repro_torch.index import index as index_mod
from repro_torch.streaming import MutableIndex

EF = 64
K = 10
BIG = 3.0e38
ADJ_ROWS = 0.99          # share of adjacency rows that must agree across packages
OVERLAP = 0.99


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work here is many small operations: run them on one
    thread, so that they neither wait on a pool nor crowd the other test
    processes (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _overlap(a, b, k=K):
    return float(np.mean([len(set(x.tolist()) & set(y.tolist())) / k
                          for x, y in zip(a, b)]))


def _jparams(params):
    return jix.SearchParams(**dataclasses.asdict(params))


@pytest.fixture(scope="module")
def carried(unit_db, unit_ip_db, unit_index, unit_ip_index, tmp_path_factory):
    """{case: (db, reference index, port index)}: each metric's f32 unit
    index, and a tier-native L2 one (compressed Dfloat, ``tier_split=2``)
    whose appends write packed rows and both tiers in place."""
    tiered = jix.Index.build(unit_db, jix.IndexSpec.for_db(
        unit_db, m=8, dfloat_recall_target=0.8, ef_fit=32, tier_split=2))
    out = {}
    for case, db, ref in (("l2", unit_db, unit_index),
                          ("ip", unit_ip_db, unit_ip_index),
                          ("l2_tiered", unit_db, tiered)):
        path = ref.save(tmp_path_factory.mktemp(f"base_{case}") / "i.naszip")
        out[case] = (db, ref, Index.load(path, device="cpu"))
    return out


def _churn(db, index, mutable_cls, params_cls, seed=0, frac=0.10, searches=2,
           **kw):
    """Random interleaving of append/delete/search ops (the reference test's
    sequence), ending in a freeze so no repair is pending; returns the
    mutated index and the id bookkeeping."""
    mi = mutable_cls(index, ef_build=64, sub_batch=64, **kw)
    rng = np.random.default_rng(seed)
    n_app = n_del = int(db.n * frac)
    app_chunks = np.array_split(rng.integers(0, db.n, n_app), 4)
    dead_pool = rng.choice(db.n, n_del, replace=False)
    del_chunks = np.array_split(dead_pool, 4)
    ops = (["append"] * len(app_chunks) + ["delete"] * len(del_chunks)
           + ["search"] * searches)
    rng.shuffle(ops)
    new_ids = []
    ai = di = 0
    for op in ops:
        if op == "append":
            src = app_chunks[ai]
            ai += 1
            noise = 0.05 * rng.standard_normal(
                (len(src), db.dim)).astype(np.float32)
            vecs = db.vectors[src] + noise
            if db.metric == "ip":
                vecs /= np.linalg.norm(vecs, axis=1, keepdims=True) + 1e-9
            new_ids.append(mi.append(vecs))
        elif op == "delete":
            mi.delete(del_chunks[di])
            di += 1
        else:
            mi.search(db.queries[:8], params_cls(ef=32, k=K, use_dfloat=False))
    mi.freeze()
    return mi, np.concatenate(new_ids), dead_pool


# MutableIndex options of each case: the tier-native one reserves 5% of the
# rows, so that its 10% of appends grow the capacity (and both tiers with it)
# during the churn; a WAL replays under the same options
CHURN_KW = dict(l2={}, ip={}, l2_tiered=dict(reserve=0.05))


@pytest.fixture(scope="module", params=["l2", "ip", "l2_tiered"])
def churned(request, carried, tmp_path_factory):
    """The same churn in both packages, each WAL saved once."""
    db, ref, port = carried[request.param]
    kw = CHURN_KW[request.param]
    mi, new_ids, dead = _churn(db, port, MutableIndex, SearchParams, seed=3,
                               **kw)
    jmi, _, _ = _churn(db, ref, JMutableIndex, jix.SearchParams, seed=3, **kw)
    if port.spec.tier_split is not None:
        assert mi.capacity > int(port.n * 1.05) and mi._coarse is not None
    tmp = tmp_path_factory.mktemp(f"wal_{request.param}")
    port_wal = mi.save_delta(tmp / "port.naszip")
    jax_wal = jmi.save_delta(tmp / "jax.naszip")
    surv = mi.alive_ids()
    gt = surv[exact_topk(mi._rot[surv], mi.spca.transform(db.queries), K,
                         db.metric, device="cpu")]
    return dict(db=db, mi=mi, jmi=jmi, new_ids=new_ids, dead=dead, surv=surv,
                gt=gt, port_wal=port_wal, jax_wal=jax_wal, kw=kw)


def _assert_same_arrays(a, b, adj_rows=1.0):
    """Capacity rows, tombstones and tiers bit-equal; adjacency rows equal on
    at least ``adj_rows`` of the allocated rows."""
    assert a.n == b.n and a.capacity == b.capacity
    for f in ("_rot", "_packed", "_dead"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    for f in ("_coarse", "_resid"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None) and (x is None or np.array_equal(x, y)), f
    eq = (a._adj[: a.n] == b._adj[: b.n]).all(1).mean()
    assert eq >= adj_rows, eq


# ---------------------------------------------------------------------------
# the reference's cases, restated on the port
# ---------------------------------------------------------------------------
def test_churn_recall_within_1pt_of_rebuild(churned):
    """10% appends + 10% deletes, recall@10 within 1pt of a fresh port build
    over the surviving rows at equal ef."""
    c = churned
    db, mi, surv, gt = c["db"], c["mi"], c["surv"], c["gt"]
    params = SearchParams(ef=EF, k=K, use_dfloat=False)
    rec = recall_at_k(mi.search(db.queries, params).ids, gt, K)
    # rebuild over the *same* surviving rows, in stable-id order; appended
    # rows only exist rotated — invert the (orthogonal) sPCA rotation
    raw = np.empty((len(surv), db.dim), np.float32)
    base_mask = surv < db.n
    raw[base_mask] = db.vectors[surv[base_mask]]
    raw[~base_mask] = (mi._rot[surv[~base_mask]]
                       @ mi.spca.components.T.astype(np.float32)
                       + mi.spca.mean.astype(np.float32))
    db2 = VecDB(f"{db.name}-surv", raw, db.queries, db.train_queries,
                db.metric, db.gt)
    idx2 = Index.build(db2, IndexSpec.for_db(db2, m=8,
                                             dfloat_recall_target=None),
                       device="cpu")
    rec2 = recall_at_k(surv[idx2.search(db.queries, params).ids], gt, K)
    assert rec >= rec2 - 0.01, (rec, rec2)
    assert rec >= 0.9, rec


def test_churn_tombstones_never_in_results_all_backends(churned):
    c = churned
    db, mi = c["db"], c["mi"]
    params = SearchParams(ef=EF, k=K, use_dfloat=False)
    frozen = mi.freeze()
    runs = dict(local=frozen.searcher("local", params),
                ndpsim=frozen.searcher("ndpsim", params))
    all_dead = np.nonzero(mi._dead[: mi.capacity])[0]
    results = {}
    for name, run in runs.items():
        res = run(db.queries[:64])
        assert not np.isin(res.ids, all_dead).any(), name
        assert res.generation == mi.generation, name
        results[name] = res.ids
    assert _overlap(results["ndpsim"], results["local"]) >= 0.9
    # the ndpsim snapshot carries the write-burst accounting
    sim = runs["ndpsim"](db.queries[:16]).sim
    assert sim.writes is not None and sim.writes.rows_appended == len(c["new_ids"])


def test_churn_packed_bitstream_identical_to_f32(churned):
    db, mi = churned["db"], churned["mi"]
    a = mi.search(db.queries, SearchParams(ef=48, k=K, storage="f32",
                                           use_dfloat=True))
    b = mi.search(db.queries, SearchParams(ef=48, k=K, storage="packed"))
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.dists, b.dists)


def test_delta_log_replay_bit_identical(churned):
    """save_delta -> load -> replay reproduces arrays and results exactly."""
    db, mi = churned["db"], churned["mi"]
    m2 = MutableIndex.load(churned["port_wal"], device="cpu", **churned["kw"])
    assert m2.generation == mi.generation
    _assert_same_arrays(mi, m2)
    params = SearchParams(ef=EF, k=K, use_dfloat=False)
    a, b = mi.search(db.queries, params), m2.search(db.queries, params)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.dists, b.dists)


def test_delta_log_appends_across_flushes(carried, tmp_path):
    db, _, port = carried["l2"]
    mi = MutableIndex(port, ef_build=32)
    rng = np.random.default_rng(7)
    path = tmp_path / "wal.naszip"
    mi.append(db.vectors[rng.integers(0, db.n, 16)])
    mi.save_delta(path)
    mi.delete(rng.choice(db.n, 8, replace=False))
    mi.save_delta(path)
    mi.save_delta(path)                       # empty flush is a no-op
    assert sorted(p.name for p in (path / "delta").iterdir()) == [
        "step_0", "step_1"]
    m2 = MutableIndex.load(path, device="cpu")
    a = mi.search(db.queries[:16], SearchParams(k=K, use_dfloat=False))
    b = m2.search(db.queries[:16], SearchParams(k=K, use_dfloat=False))
    np.testing.assert_array_equal(a.ids, b.ids)


def test_snapshot_isolation_across_generations(carried):
    """A frozen generation serves identical results while later writes land."""
    db, _, port = carried["l2"]
    mi = MutableIndex(port, ef_build=32)
    rng = np.random.default_rng(11)
    mi.append(db.vectors[rng.integers(0, db.n, 32)])
    snap = mi.freeze()
    params = SearchParams(ef=48, k=K, use_dfloat=False)
    before = snap.searcher("local", params)(db.queries[:32])
    mi.append(db.vectors[rng.integers(0, db.n, 32)])
    mi.delete(rng.choice(db.n, 64, replace=False))
    mi.freeze()                               # drains repair, COW adjacency
    after = snap.searcher("local", params)(db.queries[:32])
    np.testing.assert_array_equal(before.ids, after.ids)
    np.testing.assert_array_equal(before.dists, after.dists)
    assert before.generation == snap.generation != mi.generation


def test_capacity_doubling_keeps_ids_and_payload(carried):
    db, _, port = carried["l2"]
    mi = MutableIndex(port, reserve=0.01, ef_build=32)
    cap0 = mi.capacity
    rng = np.random.default_rng(5)
    vecs = db.vectors[rng.integers(0, db.n, 128)]
    ids = mi.append(vecs)
    assert mi.capacity > cap0                  # doubled at least once
    assert ids[0] == port.n and mi.n == port.n + 128
    np.testing.assert_array_equal(
        mi._packed[ids], dfl.pack_db(mi.spca.transform(vecs), mi.dfloat_cfg))
    np.testing.assert_array_equal(mi._packed[: port.n], port.db_packed)
    # the device mirrors follow the host arrays across the growth
    np.testing.assert_array_equal(mi._rot_d.numpy(), mi._rot)
    mi._sync_adj()
    np.testing.assert_array_equal(mi._adj_d.numpy(), mi._adj)


def test_delete_is_lazy_and_idempotent(carried):
    _, _, port = carried["l2"]
    mi = MutableIndex(port, ef_build=32)
    assert mi.delete([3, 4, 5]) == 3
    assert mi.delete([3, 4]) == 0              # idempotent
    assert mi.n_alive == port.n - 3
    assert list(mi.is_deleted([3, 4, 5, 6])) == [True, True, True, False]
    assert len(mi._pending_repair) == 3        # not yet patched
    mi.freeze()
    assert mi._pending_repair == []            # drained at the boundary
    assert mi.stats.repairs_drained == 3
    with pytest.raises(ValueError):
        mi.delete([port.n + 10_000])


def test_deleted_entry_never_leaks_even_with_underfull_beam(carried):
    """The graph entry is seeded into the beam unconditionally; with ef == k
    the final re-rank must blank its id, not just its distance."""
    db, _, port = carried["l2"]
    mi = MutableIndex(port, ef_build=32)
    entry = port.graph.entry
    mi.delete([entry])
    res = mi.search(db.queries[:32], SearchParams(ef=K, k=K, use_dfloat=False))
    assert not (res.ids == entry).any()
    assert (res.dists < BIG / 2).all() or (res.ids[res.dists > BIG / 2]
                                           == -1).all()


def test_delta_log_is_bound_to_one_path(carried, tmp_path):
    db, _, port = carried["l2"]
    mi = MutableIndex(port, ef_build=32)
    mi.append(db.vectors[:4])
    mi.save_delta(tmp_path / "a.naszip")
    mi.delete([0])
    with pytest.raises(ValueError, match="bound"):
        mi.save_delta(tmp_path / "b.naszip")
    mi.save_delta(tmp_path / "a.naszip")   # the bound path still works
    m2 = MutableIndex.load(tmp_path / "a.naszip", device="cpu")
    assert m2.is_deleted([0])[0] and m2.n == mi.n


def test_delta_log_rejects_foreign_base(carried, tmp_path):
    """A WAL must never be appended to, or replayed onto, a different base."""
    db, _, port = carried["l2"]
    _, _, port_ip = carried["ip"]
    path = tmp_path / "x.naszip"
    port_ip.save(path)                     # foreign base already on disk
    mi = MutableIndex(port, ef_build=32)
    mi.append(db.vectors[:4])
    with pytest.raises(ValueError, match="foreign|different"):
        mi.save_delta(path)
    p2 = mi.save_delta(tmp_path / "y.naszip")
    m2 = MutableIndex(port_ip, ef_build=32)
    with pytest.raises(ValueError, match="fingerprint"):
        m2.replay(p2)


def test_mutable_index_guards(carried):
    _, _, port = carried["l2"]
    frozen = MutableIndex(port, ef_build=32).freeze()
    with pytest.raises(ValueError):
        MutableIndex(frozen)                   # wrap the base, not a snapshot
    with pytest.raises(ValueError):
        MutableIndex(port).append(np.zeros((2, 3), np.float32))


def test_frozen_snapshot_save_load_round_trip(carried, tmp_path):
    """A mutated snapshot persists (tombstone array included), serves
    identical results after reload, and both packages count its alive rows
    alike."""
    db, _, port = carried["l2"]
    mi = MutableIndex(port, ef_build=32)
    rng = np.random.default_rng(13)
    mi.append(db.vectors[rng.integers(0, db.n, 24)])
    mi.delete(rng.choice(db.n, 24, replace=False))
    frozen = mi.freeze()
    path = frozen.save(tmp_path / "snap.naszip")
    loaded = Index.load(path, device="cpu")
    assert loaded.generation == frozen.generation
    assert loaded.n_alive == frozen.n_alive == mi.n_alive
    assert jix.Index.load(path).n_alive == frozen.n_alive
    params = SearchParams(ef=48, k=K, use_dfloat=False)
    a = frozen.searcher("local", params)(db.queries[:32])
    b = loaded.searcher("local", params)(db.queries[:32])
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.dists, b.dists)


# ---------------------------------------------------------------------------
# Index.load guards: the same input, the same outcome in both packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case,match", [
    ("delta", "delta segment"), ("v4", "v4"),
    ("v99", "formats \\(1, 2, 3\\)"), ("nowhere", "spec.json")])
def test_index_load_guards_match_jax(carried, tmp_path, case, match):
    db, _, port = carried["l2"]
    mi = MutableIndex(port, ef_build=32)
    mi.append(db.vectors[:4])
    path = mi.save_delta(tmp_path / "guard.naszip")
    spec = path / "spec.json"
    target = {"delta": path / "delta" / "step_0", "nowhere": tmp_path / "nowhere"
              }.get(case, path)
    if case in ("v4", "v99"):
        spec.write_text(spec.read_text().replace(
            '"format_version": 3', f'"format_version": {case[1:]}'))
    errors = []
    for load in (jix.Index.load, lambda p: Index.load(p, device="cpu")):
        with pytest.raises(ValueError, match=match) as e:
            load(target)
        errors.append(e.value)
    assert type(errors[0]) is type(errors[1])
    # the port names its own package where the reference names itself
    assert str(errors[1]) == str(errors[0]).replace("repro.streaming",
                                                    "repro_torch.streaming")


def test_delta_format_version_matches_jax():
    assert index_mod.DELTA_FORMAT_VERSION == jindex_mod.DELTA_FORMAT_VERSION
    assert index_mod.KNOWN_FORMATS == jindex_mod.KNOWN_FORMATS


@pytest.mark.parametrize("n_dead", [0, 1, 31, 33, 500])
def test_n_alive_matches_jax(carried, n_dead):
    """The same tombstone bitmap on the same rows counts the same alive rows
    in both packages (bits past ``n`` ignored)."""
    _, ref, port = carried["l2"]
    rng = np.random.default_rng(n_dead)
    dead = np.zeros(-(-port.n // 32) * 32 + 32, bool)
    dead[rng.choice(port.n, n_dead, replace=False)] = True
    dead[port.n:] = True                       # bits past the last row
    from repro_torch.streaming.mutable import pack_tombstone

    words = pack_tombstone(dead)
    p = dataclasses.replace(port, tombstone=words)
    r = dataclasses.replace(ref, tombstone=words)
    assert p.n_alive == r.n_alive == port.n - n_dead


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------
def test_churn_matches_jax(churned):
    """Same ops from the same base: rows, tombstones and counters equal, the
    adjacency within the near-tie tolerance, the same search results."""
    c = churned
    mi, jmi, db = c["mi"], c["jmi"], c["db"]
    _assert_same_arrays(mi, jmi, adj_rows=ADJ_ROWS)
    for f in ("rows_appended", "rows_deleted", "repairs_drained"):
        assert getattr(mi.stats, f) == getattr(jmi.stats, f), f
    assert mi.generation == jmi.generation
    params = SearchParams(ef=EF, k=K, use_dfloat=False)
    got = mi.search(db.queries, params)
    want = jmi.search(db.queries, _jparams(params))
    assert _overlap(got.ids, want.ids) >= OVERLAP
    # the frozen snapshots carry the same rows, tombstone and tiers
    snap, jsnap = mi.freeze(), jmi.freeze()
    assert np.array_equal(snap.db_packed, jsnap.db_packed)
    assert np.array_equal(snap.tombstone, jsnap.tombstone)
    if snap.spec.tier_split is not None:
        for x, y in zip(snap.tier_arrays(), jsnap.tier_arrays()):
            assert np.array_equal(x, y)
        params = SearchParams(ef=EF, k=K, storage="tiered")
        got = snap.search(db.queries, params)
        want = jsnap.search(db.queries, _jparams(params))
        assert _overlap(got.ids, want.ids) >= OVERLAP


def test_jax_wal_replays_in_port(churned):
    """The reference's WAL passes the port's fingerprint check on the base
    it wrote, and replays to the port's own live arrays."""
    c = churned
    from repro.streaming import delta as jdelta
    from repro_torch.streaming import delta

    port_base = Index.load(c["jax_wal"], device="cpu")
    jax_base = jix.Index.load(c["jax_wal"])
    assert delta.base_fingerprint(port_base) == jdelta.base_fingerprint(jax_base)
    m2 = MutableIndex.load(c["jax_wal"], device="cpu", **c["kw"])
    _assert_same_arrays(m2, c["mi"])
    assert m2.generation == c["mi"].generation
    assert dataclasses.asdict(m2.stats).keys() == dataclasses.asdict(
        c["mi"].stats).keys()


def test_port_wal_replays_in_jax(churned):
    c = churned
    m2 = JMutableIndex.load(c["port_wal"], **c["kw"])
    _assert_same_arrays(m2, c["jmi"])
    # the segment manifests carry the same keys and metadata
    seg = "delta/step_0/manifest.json"
    a = json.loads((c["port_wal"] / seg).read_text())
    b = json.loads((c["jax_wal"] / seg).read_text())
    assert a["keys"] == b["keys"] and a["dtypes"] == b["dtypes"]
    assert {k: v for k, v in a["metadata"].items()} == b["metadata"]


def test_ndpsim_writes_match_jax(churned):
    """The ndpsim searcher's write-burst accounting on a churned snapshot,
    field by field."""
    c = churned
    db = c["db"]
    params = SearchParams(ef=32, k=K, use_dfloat=False)
    got = c["mi"].freeze().searcher("ndpsim", params)(db.queries[:8]).sim.writes
    want = c["jmi"].freeze().searcher("ndpsim", _jparams(params))(
        db.queries[:8]).sim.writes
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    got_ws, want_ws = c["mi"].write_stats(), c["jmi"].write_stats()
    assert dataclasses.asdict(got_ws) == pytest.approx(dataclasses.asdict(want_ws),
                                                       rel=1 - ADJ_ROWS)
