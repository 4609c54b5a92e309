"""The port's serving tier (``repro_torch.serve``, ``repro_torch.index.device``)
against the JAX package's.

The reference unit indexes (``tests/conftest.py``: f32, and Dfloat at
recall target 0.80) are carried into the port through their artifacts
(``Index.load(ref.save(...), device="cpu")``).  The cases of
``tests/test_serve.py`` are restated on the port: config, queue and
admission units, bucket padding, mixed-traffic determinism, hot swap, delta
accounting and ``freeze``'s row count.  The determinism property is exact
within one batch bucket: a request served through the batcher returns ids
AND distances bit-identical to a one-by-one ``run_bucketed`` of its query at
the same bucket, whatever it was co-batched with.  The hot-swap case waits,
after each mutation, until the server has installed the new generation, and
only then submits: no swap has to land inside a timed load window.

Across packages: ``ServeConfig``'s bucket arithmetic is equal over a sweep;
``run_bucketed`` ids overlap >= 0.99 at every cell of a small lattice, with
shared ids' distances within rtol 3e-5 / atol 2e-4 (the tolerance of
``tests/test_torch_search.py``: torch and XLA sum in other orders);
``UploadStats`` is equal field for field for one seeded sequence of appends
and deletes on both packages' ``MutableIndex`` (their mutation is the same
host numpy, so the adjacency and tombstones agree); a delta splice equals a
cold install, in place or not; ``prewarm`` counts are equal.
"""
import copy
import dataclasses
import time

import numpy as np
import pytest
import torch

import repro.index as jix
import repro.serve as jserve
from repro.serve.batcher import run_bucketed as jrun_bucketed
from repro.streaming import MutableIndex as JMutableIndex
from repro_torch.core import dfloat as dfl
from repro_torch.index import DeviceCache, Index
from repro_torch.serve import (AdmissionController, LatencyModel, RequestQueue,
                               ServeConfig, Server)
from repro_torch.serve.batcher import params_for, run_bucketed
from repro_torch.serve.request import Request
from repro_torch.streaming import MutableIndex

K = 10
RTOL, ATOL = 3e-5, 2e-4
OVERLAP = 0.99
STORAGES = ("f32", "packed", "tiered")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work here is many small operations: run them on one
    thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def carried(unit_index, unit_index_dfloat, tmp_path_factory):
    """{case: (reference index, port index)}: the f32 and the Dfloat unit
    index of ``tests/conftest.py``."""
    out = {}
    for case, ref in (("f32", unit_index), ("dfloat", unit_index_dfloat)):
        path = ref.save(tmp_path_factory.mktemp(f"serve_{case}") / "i.naszip")
        out[case] = (ref, Index.load(path, device="cpu"))
    return out


def _direct(idx, q, cfg, ef, k, storage="f32", bucket=None):
    """One-by-one local search replayed through the exact serving program:
    same ef bucket, same k_max width, padded to the same batch bucket."""
    ids, dists, *_ = run_bucketed(idx, cfg, q, cfg.ef_bucket(ef),
                                  cfg.expand, storage, bucket=bucket)
    return ids[:, :k], dists[:, :k]


def _dead(snap, ids):
    """Tombstone bits of ``ids`` in ``snap`` (True = deleted)."""
    ids = np.asarray(ids, np.int64)
    return ((snap.tombstone[ids >> 5] >> (ids & 31).astype(np.uint32)) & 1) == 1


# ---------------------------------------------------------------------------
# config / queue / admission units
# ---------------------------------------------------------------------------
def test_config_validation():
    with pytest.raises(ValueError, match="smallest ef bucket"):
        ServeConfig(ef_buckets=(16, 32), k_max=20)
    with pytest.raises(ValueError, match="use_dfloat"):
        ServeConfig(storages=("packed",), use_dfloat=False)
    with pytest.raises(ValueError, match="sorted"):
        ServeConfig(ef_buckets=(64, 32))
    cfg = ServeConfig(ef_buckets=(16, 32, 64), k_max=10)
    assert cfg.ef_bucket(16) == 16        # exact hit
    assert cfg.ef_bucket(17) == 32        # rounds UP
    assert cfg.ef_bucket(999) == 64       # capped at the top bucket
    assert cfg.batch_bucket(3) == 4
    assert cfg.lower_bucket(16) is None
    assert cfg.lower_bucket(64) == 32


@pytest.mark.parametrize("ef_buckets,batch_buckets,max_queue,degrade_queue", [
    ((32, 64, 128), (1, 4, 16, 32), 256, 0),
    ((16,), (8,), 3, 0),
    ((10, 20, 40, 80, 160), (1, 2, 3, 5, 8, 13), 64, 7),
])
def test_config_bucket_arithmetic_matches_jax(ef_buckets, batch_buckets,
                                              max_queue, degrade_queue):
    kw = dict(ef_buckets=ef_buckets, batch_buckets=batch_buckets,
              k_max=min(ef_buckets), max_queue=max_queue,
              degrade_queue=degrade_queue)
    a, b = ServeConfig(**kw), jserve.ServeConfig(**kw)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for ef in range(0, 2 * max(ef_buckets) + 2):
        assert a.ef_bucket(ef) == b.ef_bucket(ef)
    for n in range(0, 2 * max(batch_buckets) + 2):
        assert a.batch_bucket(n) == b.batch_bucket(n)
    for e in ef_buckets:
        assert a.lower_bucket(e) == b.lower_bucket(e)
    assert (a.batch_max, a.degrade_depth) == (b.batch_max, b.degrade_depth)


def _req(ef=32, k=5, deadline_ms=100.0, group="f32"):
    return Request(query=np.zeros(4, np.float32), k=k, ef=ef, expand=4,
                   storage=group, deadline_ms=deadline_ms)


def test_queue_sheds_when_full_and_groups_batches():
    q = RequestQueue(max_queue=2, shed_on_full=True)
    assert q.put(_req()) and q.put(_req())
    assert not q.put(_req())              # third is shed
    cfg = ServeConfig(ef_buckets=(16, 32), k_max=10)
    q2 = RequestQueue(max_queue=8)
    reqs = [_req(ef=16), _req(ef=32), _req(ef=16), _req(ef=32)]
    for r in reqs:
        q2.put(r)
    batch = q2.take_group(lambda r: r.group(cfg), max_n=8)
    # oldest-first, coalescing only its own group; order preserved
    assert [r.id for r in batch] == [reqs[0].id, reqs[2].id]
    rest = q2.take_group(lambda r: r.group(cfg), max_n=8)
    assert [r.id for r in rest] == [reqs[1].id, reqs[3].id]


def test_admission_timeout_and_degrade():
    cfg = ServeConfig(ef_buckets=(16, 32, 64), k_max=10, degrade=True,
                      max_queue=64)
    model = LatencyModel()
    adm = AdmissionController(cfg, model)

    dead = _req(deadline_ms=0.0)
    time.sleep(0.002)                     # let the deadline lapse
    live = _req(ef=64, deadline_ms=50.0)
    serve, timed_out, ef, degraded = adm.plan([dead, live], queue_len=0)
    assert [r.id for r in timed_out] == [dead.id]
    assert [r.id for r in serve] == [live.id] and ef == 64 and not degraded

    # a 64-bucket EMA way over budget degrades the batch to a faster bucket
    model.observe((64, 4, "f32"), 1, 10.0)   # 10 s >> 50 ms deadline
    model.observe((32, 4, "f32"), 1, 0.001)
    serve, _, ef, degraded = adm.plan([_req(ef=64, deadline_ms=50.0)], 0)
    assert serve and ef == 32 and degraded

    # queue pressure beyond degrade_depth forces the floor bucket
    serve, _, ef, degraded = adm.plan([_req(ef=64, deadline_ms=5000.0)],
                                      queue_len=cfg.degrade_depth)
    assert serve and ef == 16 and degraded


# ---------------------------------------------------------------------------
# bucket padding + determinism against direct searches
# ---------------------------------------------------------------------------
def test_bucket_padding_batch_of_1_vs_32(unit_db, carried):
    """A single query padded to a 32-wide bucket returns exactly its own
    results, bit-identical to the same lane among 32 real queries at any
    lane position."""
    _, idx = carried["f32"]
    cfg = ServeConfig(ef_buckets=(32,), batch_buckets=(32,), k_max=K)
    q = unit_db.queries[:1]
    ids, dists, *_ = run_bucketed(idx, cfg, q, 32, cfg.expand, "f32")
    assert ids.shape == (1, K) and dists.shape == (1, K)

    full = unit_db.queries[:32]
    ids_f, dists_f, *_ = run_bucketed(idx, cfg, full, 32, cfg.expand, "f32")
    np.testing.assert_array_equal(ids[0], ids_f[0])
    np.testing.assert_array_equal(dists[0], dists_f[0])

    perm = np.concatenate([unit_db.queries[1:18], q, unit_db.queries[18:32]])
    ids_p, dists_p, *_ = run_bucketed(idx, cfg, perm, 32, cfg.expand, "f32")
    np.testing.assert_array_equal(ids[0], ids_p[17])
    np.testing.assert_array_equal(dists[0], dists_p[17])

    # against the unpadded batch-1 search: ids exact, dists to fp32 noise
    res = idx.searcher("local", params_for(cfg, 32, cfg.expand, "f32"))(q)
    np.testing.assert_array_equal(ids, res.ids[:, :K])
    np.testing.assert_allclose(dists, res.dists[:, :K], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("storage", STORAGES)
def test_batched_mixed_traffic_bit_identical(unit_db, carried, storage):
    """Mixed k/ef traffic through the live batcher == one-by-one searches at
    the batch bucket that served each request."""
    _, idx = carried["f32" if storage == "f32" else "dfloat"]
    cfg = ServeConfig(ef_buckets=(16, 32), batch_buckets=(1, 4, 8), k_max=K,
                      storages=(storage,), use_dfloat=storage != "f32",
                      slo_ms=5000.0)
    srv = Server(idx, cfg).start()
    try:
        cases = [(unit_db.queries[i], [16, 32, 48][i % 3], [3, 7, K][i % 3])
                 for i in range(24)]
        futs = [srv.submit(q, k=k, ef=ef) for q, ef, k in cases]
        resps = [f.result(timeout=60) for f in futs]
    finally:
        srv.stop()
    for (q, ef, k), r in zip(cases, resps):
        assert r.status == "ok"
        assert r.ids.shape == (k,) and r.dists.shape == (k,)
        assert r.ef_served == cfg.ef_bucket(ef)   # rounded UP, never down
        ref_ids, ref_dists = _direct(idx, q[None], cfg, ef, k, storage,
                                     bucket=r.batch_bucket)
        np.testing.assert_array_equal(r.ids, ref_ids[0])
        np.testing.assert_array_equal(r.dists, ref_dists[0])


@pytest.mark.parametrize("storage", STORAGES)
def test_run_bucketed_matches_jax(unit_db, carried, storage):
    """Every (ef bucket, batch bucket) cell of a small lattice: the port's
    ids overlap the reference's >= 0.99, shared ids' distances agree."""
    ref, port = carried["dfloat"]
    kw = dict(ef_buckets=(16, 32), batch_buckets=(1, 4), k_max=K,
              storages=STORAGES, use_dfloat=True)
    cfg, jcfg = ServeConfig(**kw), jserve.ServeConfig(**kw)
    queries = unit_db.queries[:16]
    for ef in cfg.ef_buckets:
        for b in cfg.batch_buckets:
            got, want = [], []
            for s in range(0, len(queries), b):
                q = queries[s: s + b]
                got.append(run_bucketed(port, cfg, q, ef, cfg.expand, storage,
                                        bucket=b)[:2])
                want.append(jrun_bucketed(ref, jcfg, q, ef, jcfg.expand,
                                          storage, bucket=b)[:2])
            ids, dists = (np.concatenate(x) for x in zip(*got))
            jids, jdists = (np.concatenate(x) for x in zip(*want))
            assert ids.shape == jids.shape == (len(queries), K)
            ov = np.mean([len(set(a) & set(c)) / K for a, c in zip(ids, jids)])
            assert ov >= OVERLAP, (ef, b, ov)
            for a, da, c, dc in zip(ids, dists, jids, jdists):
                pos = {v: i for i, v in enumerate(c.tolist())}
                both = [(i, pos[v]) for i, v in enumerate(a.tolist()) if v in pos]
                np.testing.assert_allclose(da[[i for i, _ in both]],
                                           dc[[j for _, j in both]],
                                           rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# hot swap: zero failures, consistent generations, delta uploads
# ---------------------------------------------------------------------------
def test_hot_swap_mid_stream_consistent(unit_db, carried):
    """Three generations served in turn, each installed before its traffic
    (waited for, not timed): every response ok, each replays bit for bit on its generation's snapshot and
    holds no id tombstoned there, and swaps ship deltas."""
    _, idx = carried["f32"]
    cfg = ServeConfig(ef_buckets=(32,), batch_buckets=(1, 4), k_max=K,
                      slo_ms=5000.0, swap_poll_s=0.05)
    mi = MutableIndex(idx, ef_build=32, sub_batch=64)
    rng = np.random.default_rng(0)
    served = []                           # (query row, response)
    srv = Server(mi, cfg).start()
    try:
        for rnd in range(3):
            rows = [(8 * rnd + i) % len(unit_db.queries) for i in range(8)]
            futs = [srv.submit(unit_db.queries[i], k=K, ef=32,
                               deadline_ms=5000.0) for i in rows]
            served += [(i, f.result(timeout=60)) for i, f in zip(rows, futs)]
            mi.append(rng.standard_normal((4, unit_db.dim)).astype(np.float32))
            mi.delete(rng.choice(mi.alive_ids(), 2, replace=False))
            target = mi.freeze().generation      # repairs drained: settled
            t_end = time.monotonic() + 30
            while srv.generation != target and time.monotonic() < t_end:
                time.sleep(0.01)
            assert srv.generation == target, "the new generation was not installed"
        history = dict(srv.history)
        swap_summary = srv.metrics.summary().get("swaps", {})
    finally:
        srv.stop()

    assert all(r.status == "ok" for _, r in served)
    gens = {r.generation for _, r in served}
    assert len(gens) == 3 and gens <= set(history)
    first = {}
    for i, r in served:
        assert not _dead(history[r.generation], r.ids).any()
        first.setdefault(r.generation, (i, r))
    for gen, (i, r) in first.items():
        ref_ids, ref_dists = _direct(history[gen], unit_db.queries[i][None],
                                     cfg, 32, K, bucket=r.batch_bucket)
        np.testing.assert_array_equal(r.ids, ref_ids[0])
        np.testing.assert_array_equal(r.dists, ref_dists[0])
    assert swap_summary.get("delta_installs", 0) >= 3
    assert swap_summary["max_delta_reupload_fraction"] < 0.25


def test_delta_upload_accounting(unit_db, carried):
    """Byte-exact: a generation swap ships only the appended tail + dirtied
    adjacency/tombstone, and splices to exactly what a cold upload builds."""
    _, idx = carried["f32"]
    mi = MutableIndex(idx, ef_build=32, sub_batch=64)
    cache = DeviceCache(storage="f32", use_dfloat=False, donate=True)
    s0 = cache.install(mi.freeze())
    assert s0.mode == "full" and s0.h2d_bytes == s0.full_bytes

    rng = np.random.default_rng(2)
    mi.append(rng.standard_normal((8, unit_db.dim)).astype(np.float32))
    mi.delete(np.arange(4))
    snap = mi.freeze()
    s1 = cache.install(snap)
    assert s1.mode == "delta" and s1.donated
    assert s1.tail_rows == 8
    assert s1.dirty_tombstone_words >= 1
    assert s1.h2d_bytes < 0.1 * s1.full_bytes
    assert s1.reused_rows > 0

    fresh = DeviceCache(storage="f32", use_dfloat=False, donate=False)
    bare = copy.copy(snap)
    bare._device, bare._searchers = {}, {}
    fresh.install(bare)
    for name in ("_db", "_adj", "_tomb"):
        assert torch.equal(getattr(cache, name), getattr(fresh, name)), name


def test_freeze_stamps_n_rows(unit_db, carried):
    _, idx = carried["f32"]
    mi = MutableIndex(idx)
    snap = mi.freeze()
    assert snap.n_rows == unit_db.n      # allocated prefix, not capacity
    assert snap.n >= snap.n_rows         # capacity array is larger
    mi.append(np.zeros((3, unit_db.dim), np.float32))
    assert mi.freeze().n_rows == unit_db.n + 3


# ---------------------------------------------------------------------------
# DeviceCache against the reference's, and against a cold install
# ---------------------------------------------------------------------------
def _churn_installs(db, index, mutable_cls, cache, seed=5, rounds=2):
    """A seeded append/delete sequence, each generation installed into
    ``cache``; returns the MutableIndex and every install's stats."""
    mi = mutable_cls(index, ef_build=32, sub_batch=64)
    rng = np.random.default_rng(seed)
    stats = [cache.install(mi.freeze())]
    for _ in range(rounds):
        src = rng.integers(0, db.n, 16)
        mi.append(db.vectors[src] + 0.05 * rng.standard_normal(
            (16, db.dim)).astype(np.float32))
        mi.delete(rng.choice(mi.alive_ids(), 8, replace=False))
        stats.append(cache.install(mi.freeze()))
    return mi, stats


@pytest.mark.parametrize("storage", STORAGES)
def test_upload_stats_match_jax(unit_db, carried, storage):
    """The same op sequence in both packages ships the same bytes: every
    install's ``UploadStats`` equal field for field, ``per_array``
    included."""
    ref, port = carried["dfloat"]
    mi, got = _churn_installs(unit_db, port, MutableIndex,
                              DeviceCache(storage=storage, use_dfloat=True))
    jmi, want = _churn_installs(unit_db, ref, JMutableIndex,
                                jix.DeviceCache(storage=storage, use_dfloat=True))
    assert np.array_equal(mi._adj, jmi._adj)   # so dirty rows can agree
    assert [s.mode for s in got] == ["full", "delta", "delta"]
    for a, b in zip(got, want):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.reupload_fraction == b.reupload_fraction


@pytest.mark.parametrize("donate", [True, False])
@pytest.mark.parametrize("storage", STORAGES)
def test_delta_splice_equals_cold_install(unit_db, carried, storage, donate):
    """After two delta installs the resident tensors equal a cold install of
    the last snapshot and the snapshot's own ``Index.device_db`` upload;
    ``donate=False`` leaves the previous generation's tensors untouched."""
    _, port = carried["dfloat"]
    cache = DeviceCache(storage=storage, use_dfloat=True, donate=donate)
    mi = MutableIndex(port, ef_build=32, sub_batch=64)
    cache.install(mi.freeze())
    rng = np.random.default_rng(7)
    for _ in range(2):
        before = {n: getattr(cache, n) for n in ("_db", "_db_res", "_adj", "_tomb")}
        kept = {n: t.clone() for n, t in before.items() if t is not None}
        mi.append(rng.standard_normal((8, unit_db.dim)).astype(np.float32))
        mi.delete(rng.choice(mi.alive_ids(), 4, replace=False))
        snap = mi.freeze()
        assert cache.install(snap).mode == "delta"
        for n, t in kept.items():
            assert (getattr(cache, n) is before[n]) == donate, n
            if not donate:              # the old generation is intact
                assert torch.equal(before[n], t), n
    bare = copy.copy(snap)
    bare._device, bare._searchers = {}, {}
    cold = DeviceCache(storage=storage, use_dfloat=True, donate=False)
    assert cold.install(bare).mode == "full"
    for n in ("_db", "_db_res", "_adj", "_tomb"):
        a, b = getattr(cache, n), getattr(cold, n)
        assert (a is None and b is None) or torch.equal(a, b), n
    own = copy.copy(snap)
    own._device, own._searchers = {}, {}
    db = own.device_db(True, storage, own.device)
    resident = (cache._db, cache._db_res) if storage == "tiered" else (cache._db,)
    for a, b in zip(resident, db if storage == "tiered" else (db,)):
        assert torch.equal(a, b)
    assert torch.equal(cache._adj, own.device_adjacency(own.device))
    assert torch.equal(cache._tomb, own.device_tombstone(own.device))
    # the seeded snapshot searches the resident tensors, with the cold
    # snapshot's results
    params = params_for(ServeConfig(storages=STORAGES, use_dfloat=True), 32, 4,
                        storage)
    a = snap.searcher("local", params)(unit_db.queries[:8])
    b = own.searcher("local", params)(unit_db.queries[:8])
    assert np.array_equal(a.ids, b.ids) and np.array_equal(a.dists, b.dists)


@pytest.mark.parametrize("storage,max_updates", [("f32", None), ("packed", 64),
                                                 ("tiered", None)])
def test_prewarm_counts_match_jax(carried, storage, max_updates):
    ref, port = carried["dfloat"]
    snap = MutableIndex(port).freeze()
    cache = DeviceCache(storage=storage, use_dfloat=True)
    cache.install(snap)
    got = cache.prewarm(max_updates)
    jcache = jix.DeviceCache(storage=storage, use_dfloat=True)
    jcache.install(JMutableIndex(ref).freeze())
    assert got == jcache.prewarm(max_updates) > 0
    # the warm-up's writes are no-ops, and the snapshot stays seeded
    cold = DeviceCache(storage=storage, use_dfloat=True, donate=False)
    bare = copy.copy(snap)
    bare._device, bare._searchers = {}, {}
    cold.install(bare)
    for n in ("_db", "_db_res", "_adj", "_tomb"):
        a, b = getattr(cache, n), getattr(cold, n)
        assert (a is None and b is None) or torch.equal(a, b), n
    assert snap._device[("adj", str(snap.device))] is cache._adj


def test_emulated_rows_match_jax_and_device(carried):
    """``Index.emulated_rows`` equals the reference's, and the quantization
    of the same rows as a tensor (what a delta install runs on the card)."""
    ref, port = carried["dfloat"]
    ids = np.array([0, 5, 17, 1999, 5, 3], np.int64)
    got = port.emulated_rows(ids)
    np.testing.assert_array_equal(got, np.asarray(ref.emulated_rows(ids)))
    dev = dfl.emulate_db(torch.from_numpy(port.db_rot[ids]), port.dfloat_cfg)
    np.testing.assert_array_equal(got, dev.numpy())
    np.testing.assert_array_equal(got, port.db_q[ids])
