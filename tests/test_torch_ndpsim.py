"""The port's NDP simulator backend vs the JAX package's.

``repro_torch.ndpsim`` is the JAX package's numpy engine copied onto the
port's ``DfloatConfig``, so on the same inputs every number must be equal,
exactly: the cache's hit/miss sequence, the DaM owner map and partition, and
each ``SimResult`` field of ``simulate_ndp`` (fed the reference's traces, a
unit index carried across, 48 queries, ``ef=32``), ``simulate_platform`` and
``account_writes``.  The port's ``ndpsim`` searcher (its traced search on the
CPU, replayed) must give the reference searcher's ids, and its ``sim``
wherever the two traces agree (the two packages sum a distance in different
orders, so accepted distances may differ in their last bits; the trace's
structure may not).  The reference's direction tests (DaM, LNC and prefetch
help; batching trades latency for throughput) are restated on the port's own
traces.
"""
import dataclasses
import types
import zlib

import numpy as np
import pytest

import repro.index as jix
from repro.core import dfloat as jdfl
from repro.core import graph as jgraph
from repro.ndpsim import SetAssocCache as JCache
from repro.ndpsim import engine as jengine
from repro.ndpsim import timing as jtiming
from repro_torch.core import dfloat as dfl
from repro_torch.core import graph as tgraph
from repro_torch.index import SearchParams, from_arrays
from repro_torch.ndpsim import SetAssocCache, SimFlags, engine, timing
from test_torch_search import _artifact, _unit

N_Q, EF = 48, 32
TRACED = SearchParams(ef=EF, k=10, trace=True)
PRESETS = ["CPU_BASELINE", "CPU_SCANN", "CPU_HP", "GPU_A100", "ANNA_ASIC",
           "PIMANN_UPMEM", "DFGAS_FPGA"]


def _jparams(params):
    return jix.SearchParams(**dataclasses.asdict(params))


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """(db, JAX index, port index) over one JAX-built unit index with a
    Dfloat layout, carried across."""
    db = _unit("unit")
    spec = jix.IndexSpec.for_db(db, m=8, dfloat_recall_target=0.8, dfloat_proxy=True)
    ref = jix.Index.build(db, spec, cache_key=f"torch-parity/unit/"
                          f"{zlib.crc32(db.vectors.tobytes())}")
    path = tmp_path_factory.mktemp("jax_unit")
    ref.save(path)
    port = from_arrays(*_artifact(path), "cpu")
    return db, ref, port


@pytest.fixture(scope="module")
def traces(carried):
    """{expand: the reference's traced result} on the first 48 queries."""
    db, ref, _ = carried
    return {e: ref.search(db.queries[:N_Q], _jparams(dataclasses.replace(TRACED, expand=e)))
            for e in (4, 1)}


def _cfgs(cfg: dfl.DfloatConfig):
    """The same layout as a JAX package config."""
    return jdfl.DfloatConfig(tuple(jdfl.DfloatSegment(*dataclasses.astuple(s))
                                   for s in cfg.segments),
                             cfg.burst_bits, cfg.devices_per_subchannel)


def assert_same_sim(got, want):
    """Every field of two SimResults equal, exactly."""
    assert type(got).__name__ == type(want).__name__ == "SimResult"
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert np.array_equal(a, b), f.name
        elif dataclasses.is_dataclass(b):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, (f.name, a, b)


# ---------------------------------------------------------------------------
# the cache, the owner map and the DaM partition
# ---------------------------------------------------------------------------


def _stream(name):
    """(capacity, ways, [(op, addr, size)]): the address streams of the
    reference's cache tests, and one that mixes fills, probes and
    non-inserting accesses."""
    if name == "lru":
        return 4 * 64, 4, [("access", a, 1) for a in (0, 64, 128, 192, 0, 256, 0, 64)]
    if name == "spans":
        return 1024, None, [("access", 0, 200), ("access", 0, 200)]
    if name.startswith("zipf"):
        addrs = np.random.default_rng(0).zipf(1.3, 20000) * 64 % (1 << 24)
        return int(name[4:]) * 1024, 8, [("access", int(a), 1) for a in addrs]
    rng = np.random.default_rng(1)
    ops = ("access", "fill", "contains", "peek")
    return 2048, 4, [(ops[rng.integers(4)], int(rng.integers(0, 1 << 14)),
                      int(rng.integers(1, 300))) for _ in range(3000)]


@pytest.mark.parametrize("name", ["lru", "spans", "zipf4", "zipf32", "zipf256", "mixed"])
def test_cache_same_hits_and_misses(name):
    cap, ways, stream = _stream(name)
    caches = SetAssocCache(cap, 64, ways), JCache(cap, 64, ways)
    seqs = ([], [])
    for op, addr, size in stream:
        for c, seq in zip(caches, seqs):
            if op == "peek":
                seq.append(c.access(addr, size, insert=False))
            else:
                seq.append(getattr(c, op)(addr, size))
    assert seqs[0] == seqs[1]
    assert (caches[0].hits, caches[0].misses, caches[0].hit_rate) == \
        (caches[1].hits, caches[1].misses, caches[1].hit_rate)


@pytest.mark.parametrize("policy", ["shuffle", "contiguous"])
@pytest.mark.parametrize("seed", [0, 7])
def test_map_owners_equal(carried, policy, seed):
    _, ref, port = carried
    n_sub = timing.NASZIP_2CH.n_subchannels
    got = tgraph.map_owners(port.n, n_sub, policy, seed=seed)
    want = jgraph.map_owners(ref.n, n_sub, policy, seed=seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("pad_width", [None, 12])
def test_build_dam_equal(carried, pad_width):
    _, ref, port = carried
    adj = port.graph.base_adjacency
    assert np.array_equal(adj, ref.graph.base_adjacency)
    owner = tgraph.map_owners(port.n, 16, "shuffle", seed=0)
    got = tgraph.build_dam(adj, owner, 16, pad_width)
    want = jgraph.build_dam(adj, owner, 16, pad_width)
    assert got.n_channels == want.n_channels
    assert got.max_part_width() == want.max_part_width()
    for key in ("owner", "local_of"):
        assert np.array_equal(getattr(got, key), getattr(want, key)), key
    for key in ("local_ids", "part_adj"):
        for a, b in zip(getattr(got, key), getattr(want, key), strict=True):
            assert a.dtype == b.dtype and np.array_equal(a, b), key


@pytest.mark.parametrize("runs,devices", [([(16, 5, 64)], 4), ([(12, 4, 30), (21, 6, 34)], 4),
                                          ([(32, 8, 9), (14, 5, 55)], 2), ([(18, 6, 64)], 1)])
def test_row_burst_groups_equal(runs, devices):
    x = np.random.default_rng(devices).standard_normal((16, 64)).astype(np.float32)
    cfg = dfl.make_config(64, runs, x, devices=devices)
    jcfg = jdfl.make_config(64, runs, x, devices=devices)
    assert cfg.row_burst_groups() == jcfg.row_burst_groups()
    assert cfg.bursts_per_vector() == jcfg.bursts_per_vector()


# ---------------------------------------------------------------------------
# the engine on the reference's traces
# ---------------------------------------------------------------------------

# name: (trace's expand, SimFlags fields, layout: "index" | "fp32" | "tiered")
SIM_CASES = {
    **{f"dam{d}-lnc{l}-pf{p}": (4, dict(dam=bool(d), lnc=bool(l), prefetch=bool(p)), "index")
       for d in (0, 1) for l in (0, 1) for p in (0, 1)},
    "dense": (4, dict(list_compression="dense"), "index"),
    "dense-nodam": (4, dict(list_compression="dense", dam=False), "index"),
    "fp32": (4, dict(), "fp32"),
    "tiered": (4, dict(), "tiered"),
    "batch1-merge8": (4, dict(batch=1, merge_width=8), "index"),
    "expand1": (1, dict(), "index"),
}


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_simulate_ndp_equal(carried, traces, case):
    expand, fields, layout = SIM_CASES[case]
    _, ref, port = carried
    res = traces[expand]
    hw = timing.NASZIP_2CH
    assert dataclasses.asdict(hw) == dataclasses.asdict(jtiming.NASZIP_2CH)
    owner = tgraph.map_owners(port.n, hw.n_subchannels, "shuffle", seed=0)
    cfg = dfl.fp32_config(port.dim) if layout == "fp32" else port.dfloat_cfg
    tiers = None
    if layout == "tiered":
        n_segs = port.dim // port.seg
        tiers = dfl.split_config(cfg, (n_segs // 2) * port.seg)
        assert 0 < tiers[0].dim < port.dim
    got = engine.simulate_ndp(res.trace, owner, port.graph.base_adjacency, hw,
                              SimFlags(**fields), cfg, port.seg, tier_cfgs=tiers)
    want = jengine.simulate_ndp(res.trace, owner, ref.graph.base_adjacency,
                                jtiming.NASZIP_2CH, jengine.SimFlags(**fields),
                                _cfgs(cfg), ref.seg,
                                tier_cfgs=None if tiers is None else tuple(map(_cfgs, tiers)))
    assert_same_sim(got, want)
    assert (got.survivor_fetch_fraction is None) == (layout != "tiered")


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("bytes_per_feature", [4.0, 1.5])
def test_simulate_platform_equal(carried, traces, preset, bytes_per_feature):
    _, _, port = carried
    hw, jhw = getattr(timing, preset), getattr(jtiming, preset)
    assert dataclasses.asdict(hw) == dataclasses.asdict(jhw)
    got = engine.simulate_platform(traces[4], port.dim, hw, bytes_per_feature,
                                   extra_hop_ns=30.0)
    want = jengine.simulate_platform(traces[4], port.dim, jhw, bytes_per_feature,
                                     extra_hop_ns=30.0)
    assert_same_sim(got, want)


@pytest.mark.parametrize("stats", [
    dict(rows_appended=1000, rows_deleted=37, edge_writes=5000),
    types.SimpleNamespace(rows_appended=3, rows_deleted=0, edge_writes=41),
    dict(rows_appended=0, rows_deleted=9)])
@pytest.mark.parametrize("list_bytes", [None, 23.5])
def test_account_writes_equal(carried, stats, list_bytes):
    _, _, port = carried
    for name in ("NASZIP_2CH", "NASZIP_6CH"):
        got = engine.account_writes(stats, port.dfloat_cfg, getattr(timing, name), 8,
                                    list_bytes)
        want = jengine.account_writes(stats, _cfgs(port.dfloat_cfg),
                                      getattr(jtiming, name), 8, list_bytes)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.per_append_us() == want.per_append_us()


def test_list_coding_helpers_equal(carried):
    _, _, port = carried
    adj = port.graph.base_adjacency
    assert np.array_equal(engine.compressed_list_bytes(adj), jengine.compressed_list_bytes(adj))
    vals = np.random.default_rng(2).integers(0, 1 << 30, 500)
    assert np.array_equal(engine.varint_bytes(vals), jengine.varint_bytes(vals))
    for counts in ([0] * 16, list(range(16)), [90, 3, 0, 70, 5]):
        for width in (1, 8, 64):
            assert engine.tree_merge_bytes(counts, width) == \
                jengine.tree_merge_bytes(counts, width)


# ---------------------------------------------------------------------------
# the ndpsim searcher, end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("storage", ["f32", "packed", "tiered"])
def test_ndpsim_searcher_matches_jax(carried, storage):
    db, ref, port = carried
    params = SearchParams(ef=EF, k=10, storage=storage)
    got = port.searcher("ndpsim", params, device="cpu")(db.queries[:N_Q])
    want = ref.searcher("ndpsim", _jparams(params))(db.queries[:N_Q])
    assert np.array_equal(got.ids, want.ids)
    same = np.ones(N_Q, bool)
    for key in ("node", "nbrs", "segs", "src"):
        same &= (got.trace[key] == want.trace[key]).reshape(N_Q, -1).all(1)
    gd, wd = got.trace["cand_d"], want.trace["cand_d"]
    near = np.isclose(gd, wd, rtol=3e-5, atol=2e-4) & ((gd < 1e37) == (wd < 1e37))
    same &= near.reshape(N_Q, -1).all(1)
    assert same.mean() >= 0.95
    assert (got.sim.survivor_fetch_fraction is None) == (storage != "tiered")
    if same.all():
        assert_same_sim(got.sim, want.sim)
    else:   # replay both engines over the queries whose traces agree
        sub = lambda t: {k: v[same] for k, v in t.items()}
        owner = tgraph.map_owners(port.n, 16, "shuffle", seed=0)
        tiers = port.tier_cfgs() if storage == "tiered" else None
        assert_same_sim(
            engine.simulate_ndp(sub(got.trace), owner, port.graph.base_adjacency,
                                timing.NASZIP_2CH, SimFlags(), port.dfloat_cfg, port.seg,
                                tier_cfgs=tiers),
            jengine.simulate_ndp(sub(want.trace), owner, ref.graph.base_adjacency,
                                 jtiming.NASZIP_2CH, jengine.SimFlags(),
                                 ref.dfloat_cfg, ref.seg,
                                 tier_cfgs=None if tiers is None else ref.tier_cfgs()))
    if storage == "tiered":
        assert got.residual_fetch_fraction == want.residual_fetch_fraction


def test_ndpsim_searcher_options(carried):
    """The JAX package's options reach the engine: another machine, flags,
    owner policy and seed each give the reference's projection."""
    db, ref, port = carried
    params = SearchParams(ef=EF, k=10, storage="packed")
    opts = dict(flags=None, owner_policy="contiguous", seed=3)
    got = port.searcher("ndpsim", params, device="cpu", hw=timing.NASZIP_6CH,
                        **opts)(db.queries[:16])
    want = ref.searcher("ndpsim", _jparams(params), hw=jtiming.NASZIP_6CH,
                        **opts)(db.queries[:16])
    assert np.array_equal(got.ids, want.ids)
    assert_same_sim(got.sim, want.sim)


# ---------------------------------------------------------------------------
# the reference's direction tests, on the port's traces
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_trace(carried):
    db, _, port = carried
    return port.search(db.queries[:N_Q], TRACED, device="cpu")


def _run(port_trace, port, cfg=None, **kw):
    owner = tgraph.map_owners(port.n, timing.NASZIP_2CH.n_subchannels, "shuffle")
    return engine.simulate_ndp(port_trace, owner, port.graph.base_adjacency,
                               timing.NASZIP_2CH, SimFlags(**kw),
                               cfg or port.dfloat_cfg, port.seg)


def test_dam_reduces_latency(carried, port_trace):
    port = carried[2]
    on = _run(port_trace, port, dam=True, lnc=False, prefetch=False)
    off = _run(port_trace, port, dam=False, lnc=False, prefetch=False)
    assert on.qps > off.qps, (on.qps, off.qps)
    assert on.t_partial_us < off.t_partial_us, "DaM cuts host/cross-channel time"


def test_lnc_reduces_neighbor_latency(carried, port_trace):
    port = carried[2]
    on = _run(port_trace, port, dam=True, lnc=True, prefetch=False)
    off = _run(port_trace, port, dam=True, lnc=False, prefetch=False)
    assert on.t_neighbor_us < off.t_neighbor_us
    assert 0.0 < on.lnc_d_hit <= 1.0


def test_prefetch_hits_bounded_and_helpful(carried, port_trace):
    on = _run(port_trace, carried[2], dam=True, lnc=True, prefetch=True)
    assert 0.0 <= on.prefetch_hit <= 1.0
    assert on.prefetch_hit > 0.3, "locality should give real prefetch coverage"


def test_dfloat_reduces_dram_traffic(carried, port_trace):
    port = carried[2]
    with_df = _run(port_trace, port)
    no_df = _run(port_trace, port, cfg=dfl.fp32_config(port.dim))
    assert with_df.dram_bytes_per_query < no_df.dram_bytes_per_query


def test_batch_tradeoff(carried, port_trace):
    port = carried[2]
    small = _run(port_trace, port, batch=1)
    big = _run(port_trace, port, batch=16)
    # paper Fig. 22/23: batching raises throughput and evens load
    assert big.qps >= small.qps
    assert big.idle_frac <= small.idle_frac + 1e-9
    # but latency per query grows with batch (hop-synchronized batches)
    assert big.avg_latency_us >= small.avg_latency_us * 0.9
