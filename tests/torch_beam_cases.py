"""The beam loop's inputs built from an index, for tests that call
``repro_torch.core.search._search_batch`` itself (so that its two loops run
on the same state), the untraced loop written as it ran before its hop
became an in-place step, and the descent as it ran on the host before the
upper levels lived on the device.  No JAX here: the CUDA tests use it
too."""
import numpy as np
import torch

from repro_torch.core import fee as fee_mod
from repro_torch.core import search
from repro_torch.core.fee import FeeParams
from repro_torch.index import backends

STORAGES = ("f32", "packed", "tiered")
CNT_KEYS = ("n_eval", "dims", "n_resid")


def dead_words(n: int, seed: int) -> np.ndarray:
    """A tombstone of 5% of ``n`` rows, as (ceil(n/32),) uint32 words."""
    rng = np.random.default_rng(seed)
    dead = rng.choice(n, n // 20, replace=False)
    words = np.zeros(-(-n // 32), np.uint32)
    np.bitwise_or.at(words, dead >> 5, np.uint32(1) << (dead & 31).astype(np.uint32))
    return words


def frontier_inputs(n_q, e, m, seed, n=None):
    """Random inputs of one hop's frontier step, as numpy arrays (nodes
    (Q, E) int32, sel (Q, E) bool, adj (n, M) int32, visited (Q, ceil(n/32))
    int32 words): ids repeated within and across pops (drawn from ``n``
    rows, by default a pool of ``max(64, E*M)``), -1 pads in the adjacency,
    unselected pops (with Q > 1, a first query with none selected) and
    visited bits set beforehand."""
    rng = np.random.default_rng(seed)
    n = n or max(64, e * m)
    adj = rng.integers(0, n, (n, m)).astype(np.int32)
    adj[rng.random((n, m)) < 0.1] = -1
    sel = rng.random((n_q, e)) < 0.8
    if n_q > 1:
        sel[0] = False
    nodes = np.where(sel, rng.integers(0, n, (n_q, e)), -1).astype(np.int32)
    bits = rng.random((n_q, -(-n // 32) * 32)) < 0.3
    visited = np.packbits(bits, axis=1, bitorder="little").view(np.int32)
    return nodes, sel, adj, visited


def beam_inputs(idx, queries, params, device, tombstone=None):
    """``(args, kwargs)`` of ``search._search_batch`` for the raw
    ``queries`` on ``idx``, as its local searcher makes them: the storage's
    rows, the adjacency, the FEE parameters, the tombstone (``tombstone``
    words, else the index's own), the transformed queries and their entries
    after the descent."""
    cfg = params.to_config(idx.metric, idx.seg)
    vectors = idx.device_db(params.use_dfloat, params.storage, device)
    dfl_cfg = backends._dfloat_cfg(idx, params)
    q = torch.from_numpy(idx.transform_queries(
        np.asarray(queries, np.float32).reshape(-1, idx.dim))).to(device)
    entries = search.descend_entry(idx.device_levels(device), vectors, params.storage,
                                   dfl_cfg, q, idx.metric)
    fee = FeeParams.coerce(backends._fee_params(idx, params, None, device),
                           device=device)
    tomb = (idx.device_tombstone(device) if tombstone is None
            else torch.from_numpy(tombstone.view(np.int32)).to(device))
    args = (vectors, idx.device_adjacency(device), fee, tomb, q, entries)
    return args, dict(cfg=cfg, trace=False, dfl_cfg=dfl_cfg)


def parent_loop(vectors, adj, fee, tombstone, queries, entries, *, cfg,
                trace, dfl_cfg):
    """The untraced beam loop before its hop was an in-place step: each hop
    returns a new state, the counters are summed from its trace (the traced
    form of the hop), and the termination test is computed and read between
    hops.  Returns ``_search_batch``'s untraced dict."""
    assert not trace
    keys = CNT_KEYS if cfg.storage == "tiered" else CNT_KEYS[:2]
    n_words = -(-search._lead(vectors).shape[0] // 32)
    state = search._init_state(queries, entries, vectors, cfg, n_words, dfl_cfg)
    counters = torch.zeros((queries.shape[0], len(keys) + 1), dtype=torch.int64,
                           device=queries.device)
    while True:
        _, beam_d, expanded, _ = state
        if not bool(((~expanded) & (beam_d < search.BIG)).any()):
            break
        state, t = search._hop_body(state, vectors, adj, queries, fee, cfg,
                                    dfl_cfg, tombstone, trace=True)
        counters += torch.stack([t[k] for k in keys]
                                + [(t["node"] >= 0).any(1).to(torch.int32)], dim=1)
    beam_ids, beam_d = state[0], state[1]
    if tombstone is not None:
        beam_ids, beam_d = search.exclude_dead(beam_ids, beam_d, tombstone)
    out = dict(ids=beam_ids[:, : cfg.k], dists=beam_d[:, : cfg.k])
    *cnt, out["hops"] = counters.to(torch.int32).unbind(1)
    out.update(zip(keys, cnt))
    return out


def parent_rows(params, vectors, dfl_cfg, device):
    """The upper levels' row provider as the searchers built it before the
    row rule had one home: f32 rows gathered a whole level a call, packed
    and tiered levels decoded whole once and kept, keyed by ``id(ids)``."""
    if params.storage == "f32":
        return lambda ids: vectors[torch.as_tensor(ids, device=device).long()]
    cache = {}

    def rows(ids):
        key = id(ids)
        if key not in cache:
            cache[key] = search.decode_rows(
                vectors, torch.as_tensor(ids, device=device).long(), dfl_cfg,
                backend=params.fee_backend)
        return cache[key]

    return rows


def _parent_greedy_level(vecs_l, adj_l, queries, cur, *, metric):
    c = cur.long()
    d = fee_mod.exact_distance(queries, vecs_l[c][:, None, :],
                                      metric=metric)[:, 0]
    steps = 0
    while True:
        steps += 1
        nb = adj_l[c].long()
        nd = fee_mod.exact_distance(queries, vecs_l[nb], metric=metric)
        j = torch.argmin(nd, dim=1, keepdim=True)
        ndj = torch.gather(nd, 1, j)[:, 0]
        better = ndj < d
        if not bool(better.any()):
            return c, steps
        c = torch.where(better, torch.gather(nb, 1, j)[:, 0], c)
        d = torch.minimum(ndj, d)


def parent_descent(idx, queries, params, device):
    """The descent as it ran on the host: each level's adjacency copied to
    the device and its ids mapped with ``np.searchsorted`` every call, the
    level's rows read whole (:func:`parent_rows`), and the positions read
    back after each level.  ``queries`` are transformed ones on ``device``;
    returns (entries as (Q,) int32 numpy, greedy steps)."""
    vectors = idx.device_db(params.use_dfloat, params.storage, device)
    fetch = parent_rows(params, vectors, backends._dfloat_cfg(idx, params), device)
    graph = idx.graph
    entries = np.full(len(queries), graph.entry, np.int64)
    steps = 0
    for ids, adj in reversed(graph.levels[1:]):
        pos = np.clip(np.searchsorted(ids, entries), 0, len(ids) - 1)
        cur = np.where(ids[pos] == entries, pos, 0)
        cur, n = _parent_greedy_level(fetch(ids), torch.as_tensor(adj, device=device),
                                      queries, torch.as_tensor(cur, device=device),
                                      metric=idx.metric)
        steps += n
        entries = ids[cur.cpu().numpy()]
    return entries.astype(np.int32), steps


def assert_same(got: dict, want: dict, what: str = "") -> None:
    """Every tensor of the two result dicts equal, bit for bit."""
    assert set(got) == set(want), what
    for k in want:
        assert got[k].dtype == want[k].dtype, (what, k)
        assert torch.equal(got[k], want[k]), (what, k)
