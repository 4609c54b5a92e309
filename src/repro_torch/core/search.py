"""GANNS beam search (HNSW §II-A3) as one batched PyTorch loop.

The JAX package runs each query in its own ``lax.while_loop`` under ``vmap``;
here the whole query batch moves together: every hop pops each query's
frontier, gathers all neighbor lists in one fused gather, and scores the
batch's frontier lanes in ONE kernel launch through the ``kernels.ops``
dispatcher.  A query whose beam has no unexpanded entry is done; a hop is a
no-op for it (it pops nothing, scores nothing and keeps its beam), so the
loop runs until no query is active and gives the same results as the
per-query loops.

Semantics follow the JAX package exactly: a size-``ef`` sorted beam; each hop
pops the ``expand`` nearest unexpanded entries, dedups the gathered ids
against the visited bitmap and across the batch (:func:`first_occurrence_mask`,
both arms), keeps a fresh-first stable compaction of L = max(M,
expand*M*compact) lanes, scores them with FEE against the current threshold
(the farthest beam entry) and merges survivors with one stable sort over
``ef + L`` candidates.  ``lax.top_k`` breaks ties toward the lower index, so
every top-k here is a stable sort: the beam wins ties in :func:`merge_beam`
and the compaction is a stable partition.

Only the lanes that are fresh and not tombstoned are handed to the kernel as
alive: the others never enter the beam in the JAX package either, and the
kernel then moves no bytes for them.

The visited bitmap is (Q, ceil(N/32)) int32 words; the visited update adds
each fresh id's bit, which is an OR only because fresh ids are deduped first.

Trace layout (``trace=True``, ``cfg.hops()`` hops), per query: ``node`` is
(H, E) — the up-to-``expand`` nodes popped per hop (-1 pad) — and
``nbrs``/``segs``/``cand_d``/``src`` are (H, L), the frontier batch after the
compaction in pop order; ``src[j]`` is the pop slot whose neighbor list slot
``j`` came from.  Results carry a leading query axis, as the JAX ``vmap``
output does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import dfloat as dfl
from repro_torch.core import fee as fee_mod
from repro_torch.core.fee import BIG, FeeParams
from repro_torch.kernels import ops as kops

FEE_BACKENDS = kops.BACKENDS
STORAGES = ("f32", "packed", "tiered")
INT32_MAX = 2**31 - 1
# visited-bitmap budget of one query chunk (Q x ceil(N/32) int32 words)
_VISITED_BYTES = 4 << 30


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    ef: int = 64
    k: int = 10
    metric: str = "l2"
    seg: int = 16               # FEE checkpoint granularity (features / access)
    max_hops: int = 0           # 0 -> auto (4*ef expansions / expand per hop)
    use_fee: bool = False
    expand: int = 4             # beam entries popped per hop (frontier batch)
    fee_backend: str = "auto"   # kernels.ops dispatch: auto | jnp | pallas[...]
    storage: str = "f32"        # base vectors: dense f32 | packed Dfloat words
    # fraction of the expand*M frontier batch retained by the fresh-first
    # compaction (lane budget L = max(M, expand*M*compact)); 1.0 keeps every
    # fresh lane (a pure reorder)
    compact: float = 0.5

    def __post_init__(self):
        if self.expand < 1:
            raise ValueError(f"expand must be >= 1, got {self.expand}")
        if not 0.0 < self.compact <= 1.0:
            raise ValueError(f"compact must be in (0, 1], got {self.compact}")
        if self.fee_backend not in FEE_BACKENDS:
            raise ValueError(f"fee_backend={self.fee_backend!r}; expected one "
                             f"of {FEE_BACKENDS}")
        if self.storage not in STORAGES:
            raise ValueError(f"storage={self.storage!r}; expected one of "
                             f"{STORAGES}")

    def hops(self):
        """Hop budget for the traced (fixed-length) path: the 4*ef expansion
        budget spread over ``expand``-wide hops."""
        return self.max_hops or max(-(-4 * self.ef // self.expand), 8)


# Below this frontier width the pairwise compare is used, above it the sort
# (the JAX package's split: the (n, n) compare is quadratic in n)
_DEDUP_SORT_MIN = 256


def first_occurrence_mask(ids, valid):
    """True for the first *valid* occurrence of each id along the last axis.

    Invalid lanes never shadow a real id.  Pairwise compare for narrow
    frontiers, a stable sort-based first-occurrence pass for wide ones.
    """
    n = ids.shape[-1]
    if n < _DEDUP_SORT_MIN:
        key = torch.where(valid, ids.to(torch.int32), -1)
        eq = (key[..., :, None] == key[..., None, :]) & valid[..., None, :]
        earlier = torch.tril(eq, diagonal=-1).any(-1)
        return ~earlier & valid
    key = torch.where(valid, ids.to(torch.int32), INT32_MAX)
    order = torch.argsort(key, dim=-1, stable=True)     # ties keep pop order
    sk = torch.gather(key, -1, order)
    firsts = torch.ones_like(valid)
    firsts[..., 1:] = sk[..., 1:] != sk[..., :-1]
    return torch.zeros_like(valid).scatter(-1, order, firsts) & valid


def compact_width(m: int, e: int, compact: float = 0.5) -> int:
    """Lane budget after the fresh-first frontier compaction of one hop
    (``expand == 1`` hops skip compaction: L = M)."""
    return m if e <= 1 else max(m, int(e * m * compact))


def pop_frontier(beam_ids, beam_d, expanded, e: int):
    """Pop each query's ``e`` nearest unexpanded beam entries.

    Returns (nodes (Q, e), sel (Q, e), expanded'): ``nodes`` is -1 where fewer
    than ``e`` entries are active; inactive picks are already expanded or
    empty (d >= BIG), so setting ``expanded`` on them is a no-op.
    """
    active = ~expanded & (beam_d < BIG)
    done = ~active.any(-1, keepdim=True)
    idxs = torch.argsort(torch.where(active, beam_d, BIG), dim=-1,
                         stable=True)[..., :e]
    sel = torch.gather(active, -1, idxs) & ~done
    nodes = torch.where(sel, torch.gather(beam_ids, -1, idxs), -1)
    return nodes, sel, expanded.scatter(-1, idxs, True)


def merge_beam(beam_ids, beam_d, expanded, cand_ids, cand_d):
    """One stable top-ef merge of the beam with the hop's scored candidates:
    on equal distances beam entries win (they come first)."""
    ef = beam_ids.shape[-1]
    all_ids = torch.cat([beam_ids, cand_ids], dim=-1)
    all_d = torch.cat([beam_d, cand_d], dim=-1)
    all_exp = torch.cat([expanded, torch.zeros_like(cand_d, dtype=torch.bool)],
                        dim=-1)
    order = torch.argsort(all_d, dim=-1, stable=True)[..., :ef]
    beam_d = torch.gather(all_d, -1, order)
    return (torch.gather(all_ids, -1, order), beam_d,
            torch.gather(all_exp, -1, order) | (beam_d >= BIG))


def _bits(ids):
    """The int32 bit of each id within its visited/tombstone word."""
    return torch.ones_like(ids, dtype=torch.int32) << (ids & 31).to(torch.int32)


def tombstone_lookup(tombstone, ids):
    """Dead-bit gather: True where ``ids`` (clamped to >= 0) is tombstoned."""
    safe = ids.clamp(min=0)
    return (tombstone[(safe >> 5).long()] & _bits(safe)) != 0


def exclude_dead(beam_ids, beam_d, tombstone):
    """Final re-rank of the beam with tombstoned entries pushed out: dead
    lanes get dist BIG and id -1, so a dead id never reaches the output."""
    dead = tombstone_lookup(tombstone, beam_ids) & (beam_ids >= 0)
    d = torch.where(dead, BIG, beam_d)
    order = torch.argsort(d, dim=-1, stable=True)
    return (torch.where(torch.gather(dead, -1, order), -1,
                        torch.gather(beam_ids, -1, order)),
            torch.gather(d, -1, order))


def _score(vectors, ids, q, threshold, fee: FeeParams | None, cfg: SearchConfig,
           dfl_cfg: dfl.DfloatConfig | None, alive):
    """FEE/exact distances of the (Q, L) lanes ``ids``, routed through the
    kernel dispatcher.  ``vectors`` is the (N, D) f32 DB or, for
    ``storage="packed"``, the (N, W) packed words; ``alive`` (Q, L) marks the
    lanes to score — the others report rejected with ``segs_used == 0``."""
    packed = cfg.storage == "packed"
    if cfg.use_fee:
        common = dict(seg=cfg.seg, metric=cfg.metric, backend=cfg.fee_backend,
                      lane_mask=alive)
        if packed:
            return kops.fee_distance_packed(vectors, ids, q, threshold,
                                            fee.alpha, fee.beta, fee.margin,
                                            dfloat_cfg=dfl_cfg, **common)
        return kops.fee_distance(vectors, ids, q, threshold, fee.alpha,
                                 fee.beta, fee.margin, **common)
    n_q, lanes = ids.shape
    rows = vectors[ids.long()]
    if packed:
        rows = kops.dfloat_unpack_rows(rows.reshape(n_q * lanes, -1), dfl_cfg,
                                       backend=cfg.fee_backend)
        rows = rows.reshape(n_q, lanes, -1)
    score = fee_mod.exact_distance(q, rows, metric=cfg.metric)
    n_segs = rows.shape[-1] // cfg.seg
    return (score, ~alive,
            torch.where(alive, n_segs, 0).to(torch.int32))


def _hop_body(state, vectors, adj, q, fee: FeeParams | None, cfg: SearchConfig,
              dfl_cfg: dfl.DfloatConfig | None = None, tombstone=None):
    beam_ids, beam_d, expanded, visited = state
    n_q, ef = beam_ids.shape
    e, m = min(cfg.expand, ef), adj.shape[1]
    nodes, sel, expanded = pop_frontier(beam_ids, beam_d, expanded, e)

    # ---- one fused gather of all E neighbor lists
    nbrs = adj[nodes.clamp(min=0).long()].reshape(n_q, e * m)
    valid = (nbrs >= 0) & sel.repeat_interleave(m, dim=1)
    safe = nbrs.clamp(min=0)
    seen = (torch.gather(visited, 1, (safe >> 5).long()) & _bits(safe)) != 0
    fresh = valid & ~seen & first_occurrence_mask(safe, valid)

    # ---- fresh-first frontier compaction (expand > 1): a stable partition,
    # overflowing fresh candidates are dropped unmarked (still discoverable
    # through other parents on later hops)
    if e > 1:
        keep = torch.argsort(fresh.to(torch.int8), dim=1, descending=True,
                             stable=True)[:, : compact_width(m, e, cfg.compact)]
        nbrs, safe, fresh = (torch.gather(t, 1, keep) for t in (nbrs, safe, fresh))
        src = (keep // m).to(torch.int32)
    else:
        src = (torch.arange(e * m, device=nbrs.device, dtype=torch.int32) // m
               ).expand(n_q, -1)
    visited.scatter_add_(1, (safe >> 5).long(),
                         torch.where(fresh, _bits(safe), 0))

    # tombstoned lanes stay visited-marked but are never scored or inserted
    live = fresh if tombstone is None else fresh & ~tombstone_lookup(tombstone, safe)
    threshold = beam_d[:, -1].contiguous()
    score, rejected, segs_used = _score(vectors, safe, q, threshold, fee, cfg,
                                        dfl_cfg, live)

    # ---- single stable top-ef beam merge over (ef + L) candidates
    cand_d = torch.where(fresh & ~rejected, score, BIG)
    beam_ids, beam_d, expanded = merge_beam(beam_ids, beam_d, expanded, safe,
                                            cand_d)
    segs = torch.where(live, segs_used, 0)
    trace = dict(
        node=nodes.to(torch.int32),
        nbrs=torch.where(live, nbrs, -1).to(torch.int32),
        segs=segs.to(torch.int32),
        cand_d=cand_d,                                   # BIG unless accepted
        src=torch.where(live, src, -1).to(torch.int32),  # parent of slot j
        n_eval=live.sum(1).to(torch.int32),
        dims=(segs.sum(1) * cfg.seg).to(torch.int32),
    )
    return (beam_ids, beam_d, expanded, visited), trace


def _init_state(q, entries, vectors, cfg: SearchConfig, n_words,
                dfl_cfg: dfl.DfloatConfig | None = None):
    n_q, ef = q.shape[0], cfg.ef
    row = vectors[entries.long()]
    if cfg.storage == "packed":
        row = kops.dfloat_unpack_rows(row, dfl_cfg, backend=cfg.fee_backend)
    d0 = fee_mod.exact_distance(q, row[:, None, :], metric=cfg.metric)[:, 0]
    dev = q.device
    beam_ids = torch.full((n_q, ef), -1, dtype=torch.int32, device=dev)
    beam_ids[:, 0] = entries
    beam_d = torch.full((n_q, ef), BIG, dtype=torch.float32, device=dev)
    beam_d[:, 0] = d0
    expanded = torch.ones((n_q, ef), dtype=torch.bool, device=dev)
    expanded[:, 0] = False
    visited = torch.zeros((n_q, n_words), dtype=torch.int32, device=dev)
    visited.scatter_(1, (entries >> 5).long()[:, None], _bits(entries)[:, None])
    return beam_ids, beam_d, expanded, visited


def _search_batch(vectors, adj, fee, tombstone, queries, entries, *,
                  cfg: SearchConfig, trace: bool,
                  dfl_cfg: dfl.DfloatConfig | None = None) -> dict:
    """Beam search of one query batch; dict of (Q, ...) tensors."""
    n_words = -(-vectors.shape[0] // 32)
    state = _init_state(queries, entries, vectors, cfg, n_words, dfl_cfg)
    hop = lambda s: _hop_body(s, vectors, adj, queries, fee, cfg, dfl_cfg,
                              tombstone)
    if trace:
        hops = []
        for _ in range(cfg.hops()):
            state, t = hop(state)
            hops.append(t)
        traces = {k: torch.stack([t[k] for t in hops], dim=1) for k in hops[0]}
    else:
        # counters carried through the early-terminating path: n_eval, dims
        # and hops (a hop where at least one node was popped)
        counters = torch.zeros((queries.shape[0], 3), dtype=torch.int64,
                               device=queries.device)
        while True:
            _, beam_d, expanded, _ = state
            if not bool(((~expanded) & (beam_d < BIG)).any()):
                break
            state, t = hop(state)
            counters += torch.stack([t["n_eval"], t["dims"],
                                     (t["node"] >= 0).any(1).to(torch.int32)],
                                    dim=1)
    beam_ids, beam_d = state[0], state[1]
    if tombstone is not None:
        beam_ids, beam_d = exclude_dead(beam_ids, beam_d, tombstone)
    out = dict(ids=beam_ids[:, : cfg.k], dists=beam_d[:, : cfg.k])
    if trace:
        out["trace"] = traces
        out["hops"] = (traces["node"] >= 0).any(-1).sum(-1)
        out["n_eval"] = traces["n_eval"].sum(-1)
        out["dims"] = traces["dims"].sum(-1)
    else:
        out["n_eval"], out["dims"], out["hops"] = counters.to(torch.int32).unbind(1)
    return out


def make_searcher(vectors, adj, cfg: SearchConfig,
                  fee: FeeParams | dict | None = None, trace: bool = False, *,
                  dfloat_cfg: dfl.DfloatConfig | None = None, tombstone=None):
    """Returns search(queries (Q, D), entries (Q,)) -> dict of tensors.

    ``vectors``/``adj`` are tensors on the device the search runs on (the
    (N, D) f32 DB, or for ``cfg.storage == "packed"`` the (N, W) int32 word
    view of the Dfloat bitstream with ``dfloat_cfg`` its layout).
    ``tombstone`` ((ceil(N/32),) int32 words, bit = dead row) masks deleted
    rows out of scoring and results.
    """
    if cfg.storage == "tiered":
        raise NotImplementedError(
            'storage="tiered" needs the tiered FEE kernel, not ported to CUDA '
            "yet: see ROADMAP.md queue A, item 5 and queue B, item 5")
    if cfg.fee_backend == "pallas_skip_dma":
        raise NotImplementedError(
            'fee_backend="pallas_skip_dma" (the manual-DMA TPU kernels) is not '
            "ported to CUDA yet: see ROADMAP.md queue B, item 4")
    packed = cfg.storage == "packed"
    if packed and dfloat_cfg is None:
        raise ValueError('cfg.storage="packed" requires dfloat_cfg=DfloatConfig')
    dev = vectors.device
    fp = FeeParams.coerce(fee, device=dev)
    if cfg.use_fee and fp is None:
        raise ValueError("cfg.use_fee=True requires fee=FeeParams(...) "
                         "(use FeeParams.identity(n_seg) for plain d_part exit)")
    n_rows = vectors.shape[0]
    if tombstone is not None and tuple(tombstone.shape) != (-(-n_rows // 32),):
        raise ValueError(f"tombstone shape {tuple(tombstone.shape)} does not "
                         f"cover {n_rows} rows")
    dfl_cfg = dfloat_cfg if packed else None
    chunk = max(1, _VISITED_BYTES // (4 * -(-n_rows // 32)))

    def search(queries, entries):
        queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
        entries = torch.as_tensor(entries, dtype=torch.int32, device=dev)
        outs = [_search_batch(vectors, adj, fp, tombstone,
                              queries[s: s + chunk].contiguous(),
                              entries[s: s + chunk], cfg=cfg, trace=trace,
                              dfl_cfg=dfl_cfg)
                for s in range(0, queries.shape[0], chunk)]
        if len(outs) == 1:
            return outs[0]
        cat = lambda vs: (torch.cat(vs) if isinstance(vs[0], torch.Tensor)
                          else {k: torch.cat([v[k] for v in vs]) for k in vs[0]})
        return {k: cat([o[k] for o in outs]) for k in outs[0]}

    return search


def _greedy_level(vecs_l, adj_l, queries, cur, *, metric: str):
    """One upper-layer greedy descent for a whole query batch: each query
    moves to its nearest neighbor while that improves its distance (a query
    that stops improving is a fixed point of the step)."""
    c = cur.long()
    d = fee_mod.exact_distance(queries, vecs_l[c][:, None, :], metric=metric)[:, 0]
    while True:
        nb = adj_l[c].long()
        nd = fee_mod.exact_distance(queries, vecs_l[nb], metric=metric)
        j = torch.argmin(nd, dim=1, keepdim=True)      # first minimum
        ndj = torch.gather(nd, 1, j)[:, 0]
        better = ndj < d
        if not bool(better.any()):
            return c
        c = torch.where(better, torch.gather(nb, 1, j)[:, 0], c)
        d = torch.minimum(ndj, d)


def descend_entry(vectors, graph, queries, metric: str) -> np.ndarray:
    """Greedy top-down routing through HNSW upper layers -> base entry ids.

    ``vectors`` is either the dense (N, D) f32 tensor or a callable
    ``ids -> (len(ids), D) f32`` tensor provider; ``queries`` is a tensor on
    the device the descent runs on.
    """
    fetch = vectors if callable(vectors) else (lambda ids: vectors[ids])
    entries = np.full(len(queries), graph.entry, np.int64)
    dev = queries.device
    for ids, adj in reversed(graph.levels[1:]):
        # level ids are sorted by construction (graph.build_graph)
        pos = np.clip(np.searchsorted(ids, entries), 0, len(ids) - 1)
        cur = np.where(ids[pos] == entries, pos, 0)
        cur = _greedy_level(fetch(ids), torch.as_tensor(adj, device=dev),
                            queries, torch.as_tensor(cur, device=dev),
                            metric=metric)
        entries = ids[cur.cpu().numpy()]
    return entries.astype(np.int32)


def search_graph(vectors, graph, queries, cfg: SearchConfig,
                 fee: FeeParams | dict | None = None, trace: bool = False,
                 dfloat_cfg: dfl.DfloatConfig | None = None,
                 descent_vectors=None, tombstone=None) -> dict:
    """Descend to base entries, run base-layer search; numpy result dict.

    ``vectors`` is a tensor on the search device; with ``storage="packed"``
    it is the packed word view and ``descent_vectors`` (dense tensor or
    ``ids -> rows`` callable) supplies the f32 rows of the upper levels
    (default: decoded from ``vectors``).
    """
    if descent_vectors is None:
        if cfg.storage == "packed":
            descent_vectors = lambda ids: kops.dfloat_unpack_rows(
                vectors[torch.as_tensor(ids, device=vectors.device).long()],
                dfloat_cfg, backend=cfg.fee_backend)
        else:
            descent_vectors = vectors
    q = torch.as_tensor(queries, dtype=torch.float32, device=vectors.device)
    entries = descend_entry(descent_vectors, graph, q, cfg.metric)
    out = make_searcher(vectors, torch.as_tensor(graph.base_adjacency,
                                                 device=vectors.device),
                        cfg, fee=fee, trace=trace, dfloat_cfg=dfloat_cfg,
                        tombstone=tombstone)(q, entries)
    to_np = lambda v: ({k: x.cpu().numpy() for k, x in v.items()}
                       if isinstance(v, dict) else v.cpu().numpy())
    return {k: to_np(v) for k, v in out.items()}
