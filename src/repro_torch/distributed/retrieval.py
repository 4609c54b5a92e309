"""NasZip retrieval as a query-owner sharded program (the JAX package's
``repro.distributed.retrieval``, its ``shard_map`` body written over the
shards a process holds).

This is the paper's data-aware neighbour-list mapping (DaM, Fig. 12) run as
a program:

  * the vector rows are sharded by owner (one shard = one "sub-channel");
    the adjacency is stored pre-partitioned by owner: shard c holds, for
    every node v, the members of v's neighbour list that c owns, as local
    slot ids;
  * each query is owned by one shard, which alone holds its beam; per hop
    the owners pop their frontiers and broadcast them (``expand`` node ids
    and the beam threshold), every shard scores its own partitions of the
    popped lists, keeps its top r = min(L, ef) lanes
    (``core.search.local_topk_reduce``, lossless) and sends them to the
    query's owner only, which merges them into its beam;
  * the visited set is an exact bitmap over each shard's local slots, and
    tombstones are per-shard words indexed by local slot, folded into the
    FEE lane mask;
  * ``overlap=True`` double-buffers the pipeline: hop t's exchange is in
    flight while the owner merges hop t-1's arrivals, and the shards score
    against the previous threshold (safe: the FEE exit test is monotone in
    the threshold, ``kernels.ops.fee_distance_stale``).

The shard body runs over a leading axis of the S shards this process holds
(``distributed.comm``): all C on one device (``LocalShards``) or one per
rank of a process group (``GroupShards``).  Each hop scores every held
shard's lanes in ONE FEE launch: shard s's local slot t is row
``s * n_loc + t`` of the stacked ``(S * n_loc, .)`` view, and the query
rows and thresholds are repeated per shard, so the kernel sees
``(S * Q, L)`` lanes.  Entry rows of packed and tiered storage are decoded
by ``dfloat_unpack`` (an id that names no row decodes as zeros, so the sum
over shards is the resident row).  A query's entry slot is read from the
inverse of ``local_ids``, not scanned for (the reference's ``argmax`` over
the shard's slots).

In sync mode (the default) the search gives the local backend's ids and
distances bit for bit whenever ``cfg.compact == 1.0``; with lossy
compaction the two drop overflowing lanes on different boundaries (per
shard vs global) and agree in recall.

The reference's ``abstract_db`` and ``db_shardings`` serve its multi-pod
dry run on a JAX mesh and have no counterpart here, nor has its
``distributed/compat.py`` (a JAX version shim).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import fee as fee_mod
from repro_torch.core import search as search_mod
from repro_torch.core.fee import BIG, FeeParams
from repro_torch.core.search import SearchConfig
from repro_torch.kernels import ops as kops

# visited-bitmap budget of one query chunk, as in core.search
_VISITED_BYTES = search_mod._VISITED_BYTES


@dataclasses.dataclass(frozen=True)
class ShardedDB:
    """The device layout of the shards one process holds (S of C).

    vectors    (S, n_loc, .)   row shards: f32 rows, or packed words as int32
                               (a bit view of the uint32 bitstream); for
                               tiered storage a (coarse, residual) pair of
                               such tensors, both sharded by the same row
                               map, so residual words never leave their shard
    local_ids  (S, n_loc)      int32 global id of each local slot (-1 pad)
    part_adj   (S, N, Mc)      int32 per-shard neighbour partitions (local
                               slots, -1 pad)
    tombstone  (S, W_loc)      int32 dead-slot words (bit = local slot is
                               tombstoned or padding), or None
    """
    vectors: object
    local_ids: torch.Tensor
    part_adj: torch.Tensor
    tombstone: torch.Tensor | None = None

    @property
    def n_total(self) -> int:
        return self.part_adj.shape[1]


def _rows_tensor(vectors, dtype, dev) -> torch.Tensor:
    """``vectors`` (numpy or tensor) as a tensor on ``dev``: float rows as
    f32 and integer words kept (uint32 as its int32 bit view) unless
    ``dtype`` says otherwise."""
    if isinstance(vectors, np.ndarray):
        if vectors.dtype == np.uint32:
            vectors = vectors.view(np.int32)
        vectors = torch.from_numpy(np.ascontiguousarray(vectors))
    if dtype is None:
        dtype = (vectors.dtype if not torch.is_floating_point(vectors)
                 else torch.float32)
    return vectors.to(device=dev, dtype=dtype)


def build_sharded_db(vectors, dam, dtype=None, tombstone=None, *,
                     shards=None, device="cuda") -> ShardedDB:
    """Pack a ``core.graph.DaMPartition`` into the stacked device layout of
    the shards ``shards`` (default: all of them, as ``LocalShards`` holds
    them; one rank of ``GroupShards`` holds ``(rank,)``).

    ``vectors`` may be the dense float rows, the packed words (the row
    layout is the same) or a (coarse, residual) tier pair, each tier then
    sharded with the same row map; numpy arrays or tensors (a tensor already
    on the device is gathered there).  ``tombstone`` is the global
    dead-row bitmap of an index snapshot ((ceil(N/32),) uint32 or int32
    words); it is re-folded here into per-shard words indexed by local
    slot, with the padding slots marked dead.
    """
    if isinstance(vectors, tuple):
        coarse = build_sharded_db(vectors[0], dam, dtype, tombstone,
                                  shards=shards, device=device)
        resid = build_sharded_db(vectors[1], dam, dtype, shards=shards,
                                 device=device)
        return dataclasses.replace(coarse, vectors=(coarse.vectors, resid.vectors))
    dev = resolve_device(device)
    shards = tuple(range(dam.n_channels)) if shards is None else tuple(shards)
    n_loc = max(len(ids) for ids in dam.local_ids)
    ids = np.full((len(shards), n_loc), -1, np.int32)
    for i, ch in enumerate(shards):
        ids[i, : len(dam.local_ids[ch])] = dam.local_ids[ch]
    rows = _rows_tensor(vectors, dtype, dev)
    ids_t = torch.from_numpy(ids).to(dev)
    vs = rows[ids_t.clamp(min=0).long()]
    vs[ids_t < 0] = 0
    pa = torch.from_numpy(np.stack([dam.part_adj[ch] for ch in shards])).to(dev)
    tomb = None
    if tombstone is not None:
        tombstone = np.asarray(tombstone).view(np.uint32)
        tomb = np.zeros((len(shards), -(-n_loc // 32)), np.uint32)
        slot = np.arange(n_loc)
        for i, ch in enumerate(shards):
            dead = np.ones(n_loc, bool)                   # padding slots: dead
            g = np.asarray(dam.local_ids[ch], np.int64)
            bit = (tombstone[g >> 5] >> (g & 31).astype(np.uint32)) & 1
            dead[: len(g)] = bit.astype(bool)
            idx = slot[dead]
            np.bitwise_or.at(tomb[i], idx >> 5,
                             np.uint32(1) << (idx & 31).astype(np.uint32))
        tomb = torch.from_numpy(tomb.view(np.int32)).to(dev)
    return ShardedDB(vs, ids_t, pa, tomb)


def collective_payload(cfg: SearchConfig, mc: int, c: int) -> dict:
    """Per-query per-hop collective payload accounting (8 B = id + dist
    lane), the reference's model: ``flat_*`` is the topology the owner
    design replaced (every shard all-gathers its full L-lane batch to every
    shard), ``hier_*`` the owner-sharded one (each shard ships its lossless
    top-r to the owner only, plus the frontier broadcast of E ids and one
    threshold to C-1 shards)."""
    e = max(1, min(cfg.expand, cfg.ef))
    l = search_mod.compact_width(mc, e, cfg.compact)
    r = min(l, cfg.ef)
    frontier_bytes = 4 * (c - 1) * (e + 1)
    return dict(
        n_shards=c, expand=e, local_lanes=l, reduce_width=r,
        flat_lanes_per_query=c * l,        # lanes landing on EVERY shard
        owner_lanes_per_query=c * r,       # lanes landing on the owner only
        flat_fabric_bytes_per_query=8 * c * (c - 1) * l,
        hier_fabric_bytes_per_query=8 * (c - 1) * r + frontier_bytes,
        frontier_bytes_per_query=frontier_bytes,
    )


def _flat(vectors):
    """The stacked (S * n_loc, .) view of a shard stack (or of both tiers)."""
    if isinstance(vectors, tuple):
        return tuple(_flat(v) for v in vectors)
    return vectors.reshape(-1, vectors.shape[-1])


def make_sharded_searcher(comm, cfg: SearchConfig, n_total: int,
                          fee: FeeParams | dict | None = None,
                          n_bits_log2: int = 23, *, dfloat_cfg=None,
                          tombstone=None, overlap: bool = False):
    """Returns ``search(db: ShardedDB, queries (Q, D), entries (Q,)) ->
    (ids, dists, hops)`` on the db's device, for the shards of ``comm``
    (``distributed.comm.LocalShards`` or ``GroupShards``): (Q, k) ids and
    distances, and (Q,) int32 hops (those in which the query's owner popped
    a node: the local search's ``hops`` counter, which the reference's
    sharded search does not return).

    ``storage="packed"`` needs ``dfloat_cfg`` (the layout of the packed
    rows), ``storage="tiered"`` the (coarse, residual) pair of layouts.
    ``tombstone`` is a flag: truthy means the db carries per-shard dead-slot
    words.  ``overlap=True`` selects the double-buffered pipeline
    (stale-threshold scoring, merge deferred one hop; equal in recall, not
    bit for bit).  ``n_bits_log2`` is accepted and ignored, as in the
    reference (the visited set is exact).  Queries are padded to a multiple
    of C by repeating the first; results come back in input order.
    """
    del n_bits_log2
    c = comm.n_shards
    packed = cfg.storage == "packed"
    tiered = cfg.storage == "tiered"
    if cfg.use_fee and fee is None:
        raise ValueError("cfg.use_fee=True requires fee=FeeParams(...)")
    if packed and dfloat_cfg is None:
        raise ValueError('cfg.storage="packed" requires dfloat_cfg=DfloatConfig')
    if tiered and not (isinstance(dfloat_cfg, tuple) and len(dfloat_cfg) == 2):
        raise ValueError('cfg.storage="tiered" requires dfloat_cfg='
                         "(coarse_cfg, resid_cfg)")
    dfl_cfg = dfloat_cfg if packed or tiered else None
    has_tomb = bool(tombstone is not None and tombstone is not False)
    e = min(cfg.expand, cfg.ef)
    bits = search_mod._bits

    def decode(flat, ids):
        """f32 rows ``ids`` ((n,) int64) of the stacked view; an id < 0
        gives a row of zeros."""
        if dfl_cfg is not None:
            return search_mod.decode_rows(flat, ids, dfl_cfg,
                                          backend=cfg.fee_backend)
        return torch.where((ids >= 0)[:, None], flat[ids.clamp(min=0)], 0.0)

    def score(flat, rows, q_rep, thr_rep, live, fp):
        """(dist, admit) of the (S * Q, L) lanes ``rows`` of the stacked view
        in one launch; exit and admit at the same threshold (the hop's, or
        the stale one in overlap mode)."""
        if cfg.use_fee:
            dist, admit, _ = kops.fee_distance_stale(
                flat, rows, q_rep, thr_rep, thr_rep, fp.alpha, fp.beta,
                fp.margin, seg=cfg.seg, metric=cfg.metric,
                backend=cfg.fee_backend, lane_mask=live, dfloat_cfg=dfl_cfg)
            return dist, admit
        n, lanes = rows.shape
        x = decode(flat, rows.reshape(-1).long()).reshape(n, lanes, -1)
        dist = fee_mod.exact_distance(q_rep, x, metric=cfg.metric)
        return dist, (dist < thr_rep[:, None]) & live

    def body(db: ShardedDB, flat, fp, queries, entries, held_of, slot_of):
        s_held, n_loc = db.local_ids.shape
        mc = db.part_adj.shape[2]
        l = search_mod.compact_width(mc, e, cfg.compact)
        r = min(l, cfg.ef)
        n_q, dim = queries.shape
        q_own = n_q // c
        dev = queries.device
        shard = torch.arange(s_held, device=dev)
        base = (shard * n_loc)[:, None, None]       # row of slot 0 per shard
        own = torch.tensor(comm.shards, device=dev)
        tomb = db.tombstone if has_tomb else None

        # ---- seed: each entry's row, from its one resident shard (a sum
        # over shards of rows that are zero elsewhere), and its visited bit
        ent = entries.long()
        slots0 = torch.where(held_of[ent][None] == shard[:, None],
                             slot_of[ent][None], -1)             # (S, Q)
        rows0 = decode(flat, torch.where(slots0 >= 0, base[:, :, 0] + slots0,
                                         -1).reshape(-1))
        rows0 = comm.sum(rows0.reshape(s_held, n_q, dim))       # (Q, D)
        safe0 = slots0.clamp(min=0)
        bit0 = torch.where(slots0 >= 0, bits(safe0), 0)
        w_loc = -(-n_loc // 32)
        visited = torch.zeros((s_held, n_q, w_loc), dtype=torch.int32, device=dev)
        visited.scatter_add_(2, (safe0 >> 5)[..., None], bit0[..., None])
        if has_tomb:
            dead0 = (torch.gather(tomb, 1, safe0 >> 5) & bit0) != 0
            entry_dead = comm.sum(dead0.to(torch.int32)) > 0     # (Q,)

        # ---- owner-only beam state for this process's query chunks
        my_q = queries.reshape(c, q_own, dim)[own]
        my_ent = entries.reshape(c, q_own)[own]
        my_rows0 = rows0.reshape(c, q_own, dim)[own]
        d0 = fee_mod.exact_distance(my_q.reshape(-1, dim),
                                    my_rows0.reshape(-1, 1, dim),
                                    metric=cfg.metric)[:, 0]
        beam_ids = torch.full((s_held, q_own, cfg.ef), -1, dtype=torch.int32,
                              device=dev)
        beam_ids[..., 0] = my_ent
        beam_d = torch.full((s_held, q_own, cfg.ef), BIG, dtype=torch.float32,
                            device=dev)
        beam_d[..., 0] = d0.reshape(s_held, q_own)
        expanded = torch.ones((s_held, q_own, cfg.ef), dtype=torch.bool, device=dev)
        expanded[..., 0] = False
        hops = torch.zeros((s_held, q_own), dtype=torch.int32, device=dev)
        q_rep = queries.repeat(s_held, 1)                        # (S * Q, D)

        def score_local(nodes, sel, thr):
            """Every held shard's partitions of the popped lists -> its
            top-r lanes per query, (S, Q, r) ids and distances."""
            slots = db.part_adj[:, nodes.clamp(min=0).reshape(-1).long()
                                ].reshape(s_held, n_q, e * mc)
            valid = (slots >= 0) & sel.repeat_interleave(mc, dim=1)[None]
            safe = slots.clamp(min=0)
            seen = (torch.gather(visited, 2, (safe >> 5).long()) & bits(safe)) != 0
            # exact local-slot dedup: a global id has one slot on one shard
            fresh = valid & ~seen & search_mod.first_occurrence_mask(slots, valid)
            if e > 1:
                # the local hop's fresh-first stable compaction, per shard
                keep = torch.argsort(fresh.to(torch.int8), dim=-1,
                                     descending=True, stable=True)[..., :l]
                safe, fresh = (torch.gather(t, 2, keep) for t in (safe, fresh))
            word = (safe >> 5).long()
            visited.scatter_add_(2, word, torch.where(fresh, bits(safe), 0))
            live = fresh
            if tomb is not None:
                dead = torch.gather(tomb, 1, word.reshape(s_held, -1)
                                    ).reshape(word.shape) & bits(safe)
                live = fresh & (dead == 0)
            rows = (base + safe).to(torch.int32).reshape(s_held * n_q, l)
            dist, admit = score(flat, rows, q_rep, thr.repeat(s_held),
                                live.reshape(s_held * n_q, l), fp)
            cand_d = torch.where(fresh & admit.reshape(fresh.shape),
                                 dist.reshape(fresh.shape), BIG)
            gids = torch.gather(db.local_ids, 1, safe.reshape(s_held, -1).long()
                                ).reshape(safe.shape)
            gids = torch.where(cand_d < BIG, gids, -1)
            return search_mod.local_topk_reduce(gids, cand_d, r)

        def local_pass(nodes, sel, thr):
            """Broadcast the owners' frontiers, score everywhere, and start
            delivering each shard's top-r to the owners; returns a function
            that waits for the arrivals, (S, q_own, C * r) ids and
            distances in source-shard order."""
            front = comm.all_gather(torch.cat(
                [nodes, sel.to(torch.int32), thr.view(torch.int32)[..., None]],
                dim=-1)).reshape(n_q, 2 * e + 1)
            g_r, d_r = score_local(front[:, :e], front[:, e: 2 * e] != 0,
                                   front[:, 2 * e].contiguous().view(torch.float32))
            lanes = torch.stack([g_r, d_r.view(torch.int32)], dim=-1)
            finish = comm.all_to_all(lanes.reshape(s_held, c, q_own, r, 2))

            def arrivals():
                arr = finish().permute(0, 2, 1, 3, 4).reshape(s_held, q_own, c * r, 2)
                return (arr[..., 0].contiguous(),
                        arr[..., 1].contiguous().view(torch.float32))

            return arrivals

        def go_flag(beam_d, expanded, pend_d=None):
            active = ((~expanded) & (beam_d < BIG)).reshape(s_held, -1).any(1)
            if pend_d is not None:
                active |= (pend_d < BIG).reshape(s_held, -1).any(1)
            return bool(comm.sum(active.to(torch.int32)) > 0)

        if not overlap:
            while go_flag(beam_d, expanded):
                nodes, sel, expanded = search_mod.pop_frontier(beam_ids, beam_d,
                                                               expanded, e)
                hops += sel.any(-1)
                arr_ids, arr_d = local_pass(nodes, sel, beam_d[..., -1])()
                beam_ids, beam_d, expanded = search_mod.merge_beam(
                    beam_ids, beam_d, expanded, arr_ids, arr_d)
        else:
            p_ids = torch.full((s_held, q_own, c * r), -1, dtype=torch.int32,
                               device=dev)
            p_d = torch.full((s_held, q_own, c * r), BIG, dtype=torch.float32,
                             device=dev)
            while go_flag(beam_d, expanded, p_d):
                # pop and broadcast from the stale beam: last hop's arrivals
                # are merged while this hop's exchange is in flight, and the
                # merge is the re-filter of what the stale threshold admitted
                nodes, sel, expanded = search_mod.pop_frontier(beam_ids, beam_d,
                                                               expanded, e)
                hops += sel.any(-1)
                pending = local_pass(nodes, sel, beam_d[..., -1])
                beam_ids, beam_d, expanded = search_mod.merge_beam(
                    beam_ids, beam_d, expanded, p_ids, p_d)
                p_ids, p_d = pending()

        if has_tomb:
            # scoring drops dead candidates before the beam; only the seeded
            # entry can be a dead beam resident: push it out with one sort
            my_dead = entry_dead.reshape(c, q_own)[own]
            dead = ((beam_ids == my_ent[..., None]) & my_dead[..., None]
                    & (beam_ids >= 0))
            d = torch.where(dead, BIG, beam_d)
            order = torch.argsort(d, dim=-1, stable=True)
            beam_ids = torch.where(torch.gather(dead, -1, order), -1,
                                   torch.gather(beam_ids, -1, order))
            beam_d = torch.gather(d, -1, order)
        ids = comm.all_gather(beam_ids[..., : cfg.k].contiguous())
        dists = comm.all_gather(beam_d[..., : cfg.k].contiguous())
        return (ids.reshape(n_q, cfg.k), dists.reshape(n_q, cfg.k),
                comm.all_gather(hops).reshape(n_q))

    def search(db: ShardedDB, queries, entries):
        lead = db.vectors[0] if tiered else db.vectors
        dev = lead.device
        if db.n_total != n_total:
            raise ValueError(f"db holds {db.n_total} nodes, searcher built for "
                             f"{n_total}")
        if db.local_ids.shape[0] != len(comm.shards):
            raise ValueError(f"db holds {db.local_ids.shape[0]} shards, the "
                             f"communicator {len(comm.shards)}")
        if has_tomb and db.tombstone is None:
            raise ValueError("searcher built with tombstone=True needs a "
                             "ShardedDB carrying per-shard tombstone words")
        fp = FeeParams.coerce(fee, device=dev)
        queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
        entries = torch.as_tensor(entries, dtype=torch.int32, device=dev)
        q0 = queries.shape[0]
        if q0 == 0:
            return (torch.empty((0, cfg.k), dtype=torch.int32, device=dev),
                    torch.empty((0, cfg.k), dtype=torch.float32, device=dev),
                    torch.empty((0,), dtype=torch.int32, device=dev))
        pad = (-q0) % c
        if pad:
            queries = torch.cat([queries, queries[:1].expand(pad, -1)])
            entries = torch.cat([entries, entries[:1].expand(pad)])
        # the inverse of local_ids over the held shards: which held shard
        # (and slot) holds each global id, -1 where none does
        s_held, n_loc = db.local_ids.shape
        gid = db.local_ids.reshape(-1).long()
        ok = gid >= 0
        pos = torch.arange(s_held * n_loc, device=dev)[ok]
        held_of = torch.full((n_total,), -1, dtype=torch.int64, device=dev)
        slot_of = torch.full((n_total,), -1, dtype=torch.int64, device=dev)
        held_of[gid[ok]] = pos // n_loc
        slot_of[gid[ok]] = pos % n_loc
        flat = _flat(db.vectors)
        per_query = 4 * s_held * -(-n_loc // 32)
        chunk = max(c, _VISITED_BYTES // per_query // c * c)
        outs = [body(db, flat, fp, queries[s: s + chunk].contiguous(),
                     entries[s: s + chunk].contiguous(), held_of, slot_of)
                for s in range(0, queries.shape[0], chunk)]
        return tuple(torch.cat(parts)[:q0] for parts in zip(*outs))

    return search

