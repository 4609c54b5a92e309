"""MutableIndex: a live serving shard over an immutable base ``Index``.

The JAX package's ``streaming.mutable`` on the port.  The mutation logic is
the same host numpy, op for op; what moves to the device is the one search it
runs, the candidate search of new and starved rows.

Storage model.  All row payloads live in host *capacity arrays* — ``db_rot``,
``db_packed`` (plus, for tier-native specs with ``tier_split`` set, the
coarse/residual tier bitstreams) and the base adjacency are copied once into
arrays with a pre-reserved tail (doubling growth), and every append writes its
burst-aligned packed row in place at the next free slot.  Row ids are stable
forever: deleted slots are never reused, so external references survive
churn.

Visibility is controlled entirely by the tombstone bitmap: tail slots beyond
the current row count are marked dead, appends flip their slots alive,
deletes flip them dead.  A ``freeze()`` snapshot is therefore just the
capacity arrays plus a *copy* of the bitmap handed to an ordinary
:class:`repro_torch.index.Index`; its searchers mask dead rows through the
FEE kernels' lane mask, so snapshots of different generations share the same
payload arrays (copy-on-write: the only in-place writes to live rows are
adjacency patches, and those copy the adjacency first when a snapshot is
outstanding).  A snapshot uploads its arrays to its device at its first
search (``Index.device_db``), once per generation.

Device mirrors.  The candidate search runs over device copies of the
capacity rows, the capacity adjacency and the tail tombstone, kept on the
base index's device.  Appended rows are written into them by row range and
patched adjacency rows by row index before each search; they are
re-allocated only when the capacity grows, so a sub-batch of appends never
re-uploads the capacity arrays.  The search is exact (no FEE, no kernel) and
deterministic (no float atomics), so a WAL replays bit for bit on one device.

Graph repair.  A new row gets out-edges from a greedy-descent beam search
over the current graph followed by the offline build's own occlusion prune
(``core.graph.prune_candidates``, on host tensors) plus the same
deterministic long-edge policy; in-edges are patched by worst-edge
replacement on each chosen neighbor.  Deletes only flip the bitmap; their
in-edges are patched *lazily* — the pending set drains at the next snapshot
boundary (``freeze``), where each affected node re-prunes over its surviving
neighbors plus the deleted node's alive neighbors (the FreshDiskANN shortcut
rule).

Determinism.  Every mutation is logged to a WAL (appends record the raw input
vectors, repairs record exactly when they drained), and every step of the
pipeline — rotation, packing, beam search, prune, seeded long edges — is
deterministic, so replaying the log over the same base reproduces the arrays
bit-for-bit and searches return bit-identical results.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import dfloat as dfl
from repro_torch.core import graph as graph_mod
from repro_torch.core import search as search_mod
from repro_torch.index import Index, SearchParams
from repro_torch.index.types import SearchResult
from repro_torch.obs import default_registry

BIG = 3.0e38


@dataclasses.dataclass
class MutationStats:
    """Host-side mutation counters (fed to ``ndpsim.account_writes``)."""

    rows_appended: int = 0
    rows_deleted: int = 0
    repairs_drained: int = 0   # tombstones whose in-edges have been patched
    relink_rows: int = 0       # in-degree-starved survivors re-linked
    edge_writes: int = 0       # adjacency rows written (new + patched)
    append_s: float = 0.0
    repair_s: float = 0.0


def pack_tombstone(dead: np.ndarray) -> np.ndarray:
    """Bool dead mask -> packed uint32 bitmap (bit ``i`` of word ``i//32``)."""
    n = dead.shape[0]
    words = np.zeros(-(-n // 32), np.uint32)
    idx = np.nonzero(dead)[0]
    np.bitwise_or.at(words, idx >> 5,
                     np.uint32(1) << (idx & 31).astype(np.uint32))
    return words


def tail_tombstone(n: int, capacity: int, device) -> torch.Tensor:
    """(capacity/32,) int32 words with the bits of rows ``>= n`` set: the
    candidate search's mask of the unallocated tail, built on ``device``."""
    words = torch.full((capacity // 32,), -1, dtype=torch.int32, device=device)
    words[: n // 32] = 0
    if n % 32:
        words[n // 32] = -(1 << (n % 32))        # bits n%32 .. 31
    return words


class MutableIndex:
    """A mutable index: base ``Index`` + packed append tail + tombstones.

    ``append``/``delete`` land in generation ``g+1`` while outstanding
    ``freeze()`` snapshots keep serving generation ``g`` untouched.  The
    candidate search and the snapshots run on the base index's device (a
    ``"cuda"`` base raises without a card).
    """

    def __init__(self, base: Index, *, reserve: float = 0.25,
                 ef_build: int = 64, sub_batch: int = 64,
                 relink_floor: int | None = None):
        if base.tombstone is not None:
            raise ValueError("base index already carries a tombstone bitmap; "
                             "wrap the original (unfrozen) index")
        self.device = resolve_device(base.device)
        self.base = base
        self.spec, self.spca, self.fee = base.spec, base.spca, base.fee
        self.dfloat_cfg = base.dfloat_cfg
        self.ef_build = ef_build
        self.sub_batch = sub_batch
        # repair keeps every delete-affected survivor at this alive
        # in-degree or above (default: half the out-degree + 1)
        self.relink_floor = (base.graph.m // 2 + 1 if relink_floor is None
                             else relink_floor)
        self.generation = 0
        self.stats = MutationStats()

        n = base.n
        adj = base.graph.base_adjacency
        self._m_total = adj.shape[1]
        self._n_long = max(0, self._m_total - base.graph.m)
        self._upper = base.graph.levels[1:]
        self._entry = base.graph.entry
        # the candidate search's descent: the fixed upper levels, on the device
        self._levels = base.device_levels(self.device)

        self._n = n
        # tier-native (spec.tier_split set): the (coarse, residual) capacity
        # arrays are maintained in lockstep with db_packed so freeze() hands
        # snapshots tiers without repacking; otherwise Index derives them
        # lazily per snapshot when storage="tiered" is actually requested
        self._tier_feat = (None if base.spec.tier_split is None
                           else base.spec.tier_split * base.spec.seg)
        self._rot = self._packed = self._adj = self._dead = None
        self._coarse = self._resid = None
        self._grow(max(n + 32, int(n * (1 + reserve))), init=True)
        self._adj_shared = False      # outstanding snapshot references _adj
        self._snapshot: tuple[int, Index] | None = None
        self._pending_repair: list[int] = []
        self._wal: list[tuple[str, np.ndarray]] = []   # ops since save_delta
        self._delta_seq = 0           # next delta segment number on disk
        self._delta_path = None       # directory the delta log is bound to
        self.recovery_report = None   # set by load(recover=True)
        # seconds spent in candidate searches (appends and relinks; device
        # time included: each ends in a copy of its results to the host)
        self.candidate_s = 0.0
        # serving-tier hooks: mutations and freeze() are serialized by this
        # reentrant lock (a snapshot watcher may freeze from another thread
        # while a writer appends), and every generation bump notifies the
        # registered listeners (hot-swap triggers).  Listeners run under the
        # lock and must be fast and non-reentrant — set an event, return.
        self._lock = threading.RLock()
        self._listeners: list = []

    # -- serving-tier hooks --------------------------------------------------
    def add_listener(self, fn):
        """Register ``fn(generation)`` to fire after every generation bump
        (append / delete / repair drain).  Called under the mutation lock —
        keep it O(1) (set an event).  Returns ``fn`` for symmetric
        ``remove_listener``."""
        with self._lock:
            self._listeners.append(fn)
        return fn

    def remove_listener(self, fn) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def _bump(self) -> None:
        self.generation += 1
        self._snapshot = None
        for fn in list(self._listeners):
            fn(self.generation)

    # -- trivia --------------------------------------------------------------
    @property
    def n(self) -> int:
        """Allocated rows (stable id space; includes tombstoned rows)."""
        return self._n

    @property
    def n_alive(self) -> int:
        return int((~self._dead[: self._n]).sum())

    @property
    def dim(self) -> int:
        return self.base.dim

    @property
    def capacity(self) -> int:
        return self._rot.shape[0]

    def is_deleted(self, ids) -> np.ndarray:
        return self._dead[np.asarray(ids)]

    def alive_ids(self) -> np.ndarray:
        return np.nonzero(~self._dead[: self._n])[0].astype(np.int32)

    # -- storage growth ------------------------------------------------------
    def _grow(self, cap: int, init: bool = False):
        cap = -(-cap // 32) * 32           # whole tombstone words
        base = self.base
        d, w = base.db_rot.shape[1], base.db_packed.shape[1]
        rot = np.zeros((cap, d), np.float32)
        packed = np.zeros((cap, w), np.uint32)
        adj = np.full((cap, self._m_total), -1, np.int32)
        dead = np.ones(cap, bool)
        if init:
            rot[: self._n] = base.db_rot
            packed[: self._n] = base.db_packed
            adj[: self._n] = base.graph.base_adjacency
            dead[: self._n] = False
        else:
            rot[: self._n] = self._rot[: self._n]
            packed[: self._n] = self._packed[: self._n]
            adj[: self._n] = self._adj[: self._n]
            dead[: self._n] = self._dead[: self._n]
        if self._tier_feat is not None:
            ccfg, rcfg = dfl.split_config(self.dfloat_cfg, self._tier_feat)
            coarse = np.zeros((cap, ccfg.packed_row_bytes() // 4), np.uint32)
            resid = np.zeros((cap, rcfg.packed_row_bytes() // 4), np.uint32)
            if init:
                xc, xr = base.tier_arrays()
                coarse[: self._n], resid[: self._n] = xc, xr
            else:
                coarse[: self._n] = self._coarse[: self._n]
                resid[: self._n] = self._resid[: self._n]
            self._coarse, self._resid = coarse, resid
        self._rot, self._packed, self._adj, self._dead = rot, packed, adj, dead
        # fresh arrays are private by construction; outstanding snapshots
        # keep the old ones alive (copy-on-write for free)
        self._adj_shared = False
        # the candidate search's device mirrors, re-allocated only here;
        # private copies even on the CPU, where ``.to`` would alias the host
        # arrays that snapshots keep
        self._rot_d = torch.from_numpy(rot).to(self.device, copy=True)
        self._adj_d = torch.from_numpy(adj).to(self.device, copy=True)
        self._adj_dirty: set[int] = set()

    def _ensure_capacity(self, need: int):
        if need > self.capacity:
            self._grow(max(need, 2 * self.capacity))

    def _cow_adj(self):
        """Adjacency rows of *live* nodes are the only in-place rewrites;
        copy once per outstanding snapshot before the first such write."""
        if self._adj_shared:
            self._adj = self._adj.copy()
            self._adj_shared = False

    def _sync_adj(self):
        """Write the adjacency rows patched on the host since the last
        search into the device mirror."""
        if self._adj_dirty:
            rows = np.fromiter(sorted(self._adj_dirty), np.int64,
                               len(self._adj_dirty))
            self._adj_d[torch.from_numpy(rows).to(self.device)] = \
                torch.from_numpy(self._adj[rows]).to(self.device)
            self._adj_dirty.clear()

    # -- internal search over the current (mutating) state -------------------
    def _graph_view(self) -> graph_mod.GraphIndex:
        levels = [(np.arange(self.capacity, dtype=np.int32), self._adj)]
        return graph_mod.GraphIndex(levels=levels + list(self._upper),
                                    entry=self._entry, m=self.base.graph.m)

    def _candidates(self, rotated: np.ndarray):
        """Beam-search candidate neighborhoods for already-rotated rows
        (exact distances, like the offline graph build), on the device
        mirrors.

        Unlike the *serving* path, this internal search masks only the
        unallocated capacity tail: tombstoned rows stay traversable — their
        payloads are still resident, and routing through them recovers the
        same candidate quality as inserting before the deletes happened
        (FreshDiskANN-style soft deletes).  Callers drop dead ids from the
        returned lists before pruning.
        """
        t0 = time.perf_counter()
        cfg = search_mod.SearchConfig(
            ef=self.ef_build, k=self.ef_build, metric=self.spec.metric,
            seg=self.spec.seg, use_fee=False)
        self._sync_adj()
        q = torch.from_numpy(np.ascontiguousarray(rotated, np.float32)
                             ).to(self.device)
        entries = search_mod.descend_entry(self._levels, self._rot_d, "f32", None,
                                           q, self.spec.metric)
        out = search_mod.make_searcher(
            self._rot_d, self._adj_d, cfg,
            tombstone=tail_tombstone(self._n, self.capacity, self.device))(
                q, entries)
        ids, dists = out["ids"].cpu().numpy(), out["dists"].cpu().numpy()
        self.candidate_s += time.perf_counter() - t0
        return ids, dists

    def _dists(self, vec: np.ndarray, rows: np.ndarray) -> np.ndarray:
        if self.spec.metric == "l2":
            return ((self._rot[rows] - vec) ** 2).sum(-1)
        return -(self._rot[rows] @ vec)

    # -- mutation ------------------------------------------------------------
    def append(self, vectors: np.ndarray, _log: bool = True) -> np.ndarray:
        """Insert raw (un-rotated) rows; returns their stable global ids.

        Rows are rotated, Dfloat-packed, written in place at the capacity
        tail, and wired into the graph incrementally (descent + occlusion
        prune + reverse-edge patch), ``sub_batch`` rows at a time so later
        sub-batches can land edges on earlier ones.
        """
        vectors = np.ascontiguousarray(vectors, np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None]
        if vectors.shape[1] != self.base.dim:
            raise ValueError(f"append dim {vectors.shape[1]} != index dim "
                             f"{self.base.dim}")
        with self._lock:
            if _log:
                self._wal.append(("append", vectors.copy()))
            t0 = time.perf_counter()
            ids = np.arange(self._n, self._n + len(vectors), dtype=np.int32)
            for s in range(0, len(vectors), self.sub_batch):
                self._append_batch(vectors[s : s + self.sub_batch])
            self.stats.rows_appended += len(vectors)
            self.stats.append_s += time.perf_counter() - t0
            default_registry().counter("streaming.append_rows") \
                .inc(len(vectors))
            self._bump()
        return ids

    def _append_batch(self, batch: np.ndarray):
        b = len(batch)
        self._ensure_capacity(self._n + b)
        n0 = self._n
        xr = self.spca.transform(batch)
        self._rot[n0 : n0 + b] = xr
        self._rot_d[n0 : n0 + b] = torch.from_numpy(xr).to(self.device)
        self._packed[n0 : n0 + b] = dfl.pack_db(xr, self.dfloat_cfg)
        if self._tier_feat is not None:
            xc, xres = dfl.pack_tiers(xr, self.dfloat_cfg, self._tier_feat)
            self._coarse[n0 : n0 + b] = xc
            self._resid[n0 : n0 + b] = xres
        cand_ids, cand_d = self._candidates(xr)
        self._cow_adj()
        m = self.base.graph.m
        for i in range(b):
            nid = n0 + i
            ok = (cand_ids[i] >= 0) & (cand_d[i] < BIG / 2)
            ok &= ~self._dead[np.maximum(cand_ids[i], 0)]   # no dead links
            cids = cand_ids[i][ok]
            nbrs = graph_mod.prune_candidates(
                xr[i], cids, self._rot[cids], self.spec.metric, keep=m)
            row = np.full(self._m_total, -1, np.int32)
            row[: len(nbrs)] = nbrs
            if self._n_long:
                # same navigability policy as the offline build, but seeded
                # per node id so replay is deterministic; over-draw and keep
                # alive targets — a long edge landing on a tombstone would be
                # a permanent dead end (serving never traverses dead rows)
                rng = np.random.default_rng((self.spec.seed, int(nid)))
                draws = rng.integers(0, nid, 4 * self._n_long)
                draws = draws[~self._dead[draws]][: self._n_long]
                row[self._m_total - self._n_long :
                    self._m_total - self._n_long + len(draws)] = draws
            self._adj[nid] = row
            self._adj_dirty.add(nid)
            self.stats.edge_writes += 1
            self._patch_in_edges(nid, nbrs)
        self._dead[n0 : n0 + b] = False
        self._n = n0 + b

    def _patch_in_edges(self, nid: int, nbrs: np.ndarray):
        """Reverse-link the new row from each chosen neighbor ``v``.

        An empty slot is filled outright; a full list only evicts an edge
        ``v -> w`` when the new row *occludes* ``w`` (``d(new, w) < d(v, w)``,
        the RNG diversity rule) — then ``w`` stays reachable through the new
        row and eviction cannot strand old nodes, which plain worst-edge
        replacement measurably does under sustained appends.
        """
        x = self._rot[nid]
        for v in nbrs:
            row = self._adj[v]
            if nid in row:        # relink may re-offer an existing in-edge
                continue
            d_new = float(self._dists(x, np.asarray([v]))[0])
            empty = np.nonzero(row < 0)[0]
            if len(empty):
                row[empty[0]] = nid
            else:
                d_row = self._dists(self._rot[v], row)
                d_tow = self._dists(x, row)        # d(new, w) per slot
                evictable = (d_new < d_row) & (d_tow < d_row)
                if not evictable.any():
                    continue
                worst = int(np.argmax(np.where(evictable, d_row, -np.inf)))
                row[worst] = nid
            self._adj_dirty.add(int(v))
            self.stats.edge_writes += 1

    def delete(self, ids, _log: bool = True) -> int:
        """Tombstone rows: O(1) bitmap flips; in-edges are patched lazily at
        the next snapshot boundary.  Idempotent; returns newly-dead count."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        with self._lock:
            if len(ids) and (ids.min() < 0 or ids.max() >= self._n):
                raise ValueError(f"delete ids out of range [0, {self._n})")
            if _log:
                self._wal.append(("delete", ids.copy()))
            fresh = ids[~self._dead[ids]]
            self._dead[fresh] = True
            self._pending_repair.extend(int(i) for i in fresh)
            self.stats.rows_deleted += len(fresh)
            if len(fresh):
                default_registry().counter("streaming.tombstone_flips") \
                    .inc(len(fresh))
                self._bump()
        return len(fresh)

    def repair(self, _log: bool = True) -> int:
        """Drain the pending-delete queue: patch in-edges of tombstoned rows.

        Dead slots on live nodes are replaced with shortcut edges to the
        tombstone's alive neighbors, then any delete-affected survivor whose
        alive in-degree fell below ``relink_floor`` is re-linked through a
        fresh candidate search (deletions starve the *in*-edges of the
        nodes the tombstones pointed at — shortcuts alone don't restore
        that direction).  Returns the number of tombstones drained.
        """
        with self._lock:
            if not self._pending_repair:
                return 0
            dead_ids = np.unique(np.asarray(self._pending_repair, np.int64))
            self._pending_repair.clear()
            return self._drain_repair(dead_ids, _log=_log)

    def _drain_repair(self, dead_ids: np.ndarray, _log: bool = True) -> int:
        with self._lock:
            return self._drain_repair_locked(dead_ids, _log=_log)

    def _drain_repair_locked(self, dead_ids: np.ndarray,
                             _log: bool = True) -> int:
        t0 = time.perf_counter()
        if _log:
            self._wal.append(("repair", dead_ids.copy()))
        self._cow_adj()
        live = self._adj[: self._n]
        rows = np.unique(np.nonzero(np.isin(live, dead_ids))[0])
        rows = rows[~self._dead[rows]]
        # survivors whose in-degree this drain can starve: the tombstones'
        # former out-neighbors plus every row patched below
        affected = set(int(r) for r in rows)
        for d in dead_ids:
            affected.update(int(x) for x in self._adj[d]
                            if x >= 0 and not self._dead[x])
        for v in rows:
            # minimal patch: only the slots pointing at drained tombstones
            # change — surviving edges (including the navigability-critical
            # long links) are never disturbed, so repeated incremental
            # repairs don't erode the graph the way full re-prunes do.
            row = self._adj[v]
            bad = np.nonzero(np.isin(row, dead_ids))[0]
            keep = set(int(x) for x in row if x >= 0)
            cand = set()
            for d in row[bad]:
                cand.update(int(x) for x in self._adj[d]
                            if x >= 0 and not self._dead[x])
            cand -= keep
            cand.discard(int(v))
            cand = np.sort(np.fromiter(cand, np.int64, len(cand)))
            if len(cand):
                # nearest shortcut targets first (stable ties by id)
                cand = cand[np.argsort(self._dists(self._rot[v], cand),
                                       kind="stable")]
            fill = np.full(len(bad), -1, np.int64)
            fill[: len(cand)] = cand[: len(bad)]
            row[bad] = fill
            self._adj[v] = row
            self._adj_dirty.add(int(v))
            self.stats.edge_writes += 1
        self._relink_starved(np.sort(np.fromiter(affected, np.int64,
                                                 len(affected))))
        self.stats.repairs_drained += len(dead_ids)
        self.stats.repair_s += time.perf_counter() - t0
        default_registry().counter("streaming.repairs_drained") \
            .inc(len(dead_ids))
        self._bump()
        return len(dead_ids)

    def _relink_starved(self, affected: np.ndarray):
        """Restore the alive in-degree floor of delete-affected survivors.

        One batched candidate search over the starved rows, then the same
        guarded reverse-edge patch appends use — their own out-edges are
        left untouched.  O(affected churn), not O(n).
        """
        if not len(affected):
            return
        adj = self._adj[: self._n]
        in_deg = np.zeros(self._n, np.int64)
        alive_lists = adj[~self._dead[: self._n]]
        vals, cnts = np.unique(alive_lists[alive_lists >= 0],
                               return_counts=True)
        in_deg[vals] = cnts
        weak = affected[in_deg[affected] < self.relink_floor]
        if not len(weak):
            return
        cand_ids, cand_d = self._candidates(self._rot[weak])
        for i, w in enumerate(weak):
            ok = ((cand_ids[i] >= 0) & (cand_d[i] < BIG / 2)
                  & ~self._dead[np.maximum(cand_ids[i], 0)]
                  & (cand_ids[i] != w))
            self._patch_in_edges(int(w),
                                 cand_ids[i][ok][: self.base.graph.m])
        self.stats.relink_rows += len(weak)

    # -- snapshots / serving -------------------------------------------------
    def freeze(self) -> Index:
        """Copy-on-write snapshot of the current generation as an ``Index``.

        Drains pending delete repairs first (the lazy boundary), then hands
        the capacity arrays plus a tombstone *copy* to an ordinary Index on
        this index's device — dead rows (tombstones and the unallocated tail)
        are masked by every backend through the FEE lane mask.  Snapshots are
        cached per generation, and later mutations never touch a snapshot's
        arrays.
        """
        with self._lock:
            self.repair()
            if (self._snapshot is not None
                    and self._snapshot[0] == self.generation):
                return self._snapshot[1]
            timings = dict(self.base.timings)
            # ride the mutation counters on the snapshot so the ndpsim backend
            # can account append/repair traffic as write bursts
            # (SimResult.writes)
            timings["mutation"] = dataclasses.asdict(self.stats)
            idx = Index(spec=self.spec, spca=self.spca, fee=self.fee,
                        dfloat_cfg=self.dfloat_cfg, graph=self._graph_view(),
                        db_rot=self._rot, db_packed=self._packed,
                        device=self.device, timings=timings,
                        tombstone=pack_tombstone(self._dead),
                        generation=self.generation,
                        n_rows=self._n,
                        _tiers=(None if self._tier_feat is None
                                else (self._coarse, self._resid)))
            self._adj_shared = True
            self._snapshot = (self.generation, idx)
            return idx

    def searcher(self, backend: str = "local",
                 params: SearchParams | None = None, **opts):
        return self.freeze().searcher(backend, params, **opts)

    def search(self, queries: np.ndarray, params: SearchParams | None = None,
               **kw) -> SearchResult:
        return self.freeze().search(queries, params, **kw)

    # -- persistence (WAL delta log, format v3) ------------------------------
    def save_delta(self, path: str | Path) -> Path:
        """Persist the base (once) + pending ops as a v3 delta segment under
        ``<path>/delta/`` via ``ft.checkpoint``."""
        from repro_torch.streaming import delta

        return delta.save_delta(self, path)

    def replay(self, path: str | Path) -> int:
        """Apply every delta segment under ``<path>/delta/`` in order;
        returns the number of ops applied."""
        from repro_torch.streaming import delta

        return delta.replay(self, path)

    @classmethod
    def load(cls, path: str | Path, recover: bool = False, *, device="cuda",
             **kw) -> "MutableIndex":
        """Base artifact + v3 delta log -> the exact mutated index
        (bit-identical arrays on the same device, hence bit-identical search
        results).  The base loads onto ``device``.

        Default is strict: a corrupted or gapped delta log raises
        :class:`~repro_torch.resilience.CorruptArtifactError` — nothing
        corrupt is ever replayed.  With ``recover=True`` the log is healed
        first (:func:`repro_torch.streaming.delta.recover`): the first bad
        segment and the whole suffix behind it are quarantined, the surviving
        good prefix replays bit-deterministically, and the recovery report is
        attached as ``mi.recovery_report``.
        """
        from repro_torch.streaming import delta

        dev = resolve_device(device)
        report = delta.recover(path) if recover else None
        mi = cls(Index.load(path, device=dev), **kw)
        mi.replay(path)
        mi.recovery_report = report
        return mi

    def _apply(self, kind: str, arr: np.ndarray):
        """Replay one WAL op without re-logging it."""
        if kind == "append":
            self.append(np.asarray(arr, np.float32), _log=False)
        elif kind == "delete":
            self.delete(np.asarray(arr, np.int64), _log=False)
        elif kind == "repair":
            ids = np.asarray(arr, np.int64)
            pending = set(self._pending_repair) - set(int(i) for i in ids)
            self._pending_repair = sorted(pending)
            self._drain_repair(ids, _log=False)
        else:
            raise ValueError(f"unknown delta op kind {kind!r}")

    # -- accounting ----------------------------------------------------------
    def write_stats(self, hw=None):
        """DIMM-NDP write-burst accounting of the mutations so far
        (``ndpsim.account_writes`` over this index's Dfloat layout, with the
        *measured* delta/varint stored-list size of the live adjacency) — a
        model of the paper's hardware, not a time of any device here."""
        from repro_torch.ndpsim.engine import (account_writes,
                                               compressed_list_bytes)
        from repro_torch.ndpsim.timing import NASZIP_2CH

        lb = float(compressed_list_bytes(self._adj[: self._n]).mean())
        return account_writes(self.stats, self.dfloat_cfg, hw or NASZIP_2CH,
                              self._m_total, list_bytes_per_row=lb)
