"""Sharded streaming serving: a MutableIndex behind the query-owner backend
(the JAX package's ``repro.streaming.sharded``).

Couples ``MutableIndex`` (stable-id capacity arrays, tombstone visibility,
incremental graph repair) with the ``sharded`` backend so churn serving
keeps the paper's DaM layout:

  * row->shard ownership is assigned per capacity slot when the slot comes
    into existence and never changes: base rows by the owner policy, every
    reserved or grown tail slot to the least-loaded shard at that moment.
    An append lands in the capacity tail and inherits its slot's owner, so
    resident rows never migrate between shards across generations, and a
    row's local slot is stable under churn (``core.graph.build_dam`` orders
    a shard's slots by global id, and fresh ids are always the largest);
  * visibility changes are shard-local: a delete (or an append flipping its
    slot alive) dirties one 32-bit word of the owning shard's tombstone
    words, and ``touched_words`` returns that (shard, word) set.

Searchers are cached per (generation, params, overlap): serving a frozen
generation again reuses its sharded layout; any mutation bumps the
generation and the next search rebuilds it.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import graph as graph_mod
from repro_torch.index import Index, SearchParams
from repro_torch.index.types import SearchResult
from repro_torch.streaming.mutable import MutableIndex


class ShardedMutableIndex:
    """A :class:`MutableIndex` served through the owner-sharded backend.

    Mutation (``append`` / ``delete`` / ``repair``) delegates to the wrapped
    index; ``searcher``/``search`` build the sharded search over the current
    frozen snapshot, on the index's device, with this object's stable owner
    map.
    """

    def __init__(self, base: Index | MutableIndex, n_shards: int, *,
                 owner_policy: str = "shuffle", seed: int = 0, **mutable_kw):
        self.mutable = (base if isinstance(base, MutableIndex)
                        else MutableIndex(base, **mutable_kw))
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = n_shards
        # base rows by policy; the pre-reserved tail is assigned at once
        # (slots exist the moment capacity does), least-loaded first
        self._owner = np.full(self.mutable.capacity, -1, np.int32)
        n0 = self.mutable.n
        self._owner[:n0] = graph_mod.map_owners(n0, n_shards, owner_policy,
                                                seed=seed)
        self._assign_tail(n0)
        self._cache: tuple | None = None   # ((generation, params, overlap), run)

    # -- ownership -----------------------------------------------------------
    def _assign_tail(self, start: int):
        """Owner of every slot in [start, capacity): round-robin from the
        least-loaded shard (ties by shard id), so consecutive appends spread
        across shards."""
        n_new = self.mutable.capacity - start
        if n_new <= 0:
            return
        load = np.bincount(self._owner[self._owner >= 0],
                           minlength=self.n_shards).astype(np.int64)
        order = np.lexsort((np.arange(self.n_shards), load))
        assign = order[np.arange(n_new) % self.n_shards]
        self._owner = np.concatenate([self._owner[:start], assign.astype(np.int32)])

    def _sync_owner(self):
        if self._owner.shape[0] < self.mutable.capacity:
            self._assign_tail(self._owner.shape[0])

    def owner_of(self, ids) -> np.ndarray:
        """Owning shard of each (allocated or reserved) slot id."""
        self._sync_owner()
        return self._owner[np.asarray(ids)]

    def shard_load(self) -> np.ndarray:
        """Alive rows per shard (the balance appends route against)."""
        self._sync_owner()
        return np.bincount(self._owner[self.mutable.alive_ids()],
                           minlength=self.n_shards)

    def touched_words(self, ids) -> dict[int, np.ndarray]:
        """{owner shard: local tombstone word indices} that a visibility
        flip of ``ids`` dirties; each id maps to one word of one shard."""
        self._sync_owner()
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        own = self._owner[ids]
        out = {}
        for c in range(self.n_shards):
            mine = ids[own == c]
            if len(mine):
                # local slot = rank of the id among the shard's slot ids
                shard_ids = np.nonzero(self._owner == c)[0]
                out[c] = np.unique(np.searchsorted(shard_ids, mine) >> 5)
        return out

    # -- delegated mutation (each bumps the generation) ----------------------
    def append(self, vectors) -> np.ndarray:
        ids = self.mutable.append(vectors)
        self._sync_owner()
        return ids

    def delete(self, ids) -> int:
        return self.mutable.delete(ids)

    def repair(self) -> int:
        return self.mutable.repair()

    def freeze(self) -> Index:
        return self.mutable.freeze()

    @property
    def generation(self) -> int:
        return self.mutable.generation

    @property
    def stats(self):
        return self.mutable.stats

    # -- serving -------------------------------------------------------------
    def searcher(self, params: SearchParams | None = None, *, group=None,
                 overlap: bool = False, **opts):
        """Owner-sharded ``run(queries) -> SearchResult`` over the current
        generation's snapshot: the shards stacked on the index's device, or
        with ``group=`` one shard per rank of that process group (whose size
        must be ``n_shards``).  Cached until the next mutation (not with
        ``group``)."""
        from repro_torch.index import backends

        params = params or SearchParams()
        snap = self.freeze()                 # drains repairs, cached per gen
        self._sync_owner()
        key = (snap.generation, params, overlap)
        if group is None and not opts and self._cache is not None \
                and self._cache[0] == key:
            return self._cache[1]
        run = backends.sharded_searcher(
            snap, params, device=snap.device, n_shards=self.n_shards,
            group=group, owner=self._owner[: snap.n], overlap=overlap, **opts)
        if group is None and not opts:
            self._cache = (key, run)
        return run

    def search(self, queries, params: SearchParams | None = None,
               **kw) -> SearchResult:
        return self.searcher(params, **kw)(queries)
