"""Generation-aware device residency: in-place delta installs for hot swap.

The JAX package's ``repro.index.device`` on the port.  A streaming
:class:`repro_torch.streaming.MutableIndex` never rewrites a payload row once
it is written: appends land at the capacity tail, deletes flip tombstone
bits, and only adjacency rows are patched in place (copy-on-write while a
snapshot is outstanding).  So when a serving tier swaps generation ``g`` for
``g+1`` over the *same* capacity arrays, almost all device-resident bytes
are already right, and re-uploading the whole payload per swap would ship
hundreds of megabytes to move kilobytes.

:class:`DeviceCache` keeps the device tensors of the last installed snapshot
and, on the next install, ships only

  * the appended payload tail (rows ``[prev_n, new_n)`` of the DB),
  * the adjacency rows whose contents changed (a host diff against the
    previous snapshot's copy-on-write adjacency: new tail rows, reverse-edge
    patches and delete repair alike), and
  * the dirtied 32-bit tombstone words,

and splices them into the resident tensors with ``index_copy_`` on the
calling thread's current stream, which orders the splice after every kernel
queued before it (the serve batcher installs between batches on its own
thread).  ``donate=True`` (the JAX package's buffer donation) splices in
place, so device memory holds one copy and the previous generation's tensors
are overwritten; ``donate=False`` clones each tensor first and leaves the
previous generation's tensors intact.  Either way the host-to-device traffic
is only the delta.

The representations are ``Index.device_db``'s: the packed words and both
tiers as int32 bit views, the tombstone as an int32 view of its uint32
words, and f32 storage with ``use_dfloat`` as ``db_rot`` rows quantized on
the device (``dfloat.emulate_db``, bit-identical to the host emulation the
JAX package ships; the bytes shipped are the same f32 row either way).

Every install returns an :class:`UploadStats` with the JAX package's byte
accounting, field for field: update counts are padded to a power of two
(repeating the last update, a no-op write) as the reference pads them to
bound its compiled scatter shapes, and the padding is shipped and counted.

The tensors are seeded into the snapshot's own device cache
(:meth:`Index.seed_device`), so ``Index.searcher(...)`` picks them up.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import dfloat as dfl


def _pow2_pad(n: int) -> int:
    """Next power of two >= n (the reference's bound on scatter shapes)."""
    return 1 << max(0, n - 1).bit_length()


@dataclasses.dataclass
class UploadStats:
    """Byte accounting of one generation install (what actually shipped)."""

    generation: int | None
    mode: str                     # "full" | "delta"
    h2d_bytes: int                # host->device bytes shipped by this install
    full_bytes: int               # what a cold upload of the same gen ships
    tail_rows: int = 0            # appended payload rows shipped
    dirty_adj_rows: int = 0       # adjacency rows that changed content
    dirty_tombstone_words: int = 0
    reused_rows: int = 0          # payload rows NOT re-shipped (the prefix)
    donated: bool = False         # prefix spliced in place
    per_array: dict = dataclasses.field(default_factory=dict)

    @property
    def reupload_fraction(self) -> float:
        return self.h2d_bytes / max(self.full_bytes, 1)


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A device copy of a host array that never aliases it (on the CPU a
    plain ``.to`` would share the host memory, and a later in-place splice
    would write into a retired snapshot's arrays)."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device, copy=True)


class DeviceCache:
    """Keeps one serving snapshot's tensors device-resident across swaps.

    One cache serves one (storage, use_dfloat) representation of one index
    lineage (a ``MutableIndex`` and its ``freeze()`` snapshots) on the
    snapshots' device (``Index.device``).  Call :meth:`install` with each new
    snapshot; the returned stats report how many bytes the swap moved.
    """

    def __init__(self, storage: str = "f32", use_dfloat: bool = True,
                 donate: bool = True):
        self.storage = storage
        self.use_dfloat = use_dfloat
        self.donate = donate
        self._prev = None          # last installed snapshot (host refs)
        self._prev_n = 0           # its allocated row count
        # device tensors; _db holds the coarse tier for storage="tiered" and
        # _db_res the residual tier (each tier delta-uploads independently)
        self._db = self._db_res = self._adj = self._tomb = None

    def reset(self) -> None:
        """Forget the resident generation (the next install is a full one).

        Used by swap rollback: a failed install may have spliced part of the
        new generation into the resident tensors, so neither generation's
        device tensors can be trusted afterwards."""
        self._prev = None
        self._prev_n = 0
        self._db = self._db_res = self._adj = self._tomb = None

    # -- host-side views ----------------------------------------------------
    def _host_db(self, idx, lo: int, hi: int) -> np.ndarray:
        """Payload rows ``[lo, hi)`` as shipped: packed words or coarse-tier
        words as int32, or f32 rows (``db_rot``; with ``use_dfloat`` the
        device quantizes them, :meth:`_quantize`)."""
        if self.storage == "packed":
            return idx.db_packed[lo:hi].view(np.int32)
        if self.storage == "tiered":
            return idx.tier_arrays()[0][lo:hi].view(np.int32)
        return idx.db_rot[lo:hi]

    def _quantize(self, idx):
        """The Dfloat layout the device applies to shipped f32 rows, or None."""
        return idx.dfloat_cfg if self.storage == "f32" and self.use_dfloat else None

    @staticmethod
    def _n_rows(idx) -> int:
        """Allocated prefix length (== capacity for non-snapshot indices)."""
        return idx.n if idx.n_rows is None else idx.n_rows

    def _host_full_nbytes(self, idx) -> int:
        # itemsize is 4 for every representation (f32 or 32-bit words)
        if self.storage == "packed":
            return idx.db_packed.nbytes
        if self.storage == "tiered":
            xc, xr = idx.tier_arrays()
            return xc.nbytes + xr.nbytes
        return idx.db_rot.nbytes   # db_q has db_rot's shape/dtype

    # -- install ------------------------------------------------------------
    def install(self, idx) -> UploadStats:
        """Make ``idx`` the device-resident generation; seed its device cache.

        A first install (or a capacity/representation change) uploads the
        whole payload; any later same-capacity install ships only the delta.
        """
        new_n = self._n_rows(idx)
        full_bytes = (self._host_full_nbytes(idx)
                      + idx.graph.base_adjacency.nbytes
                      + (idx.tombstone.nbytes if idx.tombstone is not None
                         else 0))
        compatible = (
            self._prev is not None
            and self._db is not None
            and self._db.shape[0] == idx.n
            and self._prev.graph.base_adjacency.shape
                == idx.graph.base_adjacency.shape
            and (idx.tombstone is None) == (self._tomb is None)
        )
        if not compatible:
            stats = self._install_full(idx, full_bytes)
        else:
            stats = self._install_delta(idx, new_n, full_bytes)
        self._prev, self._prev_n = idx, new_n
        self._seed(idx)
        return stats

    def _seed(self, idx) -> None:
        dev = str(idx.device)
        db = ((self._db, self._db_res) if self.storage == "tiered"
              else self._db)
        idx.seed_device(("db", self.storage, bool(self.use_dfloat), dev), db)
        idx.seed_device(("adj", dev), self._adj)
        if self._tomb is not None:
            idx.seed_device(("tombstone", dev), self._tomb)

    def prewarm(self, max_updates: int | None = None) -> int:
        """The reference's splice warm-up: for every resident tensor, one
        no-op write (row 0 set to its own value) at every power-of-two update
        count up to ``max_updates`` (default: the capacity); returns the
        number of (tensor, count) pairs.  Nothing compiles in torch, so this
        only keeps the reference's contract (the writes run on the device
        and ship nothing).  Call after :meth:`install`; re-seeds the
        installed snapshot, whose tensors ``donate=False`` replaced."""
        done = 0
        for name in ("_db", "_db_res", "_adj", "_tomb"):
            arr = getattr(self, name)
            if arr is None:
                continue
            cap = arr.shape[0]
            limit = _pow2_pad(min(max_updates or cap, cap))
            row = arr[:1].clone()
            size = 1
            while size <= limit:
                ids = torch.zeros(size, dtype=torch.long, device=arr.device)
                arr = self._write(arr, ids, row.expand(size, *arr.shape[1:]))
                setattr(self, name, arr)
                done += 1
                size *= 2
        if self._prev is not None:
            self._seed(self._prev)
        return done

    def _install_full(self, idx, full_bytes: int) -> UploadStats:
        dev = idx.device
        db = self._host_db(idx, 0, idx.n)
        self._db = _to_device(db, dev)
        cfg = self._quantize(idx)
        if cfg is not None:
            self._db = dfl.emulate_db(self._db, cfg)
        per = dict(db=int(db.nbytes), adj=int(idx.graph.base_adjacency.nbytes),
                   tombstone=int(idx.tombstone.nbytes
                                 if idx.tombstone is not None else 0))
        if self.storage == "tiered":
            res = idx.tier_arrays()[1]
            self._db_res = _to_device(res.view(np.int32), dev)
            per["db_residual"] = int(res.nbytes)
        self._adj = _to_device(idx.graph.base_adjacency.astype(np.int32, copy=False),
                               dev)
        self._tomb = (None if idx.tombstone is None else _to_device(
            idx.tombstone.astype(np.uint32, copy=False).view(np.int32), dev))
        return UploadStats(generation=idx.generation, mode="full",
                           h2d_bytes=sum(per.values()), full_bytes=full_bytes,
                           reused_rows=0, per_array=per)

    def _install_delta(self, idx, new_n: int, full_bytes: int) -> UploadStats:
        prev_n = self._prev_n
        per = {}

        # appended payload tail: rows [prev_n, new_n) — the *only* payload
        # rows whose bytes can differ (MutableIndex never rewrites a row)
        tail_ids = np.arange(prev_n, new_n, dtype=np.int32)
        self._db, per["db"] = self._splice(self._db, tail_ids,
                                           self._host_db(idx, prev_n, new_n),
                                           self._quantize(idx))
        if self.storage == "tiered":
            # each tier splices independently — appended rows ship their
            # coarse and residual words, resident rows ship neither
            self._db_res, per["db_residual"] = self._splice(
                self._db_res, tail_ids,
                idx.tier_arrays()[1][prev_n:new_n].view(np.int32))

        # adjacency: exact host diff vs the previous snapshot's (COW) copy —
        # catches tail rows, reverse-edge patches and repair rewrites alike
        old_adj, new_adj = (self._prev.graph.base_adjacency,
                            idx.graph.base_adjacency)
        if old_adj is new_adj:
            dirty = np.empty(0, np.int32)
        else:
            dirty = np.nonzero((old_adj != new_adj).any(axis=1))[0] \
                .astype(np.int32)
        self._adj, per["adj"] = self._splice(self._adj, dirty, new_adj[dirty])

        # tombstone: dirtied 32-bit words only
        n_words = 0
        if idx.tombstone is not None:
            old_t = self._prev.tombstone
            if old_t is None or old_t.shape != idx.tombstone.shape:
                widx = np.arange(idx.tombstone.shape[0], dtype=np.int32)
            else:
                widx = np.nonzero(old_t != idx.tombstone)[0].astype(np.int32)
            n_words = len(widx)
            self._tomb, per["tombstone"] = self._splice(
                self._tomb, widx,
                idx.tombstone[widx].astype(np.uint32, copy=False).view(np.int32))

        return UploadStats(
            generation=idx.generation, mode="delta",
            h2d_bytes=sum(per.values()), full_bytes=full_bytes,
            tail_rows=new_n - prev_n, dirty_adj_rows=int(len(dirty)),
            dirty_tombstone_words=n_words, reused_rows=prev_n,
            donated=self.donate, per_array=per)

    # -- splice -------------------------------------------------------------
    def _write(self, old: torch.Tensor, ids: torch.Tensor,
               rows: torch.Tensor) -> torch.Tensor:
        """``rows`` written at ``ids`` of ``old``: in place when donating,
        else into a clone (the previous generation's tensor stays intact)."""
        out = old if self.donate else old.clone()
        return out.index_copy_(0, ids, rows)

    def _splice(self, old: torch.Tensor, idx: np.ndarray, rows: np.ndarray,
                quantize=None):
        """Write host ``rows`` at ``idx`` of device tensor ``old``; returns the
        new tensor and the host->device bytes shipped.  The update count is
        padded to the next power of two by repeating the last update (the
        same value written twice: a no-op), as the reference pads it.
        ``quantize`` (a Dfloat layout) rounds shipped f32 rows on the device."""
        if len(idx) == 0:
            return old, 0
        pad = _pow2_pad(len(idx))
        if pad > len(idx):
            idx = np.concatenate([idx, np.repeat(idx[-1:], pad - len(idx))])
            rows = np.concatenate([rows, np.repeat(rows[-1:], pad - len(rows),
                                                   axis=0)])
        shipped = int(idx.nbytes + rows.nbytes)
        ids_t = torch.from_numpy(idx).to(old.device).long()
        rows_t = _to_device(rows, old.device)
        if quantize is not None:
            rows_t = dfl.emulate_db(rows_t, quantize)
        return self._write(old, ids_t, rows_t), shipped
