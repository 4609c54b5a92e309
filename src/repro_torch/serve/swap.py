"""Zero-downtime snapshot hot-swap (the JAX package's ``repro.serve.swap``
on the port).

A :class:`SnapshotWatcher` thread subscribes to a
:class:`repro_torch.streaming.MutableIndex` generation listener (plus a fallback
poll) and, whenever the write stream has advanced, calls ``freeze()`` off
the serving path and publishes the snapshot as the server's *pending*
generation.  The watcher thread does host work only.  The batcher thread —
the only thread that touches device tensors — installs the pending snapshot
*between* batches via :class:`repro_torch.index.DeviceCache`, so:

  * in-flight batches always finish on the generation they started on;
  * the in-place splice (``ServeConfig.donate``) runs on the batcher's
    stream after its last batch's kernels and overwrites no tensor a
    queued search still reads;
  * a swap ships only the appended payload tail, dirtied adjacency rows and
    tombstone words (byte-accounted in ``UploadStats``).

The retired generation's device tensors and searchers are dropped right
after the install: with in-place splices they now hold the new generation.

An install that fails partway (an upload error mid-splice) is rolled back:
the half-written caches are reset and the *previous* serving snapshot is
re-uploaded in full — the in-place splice may already have overwritten its
resident tensors, so a cheap "keep serving the old tensors" is not
available.  Serving
continues on the previous generation; the failed snapshot is dropped (the
watcher re-publishes on the next generation bump).
"""
from __future__ import annotations

import threading

from repro_torch.obs import tracer
from repro_torch.resilience import InjectedCrash, fault_point


class SnapshotWatcher:
    """Background freeze()-er: MutableIndex generations -> pending snapshots."""

    def __init__(self, mutable, publish, poll_s: float = 0.25):
        self.mutable = mutable
        self.publish = publish          # fn(snapshot) -> None
        self.poll_s = poll_s
        self._dirty = threading.Event()
        self._stop = threading.Event()
        self._listener = None
        self._thread = None
        self._last_gen = None

    def start(self) -> None:
        self._listener = self.mutable.add_listener(
            lambda gen: self._dirty.set())
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-snapshot-watcher")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._dirty.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._listener is not None:
            self.mutable.remove_listener(self._listener)

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._dirty.wait(self.poll_s)
            self._dirty.clear()
            if self._stop.is_set():
                return
            gen = self.mutable.generation
            if gen == self._last_gen:
                continue
            snap = self.mutable.freeze()   # thread-safe; off the serve path
            self._last_gen = snap.generation
            self.publish(snap)


class GenerationInstaller:
    """Between-batches device install of a pending snapshot.

    Owns one :class:`DeviceCache` per configured storage; ``maybe_install``
    is called by the batcher thread only, which is what makes the in-place
    splice safe.
    """

    def __init__(self, cfg, metrics=None):
        from repro_torch.index import DeviceCache

        self.caches = {st: DeviceCache(storage=st,
                                       use_dfloat=cfg.use_dfloat
                                       or st == "packed",
                                       donate=cfg.donate)
                       for st in cfg.storages}
        self.metrics = metrics
        self._pending = None
        self._lock = threading.Lock()
        self._install_lock = threading.Lock()   # watchdog restart overlap
        self.serving = None
        self.rollbacks = 0

    def prewarm(self, max_updates: int | None = None) -> int:
        """The reference's splice warm-up over every cache
        (:meth:`DeviceCache.prewarm`); returns the reference's count."""
        return sum(c.prewarm(max_updates) for c in self.caches.values())

    def publish(self, snapshot) -> None:
        with self._lock:
            self._pending = snapshot

    def install(self, snapshot):
        """Upload/splice ``snapshot`` and make it the serving generation.

        Returns the per-cache :class:`UploadStats` list, or ``None`` when the
        install failed and was rolled back to the previous generation."""
        with self._install_lock, tracer.span(
                "swap.install", generation=snapshot.generation):
            prev = self.serving
            try:
                fault_point("serve.swap.install",
                            generation=snapshot.generation)
                stats = [c.install(snapshot) for c in self.caches.values()]
            except InjectedCrash:
                raise
            except Exception:
                tracer.instant("swap.rollback",
                               generation=snapshot.generation)
                self._rollback(snapshot, prev)
                return None
            self.serving = snapshot
            if prev is not None and prev is not snapshot:
                prev.drop_device()  # its tensors were spliced over; searchers stale
            if self.metrics is not None:
                for s in stats:
                    self.metrics.record_swap(s)
            return stats

    def _rollback(self, failed, prev) -> None:
        """Re-upload ``prev`` in full after a half-finished install of
        ``failed``: a partial splice may have overwritten the resident
        tensors, so every cache restarts from clean host arrays."""
        self.rollbacks += 1
        failed.drop_device()
        for c in self.caches.values():
            c.reset()
        if prev is not None:
            prev.drop_device()          # its seeded tensors may hold `failed`
            for c in self.caches.values():
                c.install(prev)
        if self.metrics is not None:
            self.metrics.record_event("swap_rollback")

    def maybe_install(self):
        """Install the pending snapshot if there is one (batcher thread)."""
        with self._lock:
            snap, self._pending = self._pending, None
        if snap is None or snap is self.serving:
            return None
        return self.install(snap)
