"""The serving front door: submit() -> Future[Response].

The JAX package's ``repro.serve.server`` on the port.  A server runs on its
index's device (``Index.device``, or the ``MutableIndex``'s).  One
:class:`Server` owns

  * a bounded :class:`RequestQueue` (shed-on-full backpressure edge),
  * a single batcher thread — forms group batches, runs admission, executes
    the padded fixed-shape program, resolves futures, and installs pending
    generation swaps *between* batches (the invariant that makes in-place
    splices safe); after ``start()`` every device operation of the server
    runs on this thread,
  * optionally a :class:`SnapshotWatcher` thread when serving a
    :class:`repro_torch.streaming.MutableIndex` — ``freeze()``, host work,
    runs there, off the serving path, and only the device delta ships on
    install.

``start()`` runs every cell of the program lattice twice before accepting
traffic (the first run loads the kernels, the second seeds the admission
latency model) and records the cold-start-to-first-response time.  The
port's kernels are built once into ``build/repro_torch_kernels/``, which
persists across restarts: the JAX package's persistent compilation cache
has no counterpart.

Self-healing (all knobs on :class:`ServeConfig`): a failing batch is
bisected so a poisoned request fails alone; consecutive whole-batch
failures trip the admission circuit breaker (queued requests shed fast
until a half-open probe succeeds); and a watchdog thread restarts the
batcher — on a fresh epoch, over the last good serving generation — when
it dies or its heartbeat goes stale (wedged device call).  An abandoned
batcher that later wakes finishes its in-flight batch and exits on the
epoch mismatch; the installer's install lock covers the brief overlap.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np

from repro_torch.obs import tracer
from repro_torch.resilience import InjectedCrash, fault_point
from repro_torch.serve.admission import AdmissionController, LatencyModel
from repro_torch.serve.batcher import fail_timeouts, resolve_batch_safe
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.metrics import Metrics
from repro_torch.serve.queue import RequestQueue
from repro_torch.serve.request import Request, Response
from repro_torch.serve.swap import GenerationInstaller, SnapshotWatcher
from repro_torch.serve.warmup import compile_programs


class Server:
    def __init__(self, index, cfg: ServeConfig | None = None):
        from repro_torch.streaming import MutableIndex

        self.cfg = cfg or ServeConfig()
        self.metrics = Metrics(self.cfg.slo_ms)
        self.queue = RequestQueue(self.cfg.max_queue, self.cfg.shed_on_full)
        self.model = LatencyModel()
        self.admission = AdmissionController(self.cfg, self.model)
        self.installer = GenerationInstaller(self.cfg, self.metrics)
        self._mutable = index if isinstance(index, MutableIndex) else None
        self._static = None if self._mutable is not None else index
        self.watcher: SnapshotWatcher | None = None
        # retained (generation, snapshot) pairs: lets a client (or test)
        # re-verify any response against the exact snapshot that served it
        self.history: deque = deque(maxlen=8)
        self.warmup_info: dict | None = None
        self._dim = getattr(index, "dim", None)   # submit() shape validation
        self._thread: threading.Thread | None = None
        self._running = threading.Event()
        # -- self-healing state ---------------------------------------------
        self._epoch = 0                 # bumped per batcher (re)spawn; an
                                        # abandoned thread exits on mismatch
        self._heartbeat = time.perf_counter()
        self._watchdog: threading.Thread | None = None
        self._stop_watchdog = threading.Event()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Server":
        t0 = time.perf_counter()
        snap = (self._mutable.freeze() if self._mutable is not None
                else self._static)
        self.installer.install(snap)
        if self._mutable is not None:
            # swaps will happen: the reference's splice warm-up (no-op
            # writes at every power-of-two update count)
            self.installer.prewarm()
        self.history.append((snap.generation, snap))
        info = compile_programs(snap, self.cfg, self.model)
        # cold start measured from start() entry: includes the first device
        # upload and the first cell's first run (kernel load included)
        self.metrics.cold_start_ms = (
            (time.perf_counter() - t0
             - (info["total_s"] - info["first_response_s"])) * 1e3)
        self.warmup_info = info
        self._running.set()
        self._spawn_batcher()
        if self.cfg.watchdog:
            self._stop_watchdog.clear()
            self._watchdog = threading.Thread(target=self._watchdog_loop,
                                              daemon=True,
                                              name="serve-watchdog")
            self._watchdog.start()
        if self._mutable is not None:
            self.watcher = SnapshotWatcher(self._mutable,
                                           self.installer.publish,
                                           poll_s=self.cfg.swap_poll_s)
            self.watcher.start()
        self.metrics.start_clock()
        return self

    def stop(self) -> None:
        if self.watcher is not None:
            self.watcher.stop()
            self.watcher = None
        self._stop_watchdog.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout=5)
            self._watchdog = None
        self._running.clear()
        self.queue.close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        for r in self.queue.drain():       # fail, don't drop silently
            r.future.set_result(Response(id=r.id, status="shed",
                                         queue_ms=r.elapsed_ms(),
                                         total_ms=r.elapsed_ms()))

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def generation(self):
        s = self.installer.serving
        return None if s is None else s.generation

    # -- submission ----------------------------------------------------------
    def submit(self, query, k: int | None = None, ef: int | None = None,
               deadline_ms: float | None = None, expand: int | None = None,
               storage: str | None = None) -> Future:
        """Enqueue one query; the Future resolves to a Response."""
        cfg = self.cfg
        k = cfg.k_max if k is None else k
        if not 1 <= k <= cfg.k_max:
            raise ValueError(f"k={k} outside [1, k_max={cfg.k_max}]")
        storage = storage or cfg.storages[0]
        if storage not in cfg.storages:
            raise ValueError(f"storage {storage!r} not served "
                             f"(configured: {cfg.storages})")
        try:
            q = np.asarray(query, np.float32).reshape(-1)
        except (TypeError, ValueError) as e:
            raise ValueError(f"query is not a float vector: {e}") from None
        if self._dim is not None and q.shape[0] != self._dim:
            raise ValueError(f"query has dim {q.shape[0]}, "
                             f"index expects {self._dim}")
        if not np.all(np.isfinite(q)):
            raise ValueError("query contains NaN/Inf values")
        req = Request(query=q,
                      k=k, ef=cfg.ef_buckets[0] if ef is None else ef,
                      expand=cfg.expand if expand is None else expand,
                      storage=storage,
                      deadline_ms=cfg.slo_ms if deadline_ms is None
                      else deadline_ms)
        req.future.add_done_callback(self._record)
        if not self._running.is_set() or not self.queue.put(req):
            req.future.set_result(Response(id=req.id, status="shed"))
        return req.future

    def _record(self, fut: Future) -> None:
        if fut.exception() is None:
            self.metrics.record(fut.result())
        else:
            self.metrics.record_error(fut.exception())

    # -- batcher thread ------------------------------------------------------
    def _spawn_batcher(self) -> None:
        self._epoch += 1
        self._heartbeat = time.perf_counter()
        self._thread = threading.Thread(target=self._serve_loop,
                                        args=(self._epoch,), daemon=True,
                                        name=f"serve-batcher-{self._epoch}")
        self._thread.start()

    def _serve_loop(self, epoch: int) -> None:
        cfg = self.cfg
        breaker = self.admission.breaker
        group_of = lambda r: r.group(cfg)
        while self._running.is_set() and epoch == self._epoch:
            self._heartbeat = time.perf_counter()
            fault_point("serve.loop", epoch=epoch)
            if self.installer.maybe_install() is not None:
                snap = self.installer.serving
                self.history.append((snap.generation, snap))
            batch = self.queue.take_group(group_of, cfg.batch_max,
                                          timeout=0.02,
                                          linger=cfg.max_wait_ms / 1e3)
            if not batch:
                continue
            t_taken_ns = time.perf_counter_ns()
            if not breaker.allow():
                # open breaker: shed without any device work — failing fast
                # beats burning every request's deadline on a broken backend
                now = time.perf_counter()
                for r in batch:
                    if not r.future.done():
                        r.future.set_result(Response(
                            id=r.id, status="shed",
                            queue_ms=r.elapsed_ms(now),
                            total_ms=r.elapsed_ms(now)))
                self.metrics.record_event("breaker_shed", len(batch))
                continue
            serve, timed_out, ef, degraded = self.admission.plan(
                batch, len(self.queue))
            t_admitted_ns = time.perf_counter_ns()
            fail_timeouts(timed_out)
            if not serve:
                continue
            try:
                n_ok, _ = resolve_batch_safe(
                    self.installer.serving, cfg, serve, ef, degraded,
                    model=self.model, bisect=cfg.bisect_retry,
                    resid_metrics=self.metrics, t_taken_ns=t_taken_ns,
                    t_admitted_ns=t_admitted_ns)
            except InjectedCrash as e:     # simulated process death: resolve
                for r in serve:            # in-flight futures, then die (the
                    if not r.future.done():  # watchdog restarts the loop)
                        r.future.set_exception(e)
                raise
            if breaker.record(n_ok > 0):
                self.metrics.record_event("breaker_trip")

    # -- watchdog thread -----------------------------------------------------
    def _watchdog_loop(self) -> None:
        cfg = self.cfg
        while not self._stop_watchdog.wait(cfg.watchdog_poll_s):
            if not self._running.is_set():
                continue
            t, stale = self._thread, (time.perf_counter() - self._heartbeat)
            if t is None:
                continue
            if not t.is_alive():
                self.metrics.record_event("watchdog_restart_dead")
                tracer.instant("watchdog.restart_dead", epoch=self._epoch)
                self._spawn_batcher()
            elif stale > cfg.watchdog_stall_s:
                # wedged mid-batch: abandon it (it exits on epoch mismatch
                # when it wakes) and serve from the last good generation
                self.metrics.record_event("watchdog_restart_stalled")
                tracer.instant("watchdog.restart_stalled", epoch=self._epoch,
                               stale_s=round(stale, 3))
                self._spawn_batcher()
