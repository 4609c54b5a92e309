"""Chaos smoke: seeded fault schedule against the full serve+durability stack.

  PYTHONPATH=src python -m repro_torch.launch.chaos --report chaos.json \
      --events chaos_events.json --check [--device cuda|cpu]

The JAX package's ``launch/chaos.py`` on the port; everything runs on
``--device`` (default ``cuda``, which raises without a card).  Three phases,
one process:

  A. serve-under-faults — a live Server over a churning MutableIndex takes
     Poisson traffic while a seeded FaultPlan injects a poisoned request,
     a window of failing batches (trips the circuit breaker), a wedged and
     a crashed batcher iteration (watchdog restarts), and a failing
     generation install (swap rollback).  Asserts every submitted future
     resolves and every self-healing mechanism actually fired.
  B. crash-recovery — acked WAL flushes survive a torn-write crash during
     the next flush: reload with recovery loses zero acked ops and replays
     bit-identically across two loads.
  C. corruption sweep — torn npz, read-path bit flip, WAL byte flip, log
     gap, deleted manifest: every corruption is *detected* (CorruptArtifact
     or quarantine), nothing loads silently wrong.

``--check`` turns the report into a gate (non-zero exit on any violation);
``--events`` writes the fault-event log artifact.
"""
import argparse
import json
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path


def _phase_a(idx, db, args, report, event_log):
    """Serve under faults: poison, breaker window, stall, crash, bad swap."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.resilience import FaultPlan, FaultSpec, active_plan
    from repro_torch.serve import ServeConfig, Server
    from repro_torch.streaming import MutableIndex

    print("[A] serve-under-faults", flush=True)
    obs.enable_tracing()
    obs.tracer.clear()
    rng = np.random.default_rng(args.seed)
    mi = MutableIndex(idx, reserve=0.5)
    cfg = ServeConfig(
        ef_buckets=(16, 32), batch_buckets=(1, 4, 8), k_max=8,
        slo_ms=10_000.0, swap_poll_s=0.05,
        breaker_threshold=3, breaker_cooldown_s=0.3,
        watchdog_poll_s=0.05, watchdog_stall_s=0.4)
    plan = FaultPlan({
        "serve.batch_exec": (
            FaultSpec("poison", at=(2,)),
            FaultSpec("raise", after=30, until=75,
                      message="injected backend failure window"),
        ),
        "serve.loop": (
            FaultSpec("delay", at=(40,), delay_s=1.0),   # wedged -> watchdog
            FaultSpec("crash", at=(220,)),               # dead   -> watchdog
        ),
        "serve.swap.install": FaultSpec("raise", at=(0,)),
    }, seed=args.seed)

    wal = Path(args.workdir) / "wal_serve"
    acked_rows = 0
    futs = []
    with Server(mi, cfg) as srv:
        with active_plan(plan):
            t_end = time.perf_counter() + args.duration
            next_churn = time.perf_counter() + 0.5
            while time.perf_counter() < t_end:
                q = np.asarray(db.vectors[rng.integers(0, db.n)])
                futs.append(srv.submit(q, deadline_ms=10_000))
                if time.perf_counter() >= next_churn:
                    batch = rng.standard_normal((4, db.dim)) \
                        .astype(np.float32)
                    mi.append(batch)
                    mi.save_delta(wal)       # returning == acked
                    acked_rows += len(batch)
                    next_churn += 0.5
                time.sleep(float(rng.exponential(1.0 / args.rps)))
            statuses = {}
            unresolved = n_poisoned = n_errored = 0
            for f in futs:
                try:
                    e = f.exception(timeout=30)
                except TimeoutError:
                    unresolved += 1
                    continue
                if e is not None:
                    n_errored += 1
                    if "poisoned" in str(e):
                        n_poisoned += 1
                else:
                    st = f.result().status
                    statuses[st] = statuses.get(st, 0) + 1
        summary = srv.metrics.summary()
        registry_snapshot = srv.metrics.registry.snapshot()
    obs.disable_tracing()

    # span timeline around each injected fault (+/- 50 ms window): shows
    # what the serving pipeline was doing when the fault fired — e.g. the
    # requests in flight around a watchdog restart or a failed install
    fault_timelines = []
    for e in plan.events:
        spans = obs.tracer.window(e.t - 0.05, e.t + 0.05)
        fault_timelines.append(dict(
            point=e.point, kind=e.kind, hit=e.hit,
            n_spans=len(spans),
            spans=[s.to_dict() for s in spans[:40]]))

    # zero acked appends lost: reload the WAL strict and count rows
    from repro_torch.streaming import MutableIndex as MI
    mi2 = MI.load(wal, device=idx.device)
    lost = (idx.n + acked_rows) - mi2.n

    ev = summary.get("events", {})
    report["serve"] = dict(
        submitted=len(futs), unresolved=unresolved, errored=n_errored,
        poisoned_failures=n_poisoned, statuses=statuses,
        acked_append_rows=acked_rows, acked_rows_lost=int(lost),
        breaker_trips=ev.get("breaker_trip", 0),
        breaker_shed=ev.get("breaker_shed", 0),
        watchdog_restarts=(ev.get("watchdog_restart_dead", 0)
                           + ev.get("watchdog_restart_stalled", 0)),
        swap_rollbacks=ev.get("swap_rollback", 0),
        errors_metric=summary["errors"],
        errors_by_type=summary.get("errors_by_type", {}),
        registry=registry_snapshot,
        resilience_counters={
            k: v for k, v in obs.default_registry().snapshot().items()
            if k.startswith("resilience.")},
        fault_timelines=fault_timelines)
    event_log.extend(dict(phase="A", **e) for e in plan.log())
    print(f"    {len(futs)} submitted, {unresolved} unresolved, "
          f"{n_errored} errored ({n_poisoned} poisoned), {statuses}",
          flush=True)
    print(f"    events: {ev}  acked rows lost: {lost}", flush=True)


def _phase_b(idx, args, report, event_log):
    """Acked flushes survive a torn-write crash; replay is bit-identical."""
    import numpy as np

    from repro_torch.resilience import FaultPlan, FaultSpec, InjectedCrash, \
        active_plan
    from repro_torch.streaming import MutableIndex

    print("[B] crash-recovery", flush=True)
    rng = np.random.default_rng(args.seed + 1)
    wal = Path(args.workdir) / "wal_crash"
    mi = MutableIndex(idx, reserve=0.5)
    acked_rows = 0
    for _ in range(4):
        batch = rng.standard_normal((6, idx.dim)).astype(np.float32)
        mi.append(batch)
        mi.save_delta(wal)
        acked_rows += len(batch)

    # the 5th flush dies mid-write: arrays.npz torn, process "gone"
    plan = FaultPlan({"ckpt.write_arrays":
                      FaultSpec("torn_write", at=(0,))}, seed=args.seed)
    crashed = False
    mi.append(rng.standard_normal((6, idx.dim)).astype(np.float32))
    with active_plan(plan):
        try:
            mi.save_delta(wal)
        except InjectedCrash:
            crashed = True
    event_log.extend(dict(phase="B", **e) for e in plan.log())

    m1 = MutableIndex.load(wal, recover=True, device=idx.device)
    m2 = MutableIndex.load(wal, device=idx.device)
    s1, s2 = m1.freeze(), m2.freeze()
    bit_identical = (
        m1.n == m2.n
        and np.array_equal(s1.db_packed[:m1.n], s2.db_packed[:m2.n])
        and np.array_equal(s1.graph.base_adjacency[:m1.n],
                           s2.graph.base_adjacency[:m2.n]))
    lost = (idx.n + acked_rows) - m1.n
    report["crash_recovery"] = dict(
        crashed=crashed, acked_append_rows=acked_rows,
        acked_rows_lost=int(lost), bit_identical_replay=bool(bit_identical),
        recovery_report=m1.recovery_report)
    print(f"    torn-write crash: {crashed}, acked rows lost: {lost}, "
          f"bit-identical replay: {bit_identical}", flush=True)


def _phase_c(idx, args, report, event_log):
    """Every corruption is detected — nothing loads silently wrong."""
    import numpy as np

    from repro_torch.index import CorruptArtifactError, Index
    from repro_torch.resilience import FaultPlan, FaultSpec, active_plan
    from repro_torch.streaming import MutableIndex, delta

    print("[C] corruption sweep", flush=True)
    rng = np.random.default_rng(args.seed + 2)
    work = Path(args.workdir)

    def fresh_wal(name, n_segments=3):
        wal = work / name
        mi = MutableIndex(idx, reserve=0.5)
        for _ in range(n_segments):
            mi.append(rng.standard_normal((4, idx.dim)).astype(np.float32))
            mi.save_delta(wal)
        return wal

    def flip_byte(path: Path, offset: int = 100):
        data = bytearray(path.read_bytes())
        data[offset % len(data)] ^= 0x01
        path.write_bytes(bytes(data))

    cases = []

    def check(name, fn, expect_quarantine=None):
        try:
            fn()
            detected = False
            detail = "loaded silently (NOT detected)"
        except (CorruptArtifactError, ValueError) as e:
            detected = True
            detail = f"{type(e).__name__}: {str(e)[:110]}"
        cases.append(dict(case=name, detected=detected, detail=detail,
                          quarantine=expect_quarantine))

    # 1. torn index arrays.npz
    d1 = work / "idx_torn"
    idx.save(d1)
    with open(d1 / "arrays.npz", "r+b") as f:
        f.truncate((d1 / "arrays.npz").stat().st_size // 2)
    check("index.torn_npz", lambda: Index.load(d1, device=idx.device))

    # 2. read-path bit flip on an otherwise sound index (checksum catch)
    d2 = work / "idx_flip"
    idx.save(d2)

    def load_flipped():
        plan = FaultPlan({"index.read_arrays":
                          FaultSpec("bit_flip", at=(1,))}, seed=args.seed)
        with active_plan(plan):
            Index.load(d2, device=idx.device)
        event_log.extend(dict(phase="C", **e) for e in plan.log())
    check("index.bit_flip_on_read", load_flipped)

    # 3. WAL segment payload byte flip -> strict load refuses
    w3 = fresh_wal("wal_flip")
    flip_byte(w3 / "delta" / "step_1" / "arrays.npz")
    check("wal.byte_flip", lambda: MutableIndex.load(w3, device=idx.device))
    rep = delta.recover(w3)          # ...and recovery quarantines suffix
    cases[-1]["quarantine"] = rep

    # 4. WAL log gap (middle segment gone)
    w4 = fresh_wal("wal_gap")
    shutil.rmtree(w4 / "delta" / "step_1")
    check("wal.gap", lambda: MutableIndex.load(w4, device=idx.device))
    cases[-1]["quarantine"] = delta.recover(w4)

    # 5. WAL segment manifest deleted
    w5 = fresh_wal("wal_nomanifest")
    (w5 / "delta" / "step_2" / "manifest.json").unlink()
    check("wal.manifest_deleted",
          lambda: MutableIndex.load(w5, device=idx.device))
    cases[-1]["quarantine"] = delta.recover(w5)

    n_det = sum(1 for c in cases if c["detected"])
    report["corruption"] = dict(cases=cases, attempted=len(cases),
                                detected=n_det)
    for c in cases:
        mark = "ok " if c["detected"] else "MISS"
        print(f"    [{mark}] {c['case']}: {c['detail']}", flush=True)


def _gate(report) -> int:
    checks = []
    a = report.get("serve", {})
    checks += [
        ("every future resolves", a.get("unresolved") == 0),
        ("poisoned query fails exactly once", a.get("poisoned_failures") == 1),
        ("zero acked appends lost under churn", a.get("acked_rows_lost") == 0),
        ("circuit breaker tripped", a.get("breaker_trips", 0) >= 1),
        ("watchdog restarted the batcher", a.get("watchdog_restarts", 0) >= 1),
        ("failed install rolled back", a.get("swap_rollbacks", 0) >= 1),
    ]
    b = report.get("crash_recovery", {})
    checks += [
        ("torn write crashed the flush", b.get("crashed") is True),
        ("zero acked appends lost at crash", b.get("acked_rows_lost") == 0),
        ("bit-identical prefix replay", b.get("bit_identical_replay") is True),
    ]
    c = report.get("corruption", {})
    checks += [
        ("100% corruption detected",
         c.get("attempted", 0) > 0 and c.get("detected") == c.get("attempted")),
    ]
    rc = 0
    for name, ok in checks:
        print(f"  {'PASS' if ok else 'FAIL'}: {name}")
        rc |= 0 if ok else 1
    print("chaos checks " + ("passed" if rc == 0 else "FAILED"))
    return rc


def _run(args):
    from repro_torch import resolve_device
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.index import Index, IndexSpec

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    db = make_dataset(args.dataset, device=dev)
    idx = Index.build(db, IndexSpec.for_db(db, m=8, dfloat_recall_target=None),
                      device=dev)
    report, event_log = {}, []
    _phase_a(idx, db, args, report, event_log)
    _phase_b(idx, args, report, event_log)
    _phase_c(idx, args, report, event_log)
    report["elapsed_s"] = time.perf_counter() - t0
    return report, event_log


def main(argv=None):
    ap = argparse.ArgumentParser(description="seeded chaos smoke")
    ap.add_argument("--dataset", default="unit")
    ap.add_argument("--duration", type=float, default=6.0,
                    help="phase-A traffic seconds")
    ap.add_argument("--rps", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--report", default=None, help="write JSON report here")
    ap.add_argument("--events", default=None,
                    help="write the fault-event log artifact here")
    ap.add_argument("--check", action="store_true",
                    help="gate: non-zero exit on any violated invariant")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.workdir is None:
        args.workdir = tempfile.mkdtemp(prefix="chaos_")

    # injected batcher crashes are *supposed* to kill that thread; keep the
    # log readable (one line) instead of a full traceback per planned crash
    from repro_torch.resilience import InjectedCrash
    default_hook = threading.excepthook

    def hook(ea):
        if isinstance(ea.exc_value, InjectedCrash):
            print(f"    [injected] {ea.thread.name} died: {ea.exc_value}",
                  flush=True)
        else:
            default_hook(ea)
    threading.excepthook = hook
    try:
        report, event_log = _run(args)
    finally:
        threading.excepthook = default_hook
    report["n_fault_events"] = len(event_log)

    if args.report:
        Path(args.report).write_text(json.dumps(report, indent=1, default=str))
        print(f"report -> {args.report}")
    if args.events:
        Path(args.events).write_text(
            json.dumps(event_log, indent=1, default=str))
        print(f"fault-event log ({len(event_log)} events) -> {args.events}")
    print(f"chaos smoke: {report['elapsed_s']:.1f} s, "
          f"{len(event_log)} fault events")
    return _gate(report) if args.check else 0


if __name__ == "__main__":
    sys.exit(main())
