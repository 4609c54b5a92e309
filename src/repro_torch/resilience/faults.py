"""Deterministic fault injection: seeded plans over named injection points.

(A copy of the JAX package's ``repro.resilience.faults``.)  Every I/O and
serve-loop boundary calls
:func:`fault_point("<name>", ...)` — a no-op (one ``None`` check) unless a
:class:`FaultPlan` is installed.  A plan maps point names to
:class:`FaultSpec` schedules; each point keeps its own invocation counter, so
which hit fires is a pure function of ``(schedule, per-point call order)`` and
a chaos run replays exactly under the same seed and traffic schedule.

Fault kinds
    raise       raise :class:`InjectedFault` (a failing operation)
    crash       raise :class:`InjectedCrash` (simulated process/thread death)
    delay       sleep ``delay_s`` (a wedged operation; watchdog fodder)
    torn_write  truncate the file at ``ctx["path"]`` to ``truncate_fraction``
                of its bytes, then (by default) crash — a torn write is a
                write the process never survived
    poison      arm on the scheduled hit: pick one id from ``ctx["ids"]``
                (seeded) and from then on fail every call whose ``ids``
                contain it — until it fails *alone* (batch of one), which
                consumes the poison.  This is exactly the contract batch
                bisection must isolate.
    bit_flip    only via :func:`corrupt`: flip one seeded bit of the array
                passed through the point (corruption on the read path)

Registered injection points (grep for ``fault_point(`` / ``corrupt(``):

    ckpt.write_arrays    after arrays.npz is written, before the manifest
    ckpt.pre_swap        tmp dir complete, before any directory swap
    ckpt.mid_swap        old checkpoint renamed aside, replacement not yet in
    ckpt.post_swap       replacement in place, old dir not yet removed
    ckpt.read_arrays     arrays as read back by restore (corrupt)
    index.read_arrays    arrays as read back by Index.load (corrupt)
    serve.loop           top of every batcher-loop iteration
    serve.batch_exec     before a formed batch executes (ids=[request ids])
    serve.swap.install   before a generation's device upload

Every fire is appended to ``plan.events`` — the fault-event log the chaos
driver writes as its CI artifact.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import zlib


class InjectedFault(Exception):
    """A failure injected by the active FaultPlan."""


class InjectedCrash(InjectedFault):
    """Simulated process death: must propagate, never be retried/healed."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault at one injection point.

    Fires when the point's invocation counter is in ``at``, or inside the
    half-open window ``[after, until)``, or (for hits matching neither) when a
    per-point seeded coin with probability ``p`` comes up.  ``max_fires``
    bounds the total fires of this spec.
    """

    kind: str                       # raise|crash|delay|torn_write|poison|bit_flip
    at: tuple = ()                  # exact invocation indices that fire
    after: int | None = None        # window start (inclusive) ...
    until: int | None = None        # ... window end (exclusive)
    p: float = 0.0                  # seeded per-hit probability
    max_fires: int | None = None
    delay_s: float = 0.1            # for kind="delay"
    truncate_fraction: float = 0.5  # for kind="torn_write"
    crash_after: bool = True        # torn_write: crash once the file is torn
    message: str = ""

    def __post_init__(self):
        known = ("raise", "crash", "delay", "torn_write", "poison", "bit_flip")
        if self.kind not in known:
            raise ValueError(f"unknown fault kind {self.kind!r} (known: {known})")


@dataclasses.dataclass
class FaultEvent:
    """One fired fault (the chaos log row)."""

    point: str
    hit: int                        # per-point invocation index that fired
    kind: str
    detail: str = ""
    t: float = dataclasses.field(default_factory=time.perf_counter)

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


def _point_seed(seed: int, point: str) -> int:
    return (seed << 32) ^ zlib.crc32(point.encode())


class FaultPlan:
    """A seeded, deterministic schedule of faults over named points."""

    def __init__(self, schedule: dict, seed: int = 0):
        self.seed = seed
        self.schedule: dict[str, tuple[FaultSpec, ...]] = {}
        for point, specs in schedule.items():
            if isinstance(specs, FaultSpec):
                specs = (specs,)
            self.schedule[point] = tuple(specs)
        self.events: list[FaultEvent] = []
        self._counts: dict[str, int] = {}
        self._fires: dict[int, int] = {}      # id(spec) -> fires so far
        self._rngs: dict[str, object] = {}
        self._poisoned: set = set()           # armed poison victim ids
        self._lock = threading.RLock()

    # -- bookkeeping ---------------------------------------------------------
    def count(self, point: str) -> int:
        """Invocations of ``point`` seen so far."""
        with self._lock:
            return self._counts.get(point, 0)

    def events_of(self, kind: str | None = None,
                  point: str | None = None) -> list[FaultEvent]:
        with self._lock:
            return [e for e in self.events
                    if (kind is None or e.kind == kind)
                    and (point is None or e.point == point)]

    def log(self) -> list[dict]:
        """The serializable fault-event log (the CI artifact payload)."""
        with self._lock:
            return [e.asdict() for e in self.events]

    def _rng(self, point: str):
        import numpy as np

        if point not in self._rngs:
            self._rngs[point] = np.random.default_rng(
                abs(_point_seed(self.seed, point)))
        return self._rngs[point]

    def _record(self, point: str, hit: int, kind: str, detail: str = ""):
        ev = FaultEvent(point=point, hit=hit, kind=kind, detail=detail)
        self.events.append(ev)
        # every fire also lands in the process-wide telemetry registry, so a
        # chaos report can cross-check its event log against live counters
        from repro_torch.obs import default_registry

        default_registry().counter(f"resilience.faults.{kind}").inc()
        return ev

    # -- firing decision -----------------------------------------------------
    def _fire_spec(self, point: str, hit: int) -> FaultSpec | None:
        for spec in self.schedule.get(point, ()):
            if spec.max_fires is not None \
                    and self._fires.get(id(spec), 0) >= spec.max_fires:
                continue
            hit_match = hit in spec.at
            if not hit_match and spec.after is not None:
                hit_match = hit >= spec.after and (spec.until is None
                                                   or hit < spec.until)
            if not hit_match and spec.p > 0:
                hit_match = float(self._rng(point).random()) < spec.p
            if hit_match:
                self._fires[id(spec)] = self._fires.get(id(spec), 0) + 1
                return spec
        return None

    # -- point execution -----------------------------------------------------
    def hit_point(self, point: str, ctx: dict) -> None:
        with self._lock:
            hit = self._counts.get(point, 0)
            self._counts[point] = hit + 1
            # armed poison: any call carrying the victim id fails, and a
            # batch-of-one failure consumes the poison (bisection terminus)
            ids = ctx.get("ids")
            if self._poisoned and ids is not None:
                victims = self._poisoned.intersection(ids)
                if victims:
                    if len(ids) == 1:
                        self._poisoned -= victims
                    v = sorted(victims)[0]
                    self._record(point, hit, "poison",
                                 f"poisoned id {v} in batch of {len(ids)}")
                    raise InjectedFault(f"{point}: poisoned request {v}")
            spec = self._fire_spec(point, hit)
            if spec is None:
                return
            detail = spec.message
            if spec.kind == "poison":
                if not ids:
                    return                      # nothing to poison this hit
                v = ids[int(self._rng(point).integers(0, len(ids)))]
                self._poisoned.add(v)
                self._record(point, hit, "poison_armed", f"victim id {v}")
                if len(ids) == 1:
                    self._poisoned.discard(v)
                self._record(point, hit, "poison",
                             f"poisoned id {v} in batch of {len(ids)}")
                raise InjectedFault(f"{point}: poisoned request {v}")
            self._record(point, hit, spec.kind, detail)
        # act outside the lock (sleeps and file I/O must not serialize
        # unrelated points)
        if spec.kind == "raise":
            raise InjectedFault(f"{point}@{hit}: {detail or 'injected failure'}")
        if spec.kind == "crash":
            raise InjectedCrash(f"{point}@{hit}: injected crash")
        if spec.kind == "delay":
            time.sleep(spec.delay_s)
            return
        if spec.kind == "torn_write":
            path = ctx.get("path")
            if path is not None:
                _truncate_file(path, spec.truncate_fraction)
            if spec.crash_after:
                raise InjectedCrash(f"{point}@{hit}: crashed mid-write "
                                    f"({path} torn)")
            return
        # bit_flip at a control point is a no-op; it acts through corrupt()

    def corrupt_array(self, point: str, arr):
        """Bit-flip path: return ``arr`` with one seeded bit flipped when the
        schedule fires at this hit, else ``arr`` unchanged."""
        import numpy as np

        with self._lock:
            hit = self._counts.get(point, 0)
            self._counts[point] = hit + 1
            spec = self._fire_spec(point, hit)
            if spec is None or spec.kind != "bit_flip":
                return arr
            rng = self._rng(point)
            flat = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
            if not len(flat):
                return arr
            out = flat.copy()
            byte = int(rng.integers(0, len(out)))
            bit = int(rng.integers(0, 8))
            out[byte] ^= np.uint8(1 << bit)
            self._record(point, hit, "bit_flip",
                         f"flipped bit {bit} of byte {byte}/{len(out)}")
            return out.view(arr.dtype).reshape(arr.shape)


def _truncate_file(path, fraction: float) -> None:
    import os

    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(1, int(size * fraction)))


# -- active-plan plumbing ----------------------------------------------------
_PLAN: FaultPlan | None = None
_PLAN_LOCK = threading.Lock()


def install_plan(plan: FaultPlan | None) -> FaultPlan | None:
    """Install ``plan`` globally (None uninstalls); returns the previous."""
    global _PLAN
    with _PLAN_LOCK:
        prev, _PLAN = _PLAN, plan
        return prev


def current_plan() -> FaultPlan | None:
    return _PLAN


@contextlib.contextmanager
def active_plan(plan: FaultPlan):
    """Scope a plan: ``with active_plan(FaultPlan({...})): ...``"""
    prev = install_plan(plan)
    try:
        yield plan
    finally:
        install_plan(prev)


def fault_point(point: str, **ctx) -> None:
    """Declare an injection point.  Free when no plan is installed."""
    plan = _PLAN
    if plan is None:
        return
    plan.hit_point(point, ctx)


def corrupt(point: str, arr):
    """Declare a read-path corruption point for ``arr`` (numpy array)."""
    plan = _PLAN
    if plan is None:
        return arr
    return plan.corrupt_array(point, arr)
