"""Serving-tier configuration: the bucket lattice and the SLO policy.

The JAX package's ``repro.serve.config``, copied.  The batcher never runs an
arbitrary-shaped search.  Every request is rounded *up* to an ``ef`` bucket
and every batch is padded *up* to a batch bucket, so live traffic runs a
small closed set of program cells —
``len(ef_buckets) x len(storages) x len(batch_buckets)`` at the default
``expand`` — all run once during warmup.  On the port a cell is a cached
``Index.searcher`` and a batch shape; its kernels are built once per
process (``build/repro_torch_kernels/``).

All programs share one top-k width ``k_max`` (validated <= min ef bucket);
per-request ``k`` is a host-side slice of the program output, which keeps the
program set independent of the ``k`` mix in traffic.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Frozen policy for one :class:`repro_torch.serve.Server`."""

    # -- program lattice ----------------------------------------------------
    ef_buckets: tuple = (32, 64, 128)   # request ef rounds UP to one of these
    batch_buckets: tuple = (1, 4, 16, 32)
    k_max: int = 10                     # top-k width of every program
    expand: int = 4                     # default beam expansion per hop
    storages: tuple = ("f32",)          # accepted Request.storage values
    use_dfloat: bool = False
    use_fee: bool = True

    # -- SLO / admission ----------------------------------------------------
    slo_ms: float = 50.0                # default per-request deadline
    max_queue: int = 256                # shed (or block) beyond this depth
    shed_on_full: bool = True           # False -> submit() blocks when full
    degrade: bool = True                # allow serving at a lower ef bucket
    degrade_queue: int = 0              # queue depth that forces the lowest
                                        # ef bucket (0 -> max_queue // 2)
    max_wait_ms: float = 2.0            # batch-formation window

    # -- hot swap / device residency ----------------------------------------
    swap_poll_s: float = 0.25           # fallback poll for snapshot changes
    donate: bool = True                 # splice generations in place

    # -- resilience / self-healing ------------------------------------------
    bisect_retry: bool = True           # a failing batch is bisected so one
                                        # poisoned request fails alone
    breaker_threshold: int = 5          # consecutive whole-batch failures
                                        # that trip the circuit breaker
    breaker_cooldown_s: float = 1.0     # open -> half-open probe delay
    watchdog: bool = True               # monitor + restart the batcher thread
    watchdog_poll_s: float = 0.25
    watchdog_stall_s: float = 5.0       # heartbeat age that declares the
                                        # batcher wedged (hung device call)

    # -- warmup --------------------------------------------------------------
    compilation_cache_dir: str | None = None   # the JAX package's jit cache
                                               # directory; kept so that its
                                               # configs carry over, unused
                                               # by the port (its kernels'
                                               # nvcc builds persist already)

    def __post_init__(self):
        if tuple(sorted(self.ef_buckets)) != tuple(self.ef_buckets):
            raise ValueError("ef_buckets must be sorted ascending")
        if tuple(sorted(self.batch_buckets)) != tuple(self.batch_buckets):
            raise ValueError("batch_buckets must be sorted ascending")
        if not self.ef_buckets or not self.batch_buckets:
            raise ValueError("ef_buckets and batch_buckets must be non-empty")
        if self.k_max > min(self.ef_buckets):
            # one shared program k keeps per-request k a pure output slice
            raise ValueError(
                f"k_max={self.k_max} exceeds the smallest ef bucket "
                f"({min(self.ef_buckets)}); every program serves k_max ids")
        for st in self.storages:
            if st not in ("f32", "packed", "tiered"):
                raise ValueError(f"unknown storage {st!r}")
        for st in ("packed", "tiered"):
            if st in self.storages and not self.use_dfloat:
                raise ValueError(
                    f'storage "{st}" requires use_dfloat=True')
        if self.breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")
        if self.watchdog_stall_s <= 0 or self.watchdog_poll_s <= 0:
            raise ValueError("watchdog intervals must be positive")

    # -- bucket arithmetic ---------------------------------------------------
    def ef_bucket(self, ef: int) -> int:
        """Smallest bucket >= ef (requests above the top bucket are capped)."""
        for b in self.ef_buckets:
            if b >= ef:
                return b
        return self.ef_buckets[-1]

    def batch_bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if b >= n:
                return b
        return self.batch_buckets[-1]

    @property
    def batch_max(self) -> int:
        return self.batch_buckets[-1]

    @property
    def degrade_depth(self) -> int:
        return self.degrade_queue or max(1, self.max_queue // 2)

    def lower_bucket(self, ef_bucket: int) -> int | None:
        """Next smaller ef bucket, or None when already at the floor."""
        i = self.ef_buckets.index(ef_bucket)
        return self.ef_buckets[i - 1] if i > 0 else None
