"""Deterministic fault injection + artifact integrity (the JAX package's
``repro.resilience``, copied).

    from repro_torch.resilience import FaultPlan, FaultSpec, active_plan

    plan = FaultPlan({"ckpt.pre_swap": FaultSpec("crash", at=(0,))}, seed=7)
    with active_plan(plan):
        ...                       # every failure replays exactly
    print(plan.log())             # the fault-event artifact

  * :mod:`repro_torch.resilience.faults` — seeded :class:`FaultPlan`
    schedules over named injection points (checkpoint swap windows, WAL
    segment writes, index reads).  Zero-cost when no plan is installed.
  * :mod:`repro_torch.resilience.checksum` — per-array artifact checksums and
    :class:`CorruptArtifactError`, the error every loader raises instead of
    serving a corrupted payload.

The durability machinery this validates lives where the data lives:
crash-ordered ``repro_torch.ft.checkpoint.save`` and quarantine-and-replay
WAL recovery in ``repro_torch.streaming.delta``.
"""
from repro_torch.resilience.checksum import (  # noqa: F401
    ALGO, CorruptArtifactError, checksum_array, checksum_bytes,
    manifest_checksums, verify_arrays)
from repro_torch.resilience.faults import (  # noqa: F401
    FaultEvent, FaultPlan, FaultSpec, InjectedCrash, InjectedFault,
    active_plan, corrupt, current_plan, fault_point, install_plan)
