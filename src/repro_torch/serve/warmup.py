"""Warm start: run every program cell before traffic arrives.

The JAX package's ``repro.serve.warmup`` on the port.  ``compile_programs``
touches every ``(ef bucket x storage x batch bucket)`` cell with dummy
queries.  The first run of a cell loads the kernel libraries and fills the
kernels' cached tables (and on the first cell builds the searchers' device
state); the second is timed to seed the admission controller's latency
model.  The wall time from server start to the *first* cell responding is
the cold-start-to-first-response latency.

The JAX package's ``enable_compilation_cache`` has no counterpart: torch
runs eagerly, and the port's compiled artifact, the nvcc build of its
kernels under ``build/repro_torch_kernels/``, persists across processes
already (``repro_torch.kernels._build``).
"""
from __future__ import annotations

import time

import numpy as np


def compile_programs(snapshot, cfg, model=None, dim: int | None = None,
                     rng_seed: int = 0) -> dict:
    """Run the full program lattice twice; returns warmup timings.

    ``cells`` maps ``(ef, expand, storage, batch)`` to ``(first_s,
    steady_s)``.  Seeds ``model`` (a
    :class:`repro_torch.serve.admission.LatencyModel`) with the *second* run
    of each cell — the first includes one-time loading and would poison the
    admission estimates.
    """
    from repro_torch.serve.batcher import run_bucketed

    d = dim or snapshot.dim
    rng = np.random.default_rng(rng_seed)
    timings: dict = {}
    first_response_s = None
    t0 = time.perf_counter()
    for st in cfg.storages:
        for ef in cfg.ef_buckets:
            for b in cfg.batch_buckets:
                q = rng.standard_normal((b, d)).astype(np.float32)
                t = time.perf_counter()
                run_bucketed(snapshot, cfg, q, ef, cfg.expand, st)
                first_s = time.perf_counter() - t
                if first_response_s is None:
                    first_response_s = time.perf_counter() - t0
                steady_s = run_bucketed(snapshot, cfg, q, ef,
                                        cfg.expand, st)[3]
                timings[(ef, cfg.expand, st, b)] = (first_s, steady_s)
                if model is not None:
                    model.observe((ef, cfg.expand, st), b, steady_s)
    return dict(cells=timings, first_response_s=first_response_s,
                total_s=time.perf_counter() - t0)
