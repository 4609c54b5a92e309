"""repro_torch.serve — online serving over the port's Index API.

    from repro_torch.serve import Server, ServeConfig, run_load

    with Server(mutable_index, ServeConfig(slo_ms=50)) as srv:
        fut = srv.submit(query, k=10, ef=64)
        resp = fut.result()            # Response(ids, dists, generation, ...)
        responses = run_load(srv, queries, rps=100, duration_s=10)

The JAX package's ``repro.serve`` on the port, with its exports except
``enable_compilation_cache`` (no counterpart: ``serve.warmup``).
Continuous dynamic batching over a fixed program lattice, SLO-aware
admission with timeout / shed / ef degradation, and zero-downtime generation
hot-swap with in-place delta splices on the index's device.  Self-healing
under failure: batch bisection, a failure circuit breaker, a batcher
watchdog, and hot-swap rollback (see ``ServeConfig`` knobs).
"""
from repro_torch.serve.admission import (  # noqa: F401
    AdmissionController, CircuitBreaker, LatencyModel)
from repro_torch.serve.batcher import resolve_batch, resolve_batch_safe  # noqa: F401
from repro_torch.serve.config import ServeConfig  # noqa: F401
from repro_torch.serve.loadgen import run_load  # noqa: F401
from repro_torch.serve.metrics import Metrics  # noqa: F401
from repro_torch.serve.queue import RequestQueue  # noqa: F401
from repro_torch.serve.request import Request, Response  # noqa: F401
from repro_torch.serve.server import Server  # noqa: F401
from repro_torch.serve.swap import GenerationInstaller, SnapshotWatcher  # noqa: F401
from repro_torch.serve.warmup import compile_programs  # noqa: F401
