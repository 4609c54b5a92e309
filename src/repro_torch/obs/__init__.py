"""repro_torch.obs — observability: request tracing + telemetry registry.

The JAX package's ``repro.obs``, copied (numpy and the standard library
only), so the port records the same counters under the same names.

    from repro_torch import obs

    obs.enable_tracing()                      # span ring buffer on
    with obs.span("wal.flush", n_ops=3):
        ...
    obs.tracer.write_chrome_trace("trace.json")

    reg = obs.default_registry()              # process-wide counters
    reg.counter("streaming.append_rows").inc(64)
    print(reg.expose_text())                  # Prometheus-style exposition

Two halves, one import surface:

* **Tracing** (``repro_torch.obs.trace``): a bounded-ring span recorder with a
  zero-allocation disabled path.  The serving tier instruments the full
  request lifecycle (``queue_wait -> admission -> bucket_pad -> device_exec
  -> topk_slice -> resolve``, ``repro_torch.serve.batcher``), hot-swap
  installs (``swap.install``), WAL flushes (``wal.flush``) and the search
  call from the inside (``serve.batch``, ``search.*``), whose live spans
  also stand among a running ``torch.profiler``'s host events.
* **Telemetry** (``repro_torch.obs.registry``): typed counters / gauges /
  histograms (bounded quantile sketches — no unbounded sample lists) with
  JSON-snapshot and text expositions and a periodic file exporter.
  Library-level counters (``search.*``, ``streaming.*``,
  ``resilience.faults.*``) live in :func:`default_registry`.
"""
from repro_torch.obs.registry import (  # noqa: F401
    Counter, Gauge, Histogram, PeriodicExporter, QuantileSketch, Registry,
    default_registry)
from repro_torch.obs.trace import (  # noqa: F401
    SERVE_STAGES, Span, Tracer, disable_tracing, enable_tracing, span,
    tracer)
