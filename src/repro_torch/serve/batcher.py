"""Fixed-shape batch execution: pad-to-bucket, run, slice per request.

The JAX package's ``repro.serve.batcher`` on the port.  One program cell is
``SearchParams(ef=bucket, k=k_max, expand, storage)`` at one batch bucket
``B``: the index's cached local searcher on its device, called with ``B``
queries.  A formed batch of ``n <= B`` requests is padded to ``B`` rows by
repeating the last real query.  The beam search keeps one row of state per
query and every per-row operation (gather, dedup, FEE kernel lane, merge)
reads only its own row, so a padded lane cannot touch a real lane's beam or
results; its rows are dropped before slicing.  The loop ends for the whole
batch at once: a query that has finished sees hops that pop nothing, score
nothing and leave its beam and counters as they were, so its results do not
depend on its batchmates.  Per-request ``k`` is a prefix slice of the shared
``k_max``-wide output: the top-k is the sorted head of one beam, so
``ids[:k]`` is bit-identical to running the same program with ``k``
directly.  ``device_exec`` ends when the results are on the host (the
searcher returns numpy), so a batch's service time includes its device
work.

``resolve_batch_safe`` wraps ``resolve_batch`` with bisection retry: when a
batch fails, the two halves are retried independently, recursively, until the
failure is pinned to single requests — so one poisoned query fails exactly
one future instead of taking its 31 batchmates down with it.  Padding makes
a half-batch run the same program lattice, just at a smaller batch bucket.

Tracing: ``resolve_batch`` stamps the stage boundaries of every batch
(``time.perf_counter_ns`` — a handful of clock reads per *batch*, not per
request) and, when the process tracer is enabled, emits one span per request
per stage: ``queue_wait -> admission -> bucket_pad -> device_exec ->
topk_slice -> resolve``.  The span construction itself is guarded behind
``tracer.enabled``, so the disabled hot path allocates nothing.  Each run
of the program is also one live ``serve.batch`` span (attributes ``batch``,
a sequence number, ``n`` and ``bucket``), around the search's own spans; the
batch's ``device_exec`` spans carry the same ``batch``.
"""
from __future__ import annotations

import itertools
import time

import numpy as np

from repro_torch.index import SearchParams
from repro_torch.obs import tracer
from repro_torch.resilience import InjectedCrash, fault_point

# device batches' sequence numbers, one count for every server of the process
_BATCHES = itertools.count()


def params_for(cfg, ef_bucket: int, expand: int, storage: str) -> SearchParams:
    return SearchParams(ef=ef_bucket, k=cfg.k_max, expand=expand,
                        storage=storage, use_fee=cfg.use_fee,
                        use_dfloat=cfg.use_dfloat
                        or storage in ("packed", "tiered"))


def run_bucketed(snapshot, cfg, queries: np.ndarray, ef_bucket: int,
                 expand: int, storage: str, bucket: int | None = None,
                 timings: dict | None = None):
    """Run ``queries`` through the (ef_bucket, expand, storage) program at the
    padded batch bucket; returns ``(ids, dists, generation, service_s)`` with
    the padding rows already dropped.  ``bucket`` pins the batch bucket (a
    test replaying one request against the exact program that served it).
    ``timings`` (optional dict) receives the ``t_exec_ns``/``t_done_ns``
    stage boundaries so the caller can attribute pad vs device time, and
    the batch's sequence number (``batch``, drawn from one process-wide
    count), which the ``serve.batch`` span around the run carries too."""
    n = len(queries)
    bucket = bucket or cfg.batch_bucket(n)
    if n < bucket:
        pad = np.repeat(queries[-1:], bucket - n, axis=0)
        queries = np.concatenate([queries, pad], axis=0)
    run = snapshot.searcher("local", params_for(cfg, ef_bucket, expand,
                                                storage))
    seq = next(_BATCHES)
    t0_ns = time.perf_counter_ns()
    with tracer.span("serve.batch", batch=seq, n=n, bucket=bucket):
        res = run(queries)
    t1_ns = time.perf_counter_ns()
    if timings is not None:
        timings["t_exec_ns"] = t0_ns
        timings["t_done_ns"] = t1_ns
        timings["batch"] = seq
    return res.ids[:n], res.dists[:n], res.generation, (t1_ns - t0_ns) / 1e9, res


def resolve_batch(snapshot, cfg, serve: list, ef_bucket: int, degraded: bool,
                  model=None, resid_metrics=None, t_taken_ns: int | None = None,
                  t_admitted_ns: int | None = None) -> float:
    """Serve one admitted batch and resolve every request future.

    Returns the measured service seconds (also fed back into ``model``).
    ``t_taken_ns``/``t_admitted_ns`` are the batch-formation and admission
    boundaries stamped by the serve loop; they split each request's latency
    into the traced stages (absent — a direct call — both collapse onto the
    execution start, attributing everything before it to queue wait)."""
    from repro_torch.serve.request import Response

    fault_point("serve.batch_exec", ids=[r.id for r in serve])
    group = serve[0].group(cfg)
    t_pad_ns = time.perf_counter_ns()
    queries = np.stack([r.query for r in serve])
    bucket = cfg.batch_bucket(len(serve))
    timings = {}
    ids, dists, gen, service_s, res = run_bucketed(
        snapshot, cfg, queries, ef_bucket, group[1], group[2], bucket=bucket,
        timings=timings)
    t_exec_ns, t_done_ns = timings["t_exec_ns"], timings["t_done_ns"]
    if model is not None:
        model.observe((ef_bucket,) + group[1:], bucket, service_s)
    n = len(serve)
    if resid_metrics is not None and res.n_eval is not None:
        # live search counters (padding rows dropped — they duplicate the
        # last real query's counters): FEE exit fraction for every storage,
        # plus tiered per-bucket survivor-fetch accounting
        n_eval = float(np.asarray(res.n_eval)[:n].sum())
        dim = getattr(snapshot, "dim", None)
        if res.dims is not None and dim:
            resid_metrics.record_batch(
                n_eval, float(np.asarray(res.dims)[:n].sum()), dim)
        if res.n_resid is not None:
            resid_metrics.record_residual(
                ef_bucket, n_eval, float(np.asarray(res.n_resid)[:n].sum()))
    # per-request top-k slices first, then response construction (the resolve
    # stage), so the stage boundaries are real shared timestamps rather than
    # interleaved per-request work.  ``total_ms`` is stamped when the resolve
    # stage *ends* — the traced stage durations sum to it exactly — while the
    # future propagation (done-callbacks, metrics) stays outside both.
    slices = [(np.asarray(ids[i, : r.k]), np.asarray(dists[i, : r.k]))
              for i, r in enumerate(serve)]
    t_slice_ns = time.perf_counter_ns()
    responses = [Response(
        id=r.id, status="ok", ids=ids_i, dists=dists_i,
        generation=gen, ef_served=ef_bucket, batch_bucket=bucket,
        degraded=degraded and ef_bucket < r.group(cfg)[0],
        queue_ms=(t_exec_ns / 1e9 - _NS_EPOCH - r.t_submit) * 1e3,
        service_ms=service_s * 1e3)
        for (ids_i, dists_i), r in zip(slices, serve)]
    t_res_ns = time.perf_counter_ns()
    now = t_res_ns / 1e9 - _NS_EPOCH
    for resp, r in zip(responses, serve):
        resp.total_ms = r.elapsed_ms(now)
        resp.deadline_missed = resp.total_ms > r.deadline_ms
        r.future.set_result(resp)
    if tracer.enabled:
        taken = t_taken_ns if t_taken_ns is not None else t_pad_ns
        admitted = t_admitted_ns if t_admitted_ns is not None else t_pad_ns
        for r in serve:
            sub_ns = int((r.t_submit + _NS_EPOCH) * 1e9)
            rid = r.id
            tracer.add_span("queue_wait", sub_ns, taken, req=rid)
            tracer.add_span("admission", taken, admitted, req=rid, depth=0)
            tracer.add_span("bucket_pad", admitted, t_exec_ns, req=rid,
                            bucket=bucket, n=n)
            tracer.add_span("device_exec", t_exec_ns, t_done_ns, req=rid,
                            ef=ef_bucket, storage=group[2],
                            batch=timings["batch"])
            tracer.add_span("topk_slice", t_done_ns, t_slice_ns, req=rid)
            tracer.add_span("resolve", t_slice_ns, t_res_ns, req=rid)
    return service_s


# time.perf_counter() and time.perf_counter_ns() share one monotonic clock;
# this offset (seconds) converts between the float timestamps requests carry
# (Request.t_submit) and the ns stamps the tracer records.  Measured once —
# the two calls are back-to-back, so the offset error is sub-microsecond.
_NS_EPOCH = (lambda: (time.perf_counter_ns() / 1e9) - time.perf_counter())()


def resolve_batch_safe(snapshot, cfg, serve: list, ef_bucket: int,
                       degraded: bool, model=None, metrics=None,
                       bisect: bool = True, resid_metrics=None,
                       t_taken_ns: int | None = None,
                       t_admitted_ns: int | None = None) -> tuple:
    """``resolve_batch`` with bisection retry; returns ``(n_ok, n_failed)``.

    A failing batch is split in half and each half retried independently,
    recursively, until failures are isolated to single requests — those
    futures get the exception, everything else still gets its result.
    ``InjectedCrash`` is never healed: it simulates process death and must
    propagate to the serve loop (where the watchdog takes over).
    """
    try:
        resolve_batch(snapshot, cfg, serve, ef_bucket, degraded, model=model,
                      resid_metrics=resid_metrics, t_taken_ns=t_taken_ns,
                      t_admitted_ns=t_admitted_ns)
        return len(serve), 0
    except InjectedCrash:
        raise
    except Exception as e:
        if len(serve) == 1 or not bisect:
            for r in serve:
                if not r.future.done():
                    r.future.set_exception(e)
                if metrics is not None:
                    metrics.record_error(e)
            return 0, len(serve)
        mid = len(serve) // 2
        ok_l, bad_l = resolve_batch_safe(snapshot, cfg, serve[:mid],
                                         ef_bucket, degraded, model=model,
                                         metrics=metrics, bisect=bisect,
                                         resid_metrics=resid_metrics,
                                         t_taken_ns=t_taken_ns,
                                         t_admitted_ns=t_admitted_ns)
        ok_r, bad_r = resolve_batch_safe(snapshot, cfg, serve[mid:],
                                         ef_bucket, degraded, model=model,
                                         metrics=metrics, bisect=bisect,
                                         resid_metrics=resid_metrics,
                                         t_taken_ns=t_taken_ns,
                                         t_admitted_ns=t_admitted_ns)
        return ok_l + ok_r, bad_l + bad_r


def fail_timeouts(timed_out: list) -> None:
    from repro_torch.serve.request import Response

    now = time.perf_counter()
    for r in timed_out:
        r.future.set_result(Response(
            id=r.id, status="timeout", queue_ms=r.elapsed_ms(now),
            total_ms=r.elapsed_ms(now), deadline_missed=True))
