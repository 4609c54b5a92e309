"""Online serving driver: Poisson/diurnal load against a live Server.

  PYTHONPATH=src python -m repro_torch.launch.serve --dataset unit \
      --rps 50 --duration 10 --slo-ms 100 --mutate 8 --report serve.json \
      [--device cuda|cpu]

The JAX package's ``launch/serve.py`` (its ANNS path) on the port.  Drives
``repro_torch.serve`` end to end: builds an index on ``--device`` (default
``cuda``, which raises without a card), wraps it in a MutableIndex when
``--mutate`` asks for live churn, starts the server (warming the program
lattice), replays an open-loop arrival process, and prints / writes the
latency, goodput and hot-swap accounting; ``--report`` writes the JAX
package's keys (``args``, ``summary``, ``histogram``).  ``--check-*`` flags
turn the run into a gate (non-zero exit on violation).

The JAX package's ``--cache-dir`` has no counterpart (the port's kernels'
builds persist under ``build/repro_torch_kernels/``), and its ``--decode``
LM smoke path waits for the port of the models (ROADMAP queue A, item 11);
``main`` is the reference's ``_serve_main``.
"""
import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="online ANNS serving driver")
    ap.add_argument("--dataset", default="unit")
    ap.add_argument("--m", type=int, default=8, help="graph degree at build")
    ap.add_argument("--storage", default="f32",
                    choices=["f32", "packed", "tiered"])
    ap.add_argument("--rps", type=float, default=50.0)
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--pattern", default="poisson",
                    choices=["poisson", "diurnal", "uniform"])
    ap.add_argument("--slo-ms", type=float, default=100.0)
    ap.add_argument("--ef", default="32,64",
                    help="comma list; traffic cycles through these and they "
                         "become the ef buckets")
    ap.add_argument("--k", default="10", help="comma list of request k values")
    ap.add_argument("--batch-buckets", default="1,4,16,32")
    ap.add_argument("--mutate", type=int, default=0,
                    help="append this many vectors (and delete 1/4 as many) "
                         "per second of live churn; 0 = static index")
    ap.add_argument("--mutate-every-s", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--report", default=None, help="write JSON report here")
    ap.add_argument("--trace", action="store_true",
                    help="record request spans (bounded ring buffer)")
    ap.add_argument("--trace-out", default=None,
                    help="write the Chrome-trace timeline artifact here "
                         "(implies --trace; load in chrome://tracing)")
    ap.add_argument("--metrics-out", default=None,
                    help="periodically write a JSON registry snapshot here "
                         "(serve + process-wide counters)")
    ap.add_argument("--check-no-failures", action="store_true",
                    help="exit 1 on any shed/timeout response")
    ap.add_argument("--check-p99-ms", type=float, default=None,
                    help="exit 1 when p99 exceeds this bound")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch import obs, resolve_device
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.index import Index, IndexSpec
    from repro_torch.serve import ServeConfig, Server, run_load
    from repro_torch.streaming import MutableIndex

    ef_mix = sorted(int(x) for x in args.ef.split(","))
    k_mix = [int(x) for x in args.k.split(",")]
    cfg = ServeConfig(
        ef_buckets=tuple(dict.fromkeys(ef_mix)),
        batch_buckets=tuple(int(x) for x in args.batch_buckets.split(",")),
        k_max=max(k_mix), slo_ms=args.slo_ms,
        storages=(args.storage,),
        use_dfloat=args.storage in ("packed", "tiered"))

    dev = resolve_device(args.device)
    db = make_dataset(args.dataset, device=dev)
    spec = IndexSpec.for_db(
        db, m=args.m,
        dfloat_recall_target=(0.80 if args.storage in ("packed", "tiered")
                              else None),
        ef_fit=32)
    print(f"building index: {db.n} x {db.dim} (m={args.m}, "
          f"storage={args.storage})", flush=True)
    idx = Index.build(db, spec, device=dev)
    mi = MutableIndex(idx) if args.mutate else None

    rng = np.random.default_rng(args.seed)

    def churn():
        mi.append(rng.standard_normal((args.mutate, db.dim))
                  .astype(np.float32))
        n_del = args.mutate // 4
        if n_del:
            mi.delete(rng.integers(0, db.n, n_del))

    if args.trace or args.trace_out:
        obs.enable_tracing()
    exporter = None
    with Server(mi if mi is not None else idx, cfg) as srv:
        if args.metrics_out:
            exporter = obs.PeriodicExporter(
                {"serve": srv.metrics.registry,
                 "default": obs.default_registry()},
                args.metrics_out).start()
        print(f"serving on {dev}: cold start "
              f"{srv.metrics.cold_start_ms:.0f} ms, "
              f"{len(srv.warmup_info['cells'])} program cells warmed",
              flush=True)
        run_load(srv, db.queries, rps=args.rps, duration_s=args.duration,
                 pattern=args.pattern, ef_mix=ef_mix, k_mix=k_mix,
                 deadline_ms=args.slo_ms, seed=args.seed,
                 mutate_fn=churn if mi is not None else None,
                 mutate_every_s=args.mutate_every_s)
        summary = srv.metrics.summary()
        hist = srv.metrics.histogram()
    if exporter is not None:
        exporter.stop()
        print(f"metrics snapshot -> {args.metrics_out}")
    if args.trace_out:
        n_spans = len(obs.tracer.spans())
        obs.tracer.write_chrome_trace(args.trace_out)
        print(f"trace ({n_spans} spans, {obs.tracer.dropped} dropped) -> "
              f"{args.trace_out}")

    _print_summary(summary)
    if args.report:
        with open(args.report, "w") as f:
            json.dump(dict(args=vars(args), summary=summary, histogram=hist),
                      f, indent=1, default=str)
        print(f"report -> {args.report}")
    return _gate(args, summary)


def _print_summary(s):
    print(f"requests: {s['requests']}  ok: {s['ok']}  shed: {s['shed']}  "
          f"timeout: {s['timeout']}  degraded: {s['degraded']}  "
          f"errors: {s.get('errors', 0)}")
    if s.get("events"):
        print("resilience events: "
              + "  ".join(f"{k}: {v}" for k, v in sorted(s["events"].items())))
    if "p50_ms" in s:
        print(f"latency ms: p50 {s['p50_ms']:.2f}  p99 {s['p99_ms']:.2f}  "
              f"p999 {s['p999_ms']:.2f}  (p999/p50 "
              f"{s['p999_ms'] / max(s['p50_ms'], 1e-9):.1f}x)")
    if s.get("stages"):
        print("per-stage ms: " + "  ".join(
            f"{k} p50 {v['p50_ms']:.2f} / p99 {v['p99_ms']:.2f}"
            for k, v in s["stages"].items()))
    if "fee_exit_fraction" in s:
        print(f"FEE exit fraction: {s['fee_exit_fraction']:.3f}")
    print(f"goodput: {s['goodput_qps']:.1f} qps within SLO {s['slo_ms']} ms")
    if "residual_fetch_fraction" in s:
        print("residual fetch fraction (tiered, per ef bucket): "
              + "  ".join(f"ef{b}: {f:.3f}" for b, f in
                          sorted(s["residual_fetch_fraction"].items(),
                                 key=lambda kv: int(kv[0]))))
    if "swaps" in s:
        sw = s["swaps"]
        print(f"hot swaps: {sw['installs']} installs "
              f"({sw['delta_installs']} delta), "
              f"{sw['h2d_bytes']} bytes shipped, worst delta re-upload "
              f"{sw['max_delta_reupload_fraction']:.3%} of full")


def _gate(args, s) -> int:
    rc = 0
    if args.check_no_failures and (s["shed"] or s["timeout"]
                                   or s.get("errors", 0)):
        print(f"CHECK FAILED: {s['shed']} shed + {s['timeout']} timeout + "
              f"{s.get('errors', 0)} errored responses (expected none)")
        rc = 1
    if args.check_p99_ms is not None:
        p99 = s.get("p99_ms")
        if p99 is None or p99 > args.check_p99_ms:
            print(f"CHECK FAILED: p99 {p99} ms > bound {args.check_p99_ms} ms")
            rc = 1
    if rc == 0 and (args.check_no_failures or args.check_p99_ms is not None):
        print("checks passed")
    return rc


def _print_summary(s):
    print(f"requests: {s['requests']}  ok: {s['ok']}  shed: {s['shed']}  "
          f"timeout: {s['timeout']}  degraded: {s['degraded']}  "
          f"errors: {s.get('errors', 0)}")
    if s.get("events"):
        print("resilience events: "
              + "  ".join(f"{k}: {v}" for k, v in sorted(s["events"].items())))
    if "p50_ms" in s:
        print(f"latency ms: p50 {s['p50_ms']:.2f}  p99 {s['p99_ms']:.2f}  "
              f"p999 {s['p999_ms']:.2f}  (p999/p50 "
              f"{s['p999_ms'] / max(s['p50_ms'], 1e-9):.1f}x)")
    if s.get("stages"):
        print("per-stage ms: " + "  ".join(
            f"{k} p50 {v['p50_ms']:.2f} / p99 {v['p99_ms']:.2f}"
            for k, v in s["stages"].items()))
    if "fee_exit_fraction" in s:
        print(f"FEE exit fraction: {s['fee_exit_fraction']:.3f}")
    print(f"goodput: {s['goodput_qps']:.1f} qps within SLO {s['slo_ms']} ms")
    if "residual_fetch_fraction" in s:
        print("residual fetch fraction (tiered, per ef bucket): "
              + "  ".join(f"ef{b}: {f:.3f}" for b, f in
                          sorted(s["residual_fetch_fraction"].items(),
                                 key=lambda kv: int(kv[0]))))
    if "swaps" in s:
        sw = s["swaps"]
        print(f"hot swaps: {sw['installs']} installs "
              f"({sw['delta_installs']} delta), "
              f"{sw['h2d_bytes']} bytes shipped, worst delta re-upload "
              f"{sw['max_delta_reupload_fraction']:.3%} of full")


def _gate(args, s) -> int:
    rc = 0
    if args.check_no_failures and (s["shed"] or s["timeout"]
                                   or s.get("errors", 0)):
        print(f"CHECK FAILED: {s['shed']} shed + {s['timeout']} timeout + "
              f"{s.get('errors', 0)} errored responses (expected none)")
        rc = 1
    if args.check_p99_ms is not None:
        p99 = s.get("p99_ms")
        if p99 is None or p99 > args.check_p99_ms:
            print(f"CHECK FAILED: p99 {p99} ms > bound {args.check_p99_ms} ms")
            rc = 1
    if rc == 0 and (args.check_no_failures or args.check_p99_ms is not None):
        print("checks passed")
    return rc


if __name__ == "__main__":
    sys.exit(main())
