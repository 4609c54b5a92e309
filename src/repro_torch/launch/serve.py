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
builds persist under ``build/repro_torch_kernels/``).  ``--decode`` runs the
LM prefill + decode smoke path on ``repro_torch.models`` instead:

  PYTHONPATH=src python -m repro_torch.launch.serve --decode \
      [--arch llama3.2-1b] [--smoke] [--batch 4] [--prompt-len 64] [--gen 32] \
      [--temperature 0] [--device cuda|cpu] \
      [--devices N [--mesh DxM | PxDxM] [--backend nccl|gloo]]

with weights from the model's seeded initialiser, a seeded prompt (frames for
whisper, patch embeddings before the tokens for llava), greedy decoding or,
with ``--temperature``, draws from a seeded ``torch.Generator``.  The cache
holds the patch positions too (the reference's does not, so its llava
steps run past the cache); a step past the cache raises.

``--devices N`` serves on a mesh of N ranks (``--mesh``, default ``1xN``;
the reference's flag sets N fake host devices and builds no mesh), each a
process of its own (``launch.mesh.spawn``) as ``launch/train.py`` runs
them: NCCL one card a rank on the card, ``--backend gloo`` for ranks that
share the cards, gloo ranks with ``--device cpu``.  Every rank draws the
weights from the seed a weight at a time in the serve layout
(``models.convert.init_sharded(mode="serve")``, ``axes.set_mode("serve")``),
takes its rows of the global prompt, prefills its blocks of the cache and
decodes; rank 0 prints the lines one process prints (the global batch's
times, its own first row's tokens, which are the global batch's first).
Greedy decoding gives the one-process tokens; ``--temperature`` draws
from each rank's generator over its rows.  ``--devices 0`` is one process.
"""
import argparse
import json
import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if "--decode" in argv:
        return _decode_main([a for a in argv if a != "--decode"])
    return _serve_main(argv)


def _serve_main(argv):
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


# ---------------------------------------------------------------------------
# LM prefill + decode smoke
# ---------------------------------------------------------------------------
def _decode_main(argv):
    ap = argparse.ArgumentParser(description="LM prefill + decode smoke")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--devices", type=int, default=0, help="ranks of the mesh")
    ap.add_argument("--mesh", default="", help="e.g. 1x2; default: 1 x devices")
    ap.add_argument("--backend", default=None,
                    help="nccl (the card's default: one card a rank) or gloo "
                         "(ranks may share a card; the CPU's)")
    args = ap.parse_args(argv)
    if args.devices or args.mesh:
        return _decode_mesh_main(args)
    from repro_torch import resolve_device

    return _decode(args, resolve_device(args.device))


def _decode_mesh_main(args):
    import math
    import os
    import tempfile
    from pathlib import Path

    from repro_torch.launch.mesh import parse_mesh, spawn

    shape = parse_mesh(args.mesh) if args.mesh else (1, args.devices)
    world = math.prod(shape)
    if args.devices and args.devices != world:
        raise ValueError(f"--mesh {args.mesh} has {world} ranks, --devices {args.devices}")
    with tempfile.TemporaryDirectory() as d:
        spawn(_decode_rank, world, args=(args, shape), device=args.device,
              backend=args.backend, store=Path(d) / f"store_{os.getpid()}")
    return 0


def _decode_rank(rank, world, dev, args, shape):
    from repro_torch.launch.mesh import make_mesh

    _decode(args, dev, make_mesh(shape, device=dev))


def _decode(args, dev, mesh=None):
    """The prefill + decode smoke on ``dev``: one process, or this rank of
    ``mesh`` (a live ``launch.mesh.Mesh``; rank 0 prints)."""
    import contextlib
    import time

    import numpy as np
    import torch

    from repro_torch import configs as C
    from repro_torch.distributed.axes import set_mode, use_mesh
    from repro_torch.models import get_model
    from repro_torch.models.convert import init_sharded

    cfg = C.get_smoke(args.arch) if args.smoke else C.get_config(args.arch)
    api = get_model(cfg, dev)
    rng = np.random.default_rng(0)

    kv_len = args.prompt_len + args.gen
    if cfg.is_encdec:
        batch = dict(frames=rng.standard_normal(
            (args.batch, args.prompt_len, cfg.d_model)).astype(np.float32))
    elif cfg.frontend == "vision":
        batch = dict(
            prefix_embeds=rng.standard_normal(
                (args.batch, cfg.frontend_tokens, cfg.d_model)).astype(np.float32),
            tokens=rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)))
        kv_len += cfg.frontend_tokens
    else:
        batch = dict(tokens=rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)))
    if mesh is None:
        params = api.init(api.generator(0))
        scope = contextlib.nullcontext()
    else:
        from repro_torch.models.mesh_check import rows

        set_mode("serve")
        params = init_sharded(api, api.generator(0), mesh, mode="serve")
        batch = rows(batch, mesh)
        scope = use_mesh(mesh)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)

    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    with scope:
        t0 = time.perf_counter()
        logits, cache = api.prefill(params, batch, kv_len)
        sync()
        t_prefill = time.perf_counter() - t0

        gen = torch.Generator(dev).manual_seed(1)
        tok = logits.argmax(-1)
        out_tokens = [tok]
        t0 = time.perf_counter()
        for _ in range(args.gen - 1):
            logits, cache = api.decode(params, cache, tok)
            if args.temperature > 0:
                probs = torch.softmax(logits.float() / args.temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                tok = logits.argmax(-1)
            out_tokens.append(tok)
        toks = torch.stack(out_tokens, 1).cpu().numpy()
        t_decode = time.perf_counter() - t0

    say(f"prefill: {t_prefill*1e3:.1f} ms for {args.batch}x{args.prompt_len}")
    say(f"decode:  {t_decode*1e3:.1f} ms for {args.gen-1} steps "
        f"({(args.gen-1)*args.batch/max(t_decode,1e-9):.0f} tok/s)")
    say("sample token ids:", toks[0, :12].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
