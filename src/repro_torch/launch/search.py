"""End-to-end NasZip retrieval command on the port's Index API: build (or
load) an index, run any backend, report recall and QPS.  The JAX package's
``launch/search.py``, with ``--shards N`` in place of its ``--devices N``
(the sharded backend stacks N shards on the one device) and ``--device``.

  PYTHONPATH=src python -m repro_torch.launch.search --dataset sift --ef 64 \\
      [--backend local|sharded|ndpsim] [--shards 4] [--no-fee] [--no-dfloat] \\
      [--storage f32|packed] [--save PATH | --load PATH] \\
      [--device cuda|cpu]

Everything runs on ``--device`` (default ``cuda``, which raises without a
card).
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="sift")
    ap.add_argument("--ef", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--no-fee", action="store_true")
    ap.add_argument("--no-dfloat", action="store_true")
    ap.add_argument("--storage", default="f32", choices=["f32", "packed"],
                    help="score dense f32 rows or the packed Dfloat bitstream")
    ap.add_argument("--dfloat-target", type=float, default=0.9)
    ap.add_argument("--backend", default="local",
                    choices=["local", "sharded", "ndpsim"])
    ap.add_argument("--sharded", action="store_true",
                    help="deprecated alias for --backend sharded")
    ap.add_argument("--ndp", action="store_true",
                    help="deprecated alias: also project DIMM-NDP perf")
    ap.add_argument("--shards", type=int, default=4,
                    help="sharded backend: shards stacked on the device")
    ap.add_argument("--save", default=None, help="persist the built index here")
    ap.add_argument("--load", default=None, help="load instead of building")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.sharded:
        args.backend = "sharded"

    import time

    from repro_torch import resolve_device
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.index import Index, IndexSpec, SearchParams

    dev = resolve_device(args.device)
    if args.storage == "packed" and args.no_dfloat:
        raise SystemExit("--storage packed scores the Dfloat bitstream; "
                         "drop --no-dfloat")
    db = make_dataset(args.dataset, device=dev)
    print(f"dataset {db.name}: {db.n} x {db.dim} ({db.metric}) on {dev}")
    if args.load:
        idx = Index.load(args.load, device=dev)
        print(f"index loaded from {args.load} (spec={idx.spec})")
    else:
        spec = IndexSpec.for_db(
            db, m=args.m,
            dfloat_recall_target=None if args.no_dfloat else args.dfloat_target)
        t0 = time.perf_counter()
        idx = Index.build(db, spec, device=dev)
        print(f"index built in {time.perf_counter()-t0:.1f}s  timings={idx.timings}")
    print(f"dfloat: {[(s.width, s.n_dims) for s in idx.dfloat_cfg.segments]} "
          f"bursts/vec {idx.dfloat_cfg.bursts_per_vector()}")
    if args.save:
        print(f"index saved to {idx.save(args.save)}")

    params = SearchParams(ef=args.ef, k=args.k, use_fee=not args.no_fee,
                          use_dfloat=not args.no_dfloat, storage=args.storage)

    if args.backend == "sharded":
        run = idx.searcher("sharded", params, n_shards=args.shards)
        t0 = time.perf_counter()
        res = run(db.queries)
        dt = time.perf_counter() - t0
        print(f"[sharded x{args.shards} on {dev}] recall@{args.k}="
              f"{res.recall(db.gt, args.k):.4f} wall {dt:.2f}s "
              f"({len(db.queries)/dt:.0f} q/s, first call)")
        print(f"collective payload per query and hop: {run.payload}")
        return

    traced = SearchParams(ef=args.ef, k=args.k, use_fee=not args.no_fee,
                          use_dfloat=not args.no_dfloat, storage=args.storage,
                          trace=True)
    t0 = time.perf_counter()
    res = idx.evaluate(db, traced)
    dt = time.perf_counter() - t0
    print(f"recall@{args.k}={res['recall']:.4f} hops={res['hops']:.1f} "
          f"evals={res['dist_evals']:.0f} dims/eval={res['dims_per_eval']:.1f}/{db.dim}")
    print(f"wall {dt:.2f}s for {len(db.queries)} queries")

    if args.backend == "ndpsim" or args.ndp:
        r = idx.searcher("ndpsim", params)(db.queries).sim
        print(f"[NDP 2ch] QPS={r.qps:.0f} lat={r.avg_latency_us:.0f}us "
              f"breakdown={ {k: round(v, 3) for k, v in r.breakdown().items()} } "
              f"pf={r.prefetch_hit:.2f}")


if __name__ == "__main__":
    main()
