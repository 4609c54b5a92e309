"""Streaming churn driver: a live serving shard under an append/delete mix.

The JAX package's ``launch/churn.py`` on the port.  Builds an index, wraps
it in ``repro_torch.streaming.MutableIndex``, and streams interleaved
append/delete batches while searching a frozen snapshot between rounds — the
serve-while-mutating pattern.  Reports append/delete throughput, per-insert
repair cost, generation trajectory, recall before vs after churn, DIMM-NDP
write-burst accounting (a model of the paper's hardware), and (optionally)
persists the WAL delta log and proves the replay round trip.

  PYTHONPATH=src python -m repro_torch.launch.churn --dataset unit --rounds 4 \
      [--append-frac 0.1] [--delete-frac 0.1] [--ef 64] \
      [--backend local|sharded|ndpsim] [--storage f32|packed] \
      [--save PATH] [--seed 0] [--device cuda|cpu]

Everything runs on ``--device`` (default ``cuda``, which raises without a
card); ``--backend sharded`` searches each snapshot through the sharded
backend with its default single shard.
"""
import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="unit")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--append-frac", type=float, default=0.1,
                    help="total appended rows as a fraction of the corpus")
    ap.add_argument("--delete-frac", type=float, default=0.1)
    ap.add_argument("--ef", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--ef-build", type=int, default=64)
    ap.add_argument("--backend", default="local",
                    choices=["local", "sharded", "ndpsim"])
    ap.add_argument("--storage", default="f32", choices=["f32", "packed"])
    ap.add_argument("--dfloat-target", type=float, default=None,
                    help="Dfloat recall target (default: fp32 layout)")
    ap.add_argument("--save", default=None,
                    help="persist base + WAL here and verify the replay "
                         "round trip returns bit-identical results")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch import resolve_device
    from repro_torch.data.synthetic import exact_topk, make_dataset, recall_at_k
    from repro_torch.index import Index, IndexSpec, SearchParams
    from repro_torch.streaming import MutableIndex

    dev = resolve_device(args.device)
    db = make_dataset(args.dataset, device=dev)
    print(f"dataset {db.name}: {db.n} x {db.dim} ({db.metric}) on {dev}")
    target = args.dfloat_target if args.storage == "f32" else (
        args.dfloat_target or 0.9)
    spec = IndexSpec.for_db(db, m=args.m, dfloat_recall_target=target)
    t0 = time.perf_counter()
    idx = Index.build(db, spec, device=dev)
    print(f"base index built in {time.perf_counter()-t0:.1f}s")

    params = SearchParams(ef=args.ef, k=args.k,
                          use_dfloat=target is not None,
                          storage=args.storage)
    pre = idx.searcher("local", params)(db.queries)
    print(f"pre-churn recall@{args.k}={recall_at_k(pre.ids, db.gt, args.k):.4f}")

    mi = MutableIndex(idx, ef_build=args.ef_build)
    rng = np.random.default_rng(args.seed)
    n_app = int(db.n * args.append_frac)
    n_del = int(db.n * args.delete_frac)
    per_app = -(-n_app // args.rounds)
    per_del = -(-n_del // args.rounds)
    # synthetic write stream: perturbed corpus rows (same distribution)
    noise = 0.05 * db.vectors.std()
    appended, deleted = [], []

    for r in range(args.rounds):
        src = rng.integers(0, db.n, per_app)
        new = db.vectors[src] + noise * rng.standard_normal(
            (per_app, db.dim)).astype(np.float32)
        t0 = time.perf_counter()
        appended.append(mi.append(new))
        t_app = time.perf_counter() - t0
        alive_base = np.setdiff1d(np.arange(db.n), np.concatenate(
            deleted) if deleted else np.empty(0, np.int64))
        dels = rng.choice(alive_base, min(per_del, len(alive_base)),
                          replace=False)
        t0 = time.perf_counter()
        mi.delete(dels)
        deleted.append(dels)
        t_del = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = mi.searcher(args.backend, params)(db.queries[:64])
        t_q = time.perf_counter() - t0
        print(f"round {r}: +{per_app} rows ({per_app/t_app:.0f} rows/s) "
              f"-{len(dels)} rows ({t_del*1e3:.1f} ms) "
              f"gen={res.generation} n_alive={mi.n_alive} "
              f"search 64q in {t_q*1e3:.0f} ms [{args.backend}]")

    # post-churn recall against exact ground truth over survivors
    surv = mi.alive_ids()
    gt = exact_topk(mi._rot[surv], mi.spca.transform(db.queries), args.k,
                    db.metric, device=dev)
    post = mi.searcher(args.backend, params)(db.queries)
    rec = recall_at_k(post.ids, surv[gt], args.k)
    dead = np.nonzero(mi._dead[: mi.n])[0]
    leaked = int(np.isin(post.ids, dead).sum())
    st = mi.stats
    print(f"post-churn recall@{args.k}={rec:.4f}  tombstones in results: "
          f"{leaked} (must be 0)")
    print(f"totals: +{st.rows_appended}/-{st.rows_deleted} rows, "
          f"{st.edge_writes} edge writes, repair {st.repairs_drained} "
          f"tombstones in {st.repair_s*1e3:.0f} ms "
          f"({st.repair_s/max(st.rows_appended,1)*1e6:.0f} us/insert amortized)")
    ws = mi.write_stats()
    print(f"NDP write traffic (ndpsim model): {ws.dram_bytes/1e3:.1f} KB "
          f"({ws.write_burst_groups} burst groups, {ws.t_write_us:.0f} us, "
          f"{ws.energy_uj:.1f} uJ)")

    if args.save:
        path = mi.save_delta(args.save)
        m2 = MutableIndex.load(path, ef_build=args.ef_build, device=dev)
        r2 = m2.searcher(args.backend, params)(db.queries)
        ok = (np.array_equal(post.ids, r2.ids)
              and np.array_equal(post.dists, r2.dists))
        print(f"delta log saved to {path}; replay round trip "
              f"{'bit-identical' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(1)
    if leaked:
        raise SystemExit("tombstoned ids leaked into results")


if __name__ == "__main__":
    main()
