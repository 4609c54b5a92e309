"""Quickstart on the port: build a NasZip index and search it through the
unified API (the JAX package's ``examples/quickstart.py``).

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--tiny] \\
      [--dataset NAME] [--ef 64] [--device cuda|cpu]

Covers the full paper pipeline on a synthetic SIFT-like database:
PCA rotation -> alpha/beta estimation -> graph index -> Dfloat config search
-> FEE-sPCA beam search -> recall + memory-traffic report, plus the
save/load round trip and packed-native (bitstream) scoring.  Everything runs
on ``--device`` (default ``cuda``, which raises without a card).
"""
from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import numpy as np


def run(db, *, tiny: bool, ef: int, device) -> dict:
    """The example's four steps on ``db`` (a ``VecDB``): prints its lines and
    returns their numbers."""
    from repro_torch.index import Index, IndexSpec, SearchParams

    print(f"[1/4] dataset {db.name}: {db.n} vectors x {db.dim} dims ({db.metric})")
    spec = IndexSpec.for_db(db, m=8 if tiny else 16,
                            dfloat_recall_target=0.85 if tiny else 0.9,
                            dfloat_proxy=True)
    t0 = time.perf_counter()
    idx = Index.build(db, spec, device=device, cache_key=db.name)
    build_s = time.perf_counter() - t0
    segments = [(s.width, s.n_dims) for s in idx.dfloat_cfg.segments]
    bursts = idx.dfloat_cfg.bursts_per_vector()
    print(f"[2/4] index built in {build_s:.1f}s")
    print(f"      dfloat segments: {segments} -> {bursts} bursts/vector"
          f" (fp32: {db.dim // 4} bursts)")
    print(f"      alpha[0:4]={idx.fee.alpha[:4].round(3)}"
          f" beta[0:4]={idx.fee.beta[:4].round(3)}")

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "idx.naszip"
        idx.save(path)
        idx = Index.load(path, device=device)
        print(f"[3/4] save/load round trip through {path.name} ok")

    # recall on the fast early-terminating path (no tracing)
    res = idx.evaluate(db, SearchParams(ef=ef, k=10))
    # FEE statistics need per-hop traces: re-run a small traced batch
    stats = idx.search(db.queries[:48], SearchParams(ef=ef, k=10, trace=True))
    dims_per_eval = float(stats.dims.sum() / max(1, stats.n_eval.sum()))
    hops, evals = float(stats.hops.mean()), float(stats.n_eval.mean())
    print(f"[4/4] search ef={ef}: recall@10={res['recall']:.4f} "
          f"hops={hops:.1f} dist-evals={evals:.0f}")
    print(f"      dims touched per eval: {dims_per_eval:.1f} / {db.dim} "
          f"({dims_per_eval / db.dim * 100:.0f}% — FEE-sPCA early exit)")

    # packed-native scoring: same search, straight from the Dfloat bitstream
    f32 = idx.search(db.queries[:48], SearchParams(ef=ef, k=10))
    pk = idx.search(db.queries[:48], SearchParams(ef=ef, k=10, storage="packed"))
    bpv = (4 * idx.db_packed.shape[1], 4 * db.dim)
    same = bool(np.array_equal(pk.ids, f32.ids))
    print(f"      packed storage: {bpv[0]}B/vec vs {bpv[1]}B/vec f32 "
          f"({bpv[1] / bpv[0]:.1f}x), neighbor ids bit-identical: {same}")
    return dict(dataset=db.name, n=db.n, dim=db.dim, build_s=build_s,
                dfloat_segments=segments, bursts_per_vector=bursts,
                recall_at_10=res["recall"], hops=hops, dist_evals=evals,
                dims_per_eval=dims_per_eval, packed_bytes_per_vector=bpv[0],
                f32_bytes_per_vector=bpv[1], packed_ids_equal=same)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true", help="2k-vector test DB")
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--ef", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.data import make_dataset

    dev = resolve_device(args.device)
    db = make_dataset(args.dataset or ("unit" if args.tiny else "sift"), device=dev)
    return run(db, tiny=args.tiny, ef=args.ef, device=dev)


if __name__ == "__main__":
    main()
