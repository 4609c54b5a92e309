"""DaM-sharded distributed retrieval on the port (the JAX package's
``examples/distributed_search.py``): the paper's Fig. 12 mapping reached
through the unified ``Index.searcher("sharded")`` call.

  PYTHONPATH=src python -m repro_torch.launch.distributed_search \\
      [--shards 4] [--device cuda|cpu]

The reference runs its shards on a (2, 4) JAX mesh of fake devices; here
the ``--shards`` shards are stacked on the one device (``LocalShards``).
Everything runs on ``--device`` (default ``cuda``, which raises without a
card).
"""
from __future__ import annotations

import argparse


def build(device):
    """The example's ``unit`` database and its f32 index (m = 8, no Dfloat
    search) on ``device``."""
    from repro_torch.data import make_dataset
    from repro_torch.index import Index, IndexSpec

    db = make_dataset("unit", device=device)
    return db, Index.build(db, IndexSpec.for_db(db, m=8, dfloat_recall_target=None),
                           device=device)


def report(db, idx, n_shards: int, device) -> dict:
    """DaM's partition width, then the sharded search over every query: prints
    the example's lines and returns their numbers."""
    from repro_torch.core import graph as gmod
    from repro_torch.index import SearchParams

    print(f"shards: {n_shards} stacked on {device}; DB {db.n}x{db.dim}")
    owner = gmod.map_owners(db.n, n_shards, "shuffle")
    dam = gmod.build_dam(idx.graph.base_adjacency, owner, n_shards)
    width = dam.max_part_width()
    print(f"DaM: {n_shards} shards, partition width {width} "
          f"(full lists M=8) — vector+list co-location per shard")

    run = idx.searcher("sharded", SearchParams(ef=48, k=10, use_dfloat=False),
                       device=device, n_shards=n_shards)
    res = run(db.queries)
    recall = res.recall(db.gt, 10)
    print(f"sharded search recall@10 = {recall:.4f} over {len(db.queries)} queries")
    print(f"per-hop wire traffic: {run.payload} — ef x shards x 8B (ids+dists); "
          "vector payloads never cross shards (DaM)")
    return dict(n_shards=n_shards, n=db.n, dim=db.dim, partition_width=width,
                recall_at_10=recall, hops_max=int(res.hops.max()), payload=run.payload)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=4, help="shards stacked on the device")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device

    dev = resolve_device(args.device)
    db, idx = build(dev)
    return report(db, idx, args.shards, dev)


if __name__ == "__main__":
    main()
