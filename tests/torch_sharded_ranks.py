"""Run the port's sharded search with one shard per rank of a process group
(``GroupShards``), and write each rank's results.

    python tests/torch_sharded_ranks.py INDEX_DIRS OUT_DIR WORLD CASES_JSON [nccl]

The ranks run on the CPU over gloo, or with ``nccl`` each on its own card
(rank r sees only card r).

``INDEX_DIRS`` is a comma-separated list of saved port indexes,
``CASES_JSON`` a JSON object {case: [index number, SearchParams fields,
overlap]}; the queries are ``<first index dir>/queries.npy``.  Rank r
writes ``OUT_DIR/rank{r}.npz`` with ``<case>/ids`` and ``<case>/dists``.
The ranks meet through a file store in ``OUT_DIR`` (no network) and are
started by ``torch.multiprocessing.spawn``.
"""
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank, world, paths, out, cases, backend):
    from repro_torch.index import Index, SearchParams

    torch.set_num_threads(1)
    device = "cpu"
    if backend == "nccl":
        os.environ["CUDA_VISIBLE_DEVICES"] = str(rank)    # before CUDA starts
        device = "cuda"
    dist.init_process_group(backend, init_method=f"file://{out / 'store'}",
                            rank=rank, world_size=world)
    try:
        indexes = [Index.load(p, device=device) for p in paths]
        q = np.load(Path(paths[0]) / "queries.npy")
        res = {}
        for name, (which, fields, overlap) in cases.items():
            run = indexes[which].searcher("sharded", SearchParams(**fields),
                                          group=dist.group.WORLD, overlap=overlap)
            r = run(q)
            res[name + "/ids"], res[name + "/dists"] = r.ids, r.dists
        np.savez(out / f"rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def main(argv):
    paths, out, world, cases = argv[0].split(","), Path(argv[1]), int(argv[2]), \
        json.loads(argv[3])
    backend = argv[4] if len(argv) > 4 else "gloo"
    mp.spawn(_rank, args=(world, paths, out, cases, backend), nprocs=world, join=True)


if __name__ == "__main__":
    main(sys.argv[1:])
