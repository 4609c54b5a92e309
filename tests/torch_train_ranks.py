"""Run the port's ``GradCompressor.compressed_psum`` with one member per rank
of a gloo process group, and write each rank's result.

    python tests/torch_train_ranks.py IN_NPZ OUT_DIR WORLD

``IN_NPZ`` holds, for each gradient leaf ``<name>``, ``<name>/g`` and
``<name>/e``: arrays (WORLD, ...) of which rank r takes row r as its
gradient and its error feedback.  Rank r writes ``OUT_DIR/rank{r}.npz`` with
``<name>/deq`` and ``<name>/err``.  The ranks meet through a file store in
``OUT_DIR`` (no network) and are started by ``torch.multiprocessing.spawn``.
"""
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank, world, inp, out):
    from repro_torch.training import GradCompressor

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out / 'store'}",
                            rank=rank, world_size=world)
    try:
        with np.load(inp) as z:
            names = sorted({k.rsplit("/", 1)[0] for k in z.files})
            grads = {n: torch.from_numpy(z[n + "/g"][rank]) for n in names}
            err = {n: torch.from_numpy(z[n + "/e"][rank]) for n in names}
        deq, err = GradCompressor(bits=8).compressed_psum(grads, err, group=dist.group.WORLD)
        res = {}
        for n in names:
            res[n + "/deq"], res[n + "/err"] = deq[n].numpy(), err[n].numpy()
        np.savez(out / f"rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def main(argv):
    inp, out, world = Path(argv[0]), Path(argv[1]), int(argv[2])
    mp.spawn(_rank, args=(world, inp, out), nprocs=world, join=True)


if __name__ == "__main__":
    main(sys.argv[1:])
