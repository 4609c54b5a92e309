"""Run the port's mesh training on gloo ranks of one mesh shape (the
CPU), and write rank 0's results.

    python tests/torch_mesh_ranks.py steps OUT_JSON LAYOUTS_JSON [cuda nccl|gloo]
    python tests/torch_mesh_ranks.py save  OUT_JSON SHAPE WEIGHTS_NPZ CKPT_DIR
    python tests/torch_mesh_ranks.py load  OUT_JSON SHAPE CKPT_DIR

``SHAPE`` is a mesh such as ``2x2``.  ``steps``: ``LAYOUTS_JSON`` maps mesh
shapes of one rank count (``{"2x1": [...], "1x2": [...]}``) to JSON lists
of ``repro_torch.training.mesh_check.Case`` fields (smoke configurations,
with ``config`` overrides); the ranks build each mesh in turn and run its
cases one after the other (``mesh_check.step_case``), and rank 0 writes
the results by shape (one spawn for the layouts of a rank count), and each
case's initial and final weights beside them (:func:`arrays_path`).  With
``cuda`` and a backend the ranks run on the cards (TF32 off): ``nccl`` one
card a rank, ``gloo`` ranks that share them.  ``save``:
the smoke llama's weights (``WEIGHTS_NPZ``: the reference's tree, keys
"/"-joined) cut to each rank's blocks (``from_jax_params(mesh=)``),
gathered a leaf at a time and written by rank 0 with
``repro_torch.ft.checkpoint.save`` (step 1).  ``load``: the checkpoint
placed on the mesh twice, by ``checkpoint.restore(mesh=)`` and by
``ft.elastic.reshard`` of the host arrays; rank 0 writes the checksum of
``tests/test_ft.py::test_elastic_reshard_across_device_counts`` (the sum of
|x| over the leaves, each in float32) of the gathered blocks of each, and
whether every rank's blocks are its cut of the global arrays.  The ranks
meet through a file store beside ``OUT_JSON`` (no network) and run torch on
one thread each, at a lower priority (``nice`` 10): a suite run in parallel
keeps its timing-sensitive tests' share of the CPU.
"""
import dataclasses
import json
import math
import os
import sys
from pathlib import Path

import numpy as np
import torch


def _checksum(tree) -> float:
    from repro_torch.training.tree import leaves

    return sum(float(torch.sum(torch.abs(x.float()))) for x in leaves(tree))


def _gathered(tree, specs, mesh):
    from repro_torch.distributed import sharding as sh

    if isinstance(tree, dict):
        return {k: _gathered(v, specs[k], mesh) for k, v in tree.items()}
    return sh.gather(tree, specs, mesh)


def _rank(rank, world, dev, mode, shape, args, out):
    from repro_torch import configs as C
    from repro_torch.distributed import sharding as sh
    from repro_torch.ft import checkpoint as ckpt
    from repro_torch.ft import elastic
    from repro_torch.launch.mesh import make_mesh, parse_mesh
    from repro_torch.models import get_model
    from repro_torch.models.convert import abstract_param_tree, from_jax_params
    from repro_torch.training.mesh_check import Case, global_leaves, step_case

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if mode == "steps":
        res = {}
        for layout, cases in args[0].items():
            mesh = make_mesh(parse_mesh(layout), device=dev)
            res[layout] = [step_case(dataclasses.replace(C.get_smoke(c["arch"]),
                                                         **c.get("config", {})),
                                     Case(**c), mesh, keep=True) for c in cases]
            for i, r in enumerate(res[layout] if rank == 0 else ()):
                arrays = r.pop("arrays")
                np.savez(arrays_path(out, layout, i),
                         **{f"{k}/{p}": a for k in arrays for p, a in sh.flat(arrays[k]).items()})
    else:
        mesh = make_mesh(shape, device=dev)
        cfg = C.get_smoke("llama3.2-1b")
        api = get_model(cfg, dev)
        abstract = abstract_param_tree(cfg, api.abstract_params())
        if mode == "save":
            with np.load(args[0]) as z:
                tree = _tree({k: z[k] for k in z.files})
            params = from_jax_params(cfg, tree, dev, mesh=mesh)
            ptree = api.param_tree(params)
            flat = global_leaves(ptree, mesh)
            res = None
            if rank == 0:
                from repro_torch.training.tree import rebuild
                ckpt.save(args[1], 1, rebuild(abstract, flat))
                res = dict(saved=world)
        else:
            specs = sh.param_specs(abstract, mesh)
            placed, _ = ckpt.restore(args[0], abstract, device=dev, mesh=mesh)
            host, _ = ckpt.restore(args[0], abstract, device="cpu")
            moved = elastic.reshard(host, mesh)
            same = all(torch.equal(a, sh.shard(h, s, mesh))
                       for a, h, s in zip(*(_leaves(t) for t in (placed, host, specs))))
            same = same and all(torch.equal(a, b) for a, b in
                                zip(_leaves(placed), _leaves(moved)))
            ok = torch.tensor([int(same)])
            torch.distributed.all_reduce(ok, op=torch.distributed.ReduceOp.MIN)
            res = dict(restored=world, blocks_ok=bool(ok.item()),
                       restore=_checksum(_gathered(placed, specs, mesh)),
                       reshard=_checksum(_gathered(moved, specs, mesh)))
    if rank == 0:
        Path(out).write_text(json.dumps(res))


def _tree(flat: dict) -> dict:
    """``{"a/b": x}`` as the nested dict ``{"a": {"b": x}}``."""
    tree = {}
    for k, x in flat.items():
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = x
    return tree


def arrays_path(out, layout: str, i: int) -> Path:
    """Where ``steps`` writes case ``i`` of ``layout``'s weights: the
    initial ones under ``init/`` and the gathered ones after the last step
    under ``final/``, each keyed by its path in the reference's tree."""
    out = Path(out)
    return out.with_name(f"{out.stem}-{layout}-{i}.npz")


def _leaves(tree) -> list:
    from repro_torch.training.tree import leaves

    return leaves(tree)


def main(argv):
    from repro_torch.launch.mesh import parse_mesh, spawn

    os.nice(10)         # the ranks (which inherit it) yield the CPU to other tests

    mode, out = argv[0], Path(argv[1])
    device, backend = "cpu", None
    if mode == "steps":
        layouts = json.loads(argv[2])
        shape = parse_mesh(next(iter(layouts)))
        if {math.prod(parse_mesh(k)) for k in layouts} != {math.prod(shape)}:
            raise ValueError(f"one spawn runs layouts of one rank count: {list(layouts)}")
        args = (layouts,)
        if len(argv) > 3:
            device, backend = argv[3], argv[4]
    else:
        shape, args = parse_mesh(argv[2]), tuple(argv[3:])
    spawn(_rank, math.prod(shape), args=(mode, shape, args, str(out)), device=device,
          backend=backend, store=out.with_suffix(".store"))


if __name__ == "__main__":
    main(sys.argv[1:])
