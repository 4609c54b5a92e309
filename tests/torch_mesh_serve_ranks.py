"""Run the port's decode on gloo ranks of a mesh (the CPU), and write rank
0's results.

    python tests/torch_mesh_serve_ranks.py decode OUT_JSON LAYOUTS_JSON WEIGHTS_DIR \
        [cuda nccl|gloo]
    python tests/torch_mesh_serve_ranks.py ckpt OUT_JSON SHAPE CKPT_DIR

``decode``: ``LAYOUTS_JSON`` maps mesh shapes of one rank count (``{"2x1":
[...], "1x2": [...]}``) to JSON lists of cases (``{"arch": ..., "mode":
"serve" | "train"}``); the ranks build each mesh in turn and run its cases
(``repro_torch.models.mesh_check.serve_case``) on the reference's smoke
weights of the arch (``WEIGHTS_DIR/<arch>.npz``, the reference's tree with
"/"-joined keys; ``-``: the port's weights from seed 0), and rank 0 writes
the results by shape and each case's mesh logits beside them
(:func:`arrays_path`).  With ``cuda`` and a backend the ranks run on the
cards (TF32 off): ``nccl`` one card a rank, ``gloo`` ranks that share
them.  ``ckpt``: the smoke
llama's checkpoint ``CKPT_DIR`` (a training checkpoint of the weights,
global arrays) restored on each rank into its blocks of the serve layout
(``checkpoint.restore(mesh=, spec_fn=)`` and ``ft.elastic.reshard`` of the
host arrays, which must agree), then prefilled and decoded on the mesh in
serve mode; rank 0 holds the logits against the one-process model restored
from the same checkpoint and writes the error.  The ranks meet through a
file store beside ``OUT_JSON`` (no network) and run torch on one thread
each, at a lower priority (``nice`` 10).
"""
import json
import math
import os
import sys
from pathlib import Path

import numpy as np
import torch


def arrays_path(out, layout: str, i: int) -> Path:
    """Where ``decode`` writes case ``i`` of ``layout``'s mesh logits (the
    prefill's under ``0``, step s's under ``s``)."""
    out = Path(out)
    return out.with_name(f"{out.stem}-{layout}-{i}.npz")


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


def _weights(weights_dir, arch) -> dict:
    with np.load(Path(weights_dir) / f"{arch}.npz") as z:
        return _tree({k: z[k] for k in z.files})


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _rank(rank, world, dev, mode, shape, args, out):
    from repro_torch import configs as C
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.mesh_check import serve_case

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if mode == "decode":
        layouts, weights_dir = args
        res = {}
        for layout, cases in layouts.items():
            mesh = make_mesh([int(x) for x in layout.split("x")], device=dev)
            res[layout] = [serve_case(C.get_smoke(c["arch"]), mesh, c.get("mode", "serve"),
                                      tree=None if weights_dir == "-"
                                      else _weights(weights_dir, c["arch"]), keep=True)
                           for c in cases]
            for i, r in enumerate(res[layout] if rank == 0 else ()):
                np.savez(arrays_path(out, layout, i),
                         **{str(s): a for s, a in enumerate(r.pop("arrays"))})
    else:
        res = _from_checkpoint(rank, dev, shape, args[0])
    if rank == 0:
        Path(out).write_text(json.dumps(res))


def _from_checkpoint(rank, dev, shape, ckpt_dir) -> dict:
    """The ``ckpt`` mode (the module docstring)."""
    from repro_torch import configs as C
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.axes import set_mode, use_mesh
    from repro_torch.ft import checkpoint as ckpt
    from repro_torch.ft import elastic
    from repro_torch.launch.mesh import MeshShape, make_mesh
    from repro_torch.models import get_model
    from repro_torch.models.check import rel_err
    from repro_torch.models.convert import abstract_param_tree, from_jax_params, shard_params
    from repro_torch.models.mesh_check import decode_inputs, decode_run, gather_rows, rows
    from repro_torch.training.tree import leaves

    mesh = make_mesh(shape, device=dev)
    cfg = C.get_smoke("llama3.2-1b")
    api = get_model(cfg, dev)
    abstract = abstract_param_tree(cfg, api.abstract_params())
    serve_specs = lambda tree, m: sh.param_specs(tree, m, mode="serve")
    placed, manifest = ckpt.restore(ckpt_dir, abstract, device=dev, mesh=mesh,
                                    spec_fn=serve_specs)
    host, _ = ckpt.restore(ckpt_dir, abstract, device="cpu")
    moved = elastic.reshard(host, mesh, spec_fn=serve_specs)
    same = all(torch.equal(a, b) for a, b in zip(leaves(placed), leaves(moved)))
    # the blocks as the port's weights, each with its serve spec (a weight
    # that is already its block is left as it is)
    params = shard_params(cfg, from_jax_params(cfg, _numpy(placed), dev), mesh,
                          api.abstract_params(), mode="serve")
    x = decode_inputs(cfg)
    prev = set_mode("serve")
    try:
        with use_mesh(mesh):
            got, _ = decode_run(api, params, rows(x, mesh))
    finally:
        set_mode(prev)
    got = [gather_rows(g, x["tokens"].shape[0], mesh) for g in got]
    if rank != 0:
        return None
    one = from_jax_params(cfg, _numpy(host), dev)
    with use_mesh(MeshShape(mesh.shape, mesh.axis_names)):
        want, _ = decode_run(api, one, x)
    return dict(step=manifest["step"], same_blocks=same,
                logits=max(rel_err(g, w) for g, w in zip(got, want)))


def main(argv):
    from repro_torch.launch.mesh import spawn

    os.nice(10)         # the ranks (which inherit it) yield the CPU to other tests

    mode, out = argv[0], Path(argv[1])
    device, backend = "cpu", None
    if mode == "decode":
        layouts = json.loads(argv[2])
        shape = [int(x) for x in next(iter(layouts)).split("x")]
        args = (layouts, argv[3])
        if len(argv) > 4:
            device, backend = argv[4], argv[5]
    else:
        shape, args = [int(x) for x in argv[2].split("x")], tuple(argv[3:])
    spawn(_rank, math.prod(shape), args=(mode, shape, args, str(out)), device=device,
          backend=backend, store=out.with_suffix(".store"))


if __name__ == "__main__":
    main(sys.argv[1:])
