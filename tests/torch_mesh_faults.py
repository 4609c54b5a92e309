"""The readings behind ``chip_smoke.py`` phase 13b's bounds, on the card.

    PYTHONPATH=src python tests/torch_mesh_faults.py [--out FILE]

llama3.2-1b at its published width (``repro_torch.training.mesh_check.
full_width_run``: bfloat16, AdamW lr 3e-4, batch 8 x 128, microbatch 2,
remat) on 2 gloo ranks sharing one card, each loss and ``grad_norm`` of 4
steps relative to the one-process trainer's from the same seeded weights
on the same batches: the sound mesh at (2, 1) and (1, 2), then three
faults planted in the ranks' memory only (no file changes):

- ``rs_own_chunk`` (2, 1): the gradients' reduce-scatter over the data axes
  keeps each rank's own chunk instead of the sum;
- ``no_replicated_allreduce`` (2, 1): the replicated leaves' gradients are
  not all-reduced over the data axes;
- ``no_model_allreduce`` (1, 2): the input gradient of a product split
  over ``model`` is not all-reduced (Megatron's conjugate pair broken);

and ``gloo_own`` (2, 1): the sound mesh on gloo's own all-gather and
reduce-scatter instead of ``distributed.collectives``' broadcasts (its
step times against the sound run's; 3 steps).  One JSON line a run, after
the card's name and power limit; ``--out`` also writes them all.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

VARIANTS = [((2, 1), "sound"), ((1, 2), "sound"), ((2, 1), "rs_own_chunk"),
            ((2, 1), "no_replicated_allreduce"), ((1, 2), "no_model_allreduce"),
            ((2, 1), "gloo_own")]


def rank_fn(rank, world, dev, shape, variant, out):
    import torch.distributed as dist

    from repro_torch.distributed import axes, collectives
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import mesh_check, train_step

    if variant == "rs_own_chunk":
        def own(o, src, group):
            o.copy_(src.chunk(dist.get_world_size(group))[dist.get_rank(group)])
        collectives._gloo_reduce_scatter = own
    elif variant == "no_replicated_allreduce":
        train_step._reduce_grads = lambda params, grads, mesh: None
    elif variant == "no_model_allreduce":
        axes._Copy.backward = staticmethod(lambda ctx, g: (g, None))
    elif variant == "gloo_own":
        collectives._gloo = lambda group: False
        mesh_check.FULL = dict(mesh_check.FULL, steps=3)
    res = mesh_check.full_width_run(make_mesh(shape, device=dev))
    if rank == 0:
        Path(out).write_text(json.dumps(res))


def reference() -> dict:
    """The one-process trainer's losses and grad norms (as phase 13 runs it)."""
    from repro_torch import configs as C
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import get_model
    from repro_torch.training import OptConfig, init_state, make_train_step, mesh_check

    dev = torch.device("cuda")
    cfg = C.get_config(mesh_check.FULL_ARCH)
    full = mesh_check.FULL
    api = get_model(cfg, dev)
    params = api.init(api.generator(0))
    opt = OptConfig(name=cfg.optimizer, lr=full["lr"])
    state = init_state(api.param_tree(params), opt)
    step = make_train_step(api.tree_loss, opt, microbatch=cfg.microbatch)
    pipe = TokenPipeline(cfg.vocab, full["batch"], full["seq"], seed=1)
    ref = dict(losses=[], grad_norms=[])
    for i in range(full["steps"]):
        b = {k: torch.from_numpy(v).to(dev, torch.long) for k, v in pipe.batch_at(i).items()}
        state, m = step(state, b)
        ref["losses"].append(float(m["loss"]))
        ref["grad_norms"].append(float(m["grad_norm"]))
    del state, params, m
    torch.cuda.empty_cache()
    return ref


def main(argv=None):
    import tempfile

    from repro_torch.launch.mesh import spawn

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write every run's line here (JSON)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    ref = reference()
    print(json.dumps({"reference": ref}), flush=True)
    results = {"reference": ref}
    with tempfile.TemporaryDirectory() as d:
        for shape, variant in VARIANTS:
            t0 = time.perf_counter()
            out = Path(d) / "res.json"
            out.unlink(missing_ok=True)
            try:
                spawn(rank_fn, 2, args=(shape, variant, str(out)), device="cuda",
                      backend="gloo", store=Path(d) / "store")
                f = json.loads(out.read_text())
                row = dict(mesh=list(shape), variant=variant, s=time.perf_counter() - t0,
                           loss_rel=[abs(a - b) / abs(b)
                                     for a, b in zip(f["losses"], ref["losses"])],
                           gnorm_rel=[abs(a - b) / abs(b)
                                      for a, b in zip(f["grad_norms"], ref["grad_norms"])],
                           step_ms=f["step_ms"], counted=f["counted_step"]["step_ms"],
                           collective_ms=f["counted_step"]["collective_ms"],
                           ranks=f["ranks"], largest_weight_gb=f["largest_weight_gb"],
                           init_s=f["init_s"])
            except Exception as e:          # a planted fault may also fail outright
                row = dict(mesh=list(shape), variant=variant, error=repr(e)[:500])
            results[f"{variant} {shape}"] = row
            print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
