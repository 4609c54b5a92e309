"""Fault-tolerant trainer on the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --steps 50 \\
      --smoke --ckpt-dir /tmp/ckpt --ckpt-every 10 [--resume] [--device cuda|cpu] \\
      [--devices N [--mesh DxM | PxDxM] [--backend nccl|gloo]]

The JAX package's ``launch/train.py`` on the port, run eagerly, on
``--device`` (default ``cuda``, which raises without a card).  Weights come
from the model's seeded initialiser (``--seed``), batches from the
step-indexed ``TokenPipeline(..., seed=1)``, the optimizer is the config's
(``OptConfig(name=cfg.optimizer, lr=--lr)``), ``--microbatch`` slices each
batch, ``--compress-grads`` quantizes the gradients to int8 with error
feedback.  Every ``--ckpt-every`` steps the whole ``TrainState`` is written
asynchronously in the reference's checkpoint layout (either package resumes
the other's, on any mesh); a write is joined before the next one starts.
``--resume`` restores the latest checkpoint; ``--simulate-failure N`` exits
with code 17 at step N to exercise the restart path, after the checkpoint
write in flight has finished (the reference exits at once, and on a card
the smoke model's steps outrun the write: the restart then found no
checkpoint).

``--devices N`` trains on a mesh of N ranks (``--mesh``, as the reference
parses it; default ``1xN``), each a process of its own
(``launch.mesh.spawn``) meeting at a file store in ``--ckpt-dir`` or a
temporary directory.  On the card each rank takes one card over NCCL and
fewer cards than ranks raises, unless ``--backend gloo`` asks for ranks
that share the cards; ``--device cpu`` runs gloo ranks.  Every rank draws
the weights from the seed a weight at a time and keeps its blocks of the
sharding rules' layout (``models.convert.init_sharded``), reads the same global
batch of each step and takes its rows (``training.train_step``).  Rank 0
prints, gathers the state a leaf at a time and writes the checkpoints; a
simulated failure joins rank 0's write in flight before every rank exits
with 17.
"""
import argparse
import sys

FAILURE_EXIT = 17


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--devices", type=int, default=0, help="ranks of the mesh")
    ap.add_argument("--mesh", default="", help="e.g. 2x4; default: 1 x devices")
    ap.add_argument("--backend", default=None,
                    help="nccl (the card's default: one card a rank) or gloo "
                         "(ranks may share a card; the CPU's)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--simulate-failure", type=int, default=-1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="the weights' seed")
    args = ap.parse_args(argv)

    if args.devices or args.mesh:
        return _mesh_main(args)
    from repro_torch import resolve_device

    _train(args, resolve_device(args.device))


def _mesh_main(args):
    import math
    import os
    import tempfile
    from pathlib import Path

    import torch.multiprocessing as mp

    from repro_torch.launch.mesh import parse_mesh, spawn

    shape = parse_mesh(args.mesh) if args.mesh else (1, args.devices)
    world = math.prod(shape)
    if args.devices and args.devices != world:
        raise ValueError(f"--mesh {args.mesh} has {world} ranks, --devices {args.devices}")
    base = Path(args.ckpt_dir) if args.ckpt_dir else Path(tempfile.mkdtemp())
    store = base / f".ranks_store_{os.getpid()}"
    try:
        spawn(_rank_main, world, args=(args, shape), device=args.device,
              backend=args.backend, store=store)
    except mp.ProcessExitedException as e:
        sys.exit(e.exit_code)
    finally:
        if store.exists():
            store.unlink()


def _rank_main(rank, world, dev, args, shape):
    from repro_torch.launch.mesh import make_mesh

    _train(args, dev, make_mesh(shape, device=dev))


def _train(args, dev, mesh=None):
    """The training loop on ``dev``: one process, or this rank of ``mesh``
    (a live ``launch.mesh.Mesh``; rank 0 prints and writes)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch import configs as C
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed import sharding as sh
    from repro_torch.ft import checkpoint as ckpt
    from repro_torch.models import get_model
    from repro_torch.models.convert import (abstract_train_state, gather_train_state,
                                            init_sharded, load_train_state,
                                            train_state_tree)
    from repro_torch.training import GradCompressor, OptConfig, init_state, make_train_step

    writes = mesh is None or mesh.rank == 0
    say = print if writes else (lambda *a, **k: None)
    cfg = C.get_smoke(args.arch) if args.smoke else C.get_config(args.arch)
    cfg = dataclasses.replace(cfg, microbatch=args.microbatch)
    api = get_model(cfg, dev)

    pipe = TokenPipeline(cfg.vocab, args.batch, args.seq, seed=1,
                         frontend=cfg.frontend, frontend_tokens=cfg.frontend_tokens,
                         d_model=cfg.d_model, encdec=cfg.is_encdec,
                         decoder_len=min(cfg.decoder_len_train, args.seq))

    # on a mesh each rank draws every weight and keeps its block, a weight
    # at a time (it never holds the whole model)
    params = (api.init(api.generator(args.seed)) if mesh is None
              else init_sharded(api, api.generator(args.seed), mesh))
    opt_cfg = OptConfig(name=cfg.optimizer, lr=args.lr)
    comp = GradCompressor() if args.compress_grads else None
    state = init_state(api.param_tree(params), opt_cfg, comp)
    step_fn = make_train_step(api.tree_loss, opt_cfg, microbatch=max(args.microbatch, 1),
                              compressor=comp, mesh=mesh)
    # the global shapes: a checkpoint holds the global arrays on any mesh
    abstract = abstract_train_state(cfg, api.abstract_params(), opt_cfg, comp is not None)
    specs = sh.state_specs(abstract, mesh) if mesh is not None else None

    start = 0
    if args.resume and args.ckpt_dir:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            tree, manifest = ckpt.restore(f"{args.ckpt_dir}/step_{last}", abstract,
                                          device=dev, mesh=mesh, spec_fn=sh.state_specs)
            load_train_state(state, tree)
            start = manifest["step"]
            say(f"[resume] restored step {start}")

    writer = metrics = None
    for step in range(start, args.steps):
        if step == args.simulate_failure:
            if writer is not None:
                # the write started two steps ago: let it reach the disk, so
                # the restart path resumes from it however fast the steps ran
                writer.join()
            if mesh is not None:
                dist.barrier()          # no rank exits before rank 0's write
            say(f"[failure] simulated crash at step {step}", flush=True)
            sys.exit(FAILURE_EXIT)
        batch = {k: torch.from_numpy(v).to(dev, torch.long if v.dtype.kind == "i" else None)
                 for k, v in pipe.batch_at(step).items()}
        state, metrics = step_fn(state, batch)
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            host = (train_state_tree(state) if mesh is None
                    else gather_train_state(state, specs, mesh))
            if writes:
                if writer is not None:
                    writer.join()
                writer = ckpt.save(f"{args.ckpt_dir}/step_{step + 1}", step + 1, host,
                                   metadata=dict(arch=args.arch), async_write=True)
            del host
    if writer is not None:
        writer.join()
    if metrics is not None:
        say(f"[done] final loss {float(metrics['loss']):.4f}")


if __name__ == "__main__":
    main()
