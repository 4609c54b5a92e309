"""Fault-tolerant trainer on the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --steps 50 \\
      --smoke --ckpt-dir /tmp/ckpt --ckpt-every 10 [--resume] [--device cuda|cpu]

The JAX package's ``launch/train.py`` on one device (``--device``, default
``cuda``, which raises without a card), run eagerly.  Weights come from the
model's seeded initialiser (``--seed``), batches from the step-indexed
``TokenPipeline(..., seed=1)``, the optimizer is the config's
(``OptConfig(name=cfg.optimizer, lr=--lr)``), ``--microbatch`` slices each
batch, ``--compress-grads`` quantizes the gradients to int8 with error
feedback.  Every ``--ckpt-every`` steps the whole ``TrainState`` is written
asynchronously in the reference's checkpoint layout (either package resumes
the other's); a write is joined before the next one starts.  ``--resume``
restores the latest checkpoint; ``--simulate-failure N`` exits with code 17
at step N to exercise the restart path, after the checkpoint write in
flight has finished (the reference exits at once, and on a card the smoke
model's steps outrun the write: the restart then found no checkpoint).

Multi-card training (the reference's ``--devices`` and ``--mesh``) is not
ported yet: both flags raise.
"""
import argparse
import sys

FAILURE_EXIT = 17


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--devices", type=int, default=0,
                    help="multi-card training: not ported yet, raises")
    ap.add_argument("--mesh", default="", help="multi-card training: not ported yet, raises")
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
        raise NotImplementedError(
            "multi-card training (--devices / --mesh) is not ported yet: data "
            "parallel over a torch.distributed group is queued in ROADMAP.md (A16)")

    import dataclasses

    import torch

    from repro_torch import configs as C
    from repro_torch import resolve_device
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.ft import checkpoint as ckpt
    from repro_torch.models import get_model
    from repro_torch.models.convert import load_train_state, train_state_tree
    from repro_torch.training import GradCompressor, OptConfig, init_state, make_train_step

    dev = resolve_device(args.device)
    cfg = C.get_smoke(args.arch) if args.smoke else C.get_config(args.arch)
    cfg = dataclasses.replace(cfg, microbatch=args.microbatch)
    api = get_model(cfg, dev)

    pipe = TokenPipeline(cfg.vocab, args.batch, args.seq, seed=1,
                         frontend=cfg.frontend, frontend_tokens=cfg.frontend_tokens,
                         d_model=cfg.d_model, encdec=cfg.is_encdec,
                         decoder_len=min(cfg.decoder_len_train, args.seq))

    params = api.init(api.generator(args.seed))
    opt_cfg = OptConfig(name=cfg.optimizer, lr=args.lr)
    comp = GradCompressor() if args.compress_grads else None
    state = init_state(api.param_tree(params), opt_cfg, comp)
    step_fn = make_train_step(api.tree_loss, opt_cfg, microbatch=max(args.microbatch, 1),
                              compressor=comp)

    start = 0
    if args.resume and args.ckpt_dir:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            tree, manifest = ckpt.restore(f"{args.ckpt_dir}/step_{last}",
                                          train_state_tree(state, abstract=True), device=dev)
            load_train_state(state, tree)
            start = manifest["step"]
            print(f"[resume] restored step {start}")

    writer = metrics = None
    for step in range(start, args.steps):
        if step == args.simulate_failure:
            if writer is not None:
                # the write started two steps ago: let it reach the disk, so
                # the restart path resumes from it however fast the steps ran
                writer.join()
            print(f"[failure] simulated crash at step {step}", flush=True)
            sys.exit(FAILURE_EXIT)
        batch = {k: torch.from_numpy(v).to(dev, torch.long if v.dtype.kind == "i" else None)
                 for k, v in pipe.batch_at(step).items()}
        state, metrics = step_fn(state, batch)
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            if writer is not None:
                writer.join()
            writer = ckpt.save(f"{args.ckpt_dir}/step_{step + 1}", step + 1,
                               train_state_tree(state), metadata=dict(arch=args.arch),
                               async_write=True)
    if writer is not None:
        writer.join()
    if metrics is not None:
        print(f"[done] final loss {float(metrics['loss']):.4f}")


if __name__ == "__main__":
    main()
