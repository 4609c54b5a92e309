"""Train the smoke llama for a few hundred steps with the full stack:
microbatch accumulation, checkpointing, resume.

  PYTHONPATH=src python -m repro_torch.launch.train_lm [--steps 300] [--device cuda|cpu]

The JAX package's ``examples/train_lm.py`` on the port: the same arguments
to ``repro_torch.launch.train`` (llama3.2-1b's smoke config, batch 8, seq
128, microbatch 2, a checkpoint every 50 steps under ``--ckpt``, resuming
from the latest), on ``--device`` (default ``cuda``, which raises without
a card).  ``--devices N`` trains on a ``1xN`` mesh of N ranks (one card a
rank over NCCL, or ``--backend gloo`` for ranks that share cards; gloo
ranks on ``--device cpu``).
"""
import argparse
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_ckpt"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)

    from repro_torch.launch import train

    argv = ["--arch", "llama3.2-1b", "--smoke", "--steps", str(args.steps),
            "--batch", "8", "--seq", "128", "--microbatch", "2",
            "--ckpt-dir", args.ckpt, "--ckpt-every", "50", "--resume",
            "--device", args.device]
    if args.devices:
        argv += ["--devices", str(args.devices), "--mesh", f"1x{args.devices}"]
    if args.backend:
        argv += ["--backend", args.backend]
    train.main(argv)


if __name__ == "__main__":
    main()
