"""Checks of the training half that need a card, shared by ``chip_smoke.py``
and ``tests/test_torch_cuda.py``: one set of weights trained on the CPU and
on the card (card against CPU), and the trainer's crash and resume.

Errors are measured as in ``repro_torch.models.check``: the largest
difference over the largest |CPU value|, in float32 on the host.  The
parameters after one optimizer step are held as the CPU tests hold the
port's step against the reference's: ``rtol=2e-4, atol=2e-5``, counting the
elements outside (an element whose gradient is at the rounding level of the
two devices' difference can take the other sign through the optimizer's
normalisation and move by up to ``lr`` the other way).
"""
from __future__ import annotations

import copy
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.models import get_model
from repro_torch.models.check import rel_err
from repro_torch.models.common import ModelConfig
from repro_torch.training import optim
from repro_torch.training.tree import Stacked, leaves, regroup, tensors

RTOL, ATOL = 2e-4, 2e-5
TRAIN_ARGS = ("--smoke", "--arch", "llama3.2-1b", "--steps", "12", "--batch", "4",
              "--seq", "32", "--ckpt-every", "5")
CRASH_STEP, RESUME_STEP, FAILURE_EXIT = 7, 5, 17


def train_batch(cfg: ModelConfig, seed: int = 0, batch: int = 2, seq: int = 16,
                enc_len: int = 24) -> dict:
    """Seeded numpy tokens and labels, and the frames or patch embeddings
    the model's frontend stub takes."""
    rng = np.random.default_rng(seed)
    x = dict(tokens=rng.integers(0, cfg.vocab, (batch, seq)),
             labels=rng.integers(0, cfg.vocab, (batch, seq)))
    if cfg.is_encdec:
        x["frames"] = rng.standard_normal((batch, enc_len, cfg.d_model)).astype(np.float32)
    elif cfg.frontend == "vision":
        x["prefix_embeds"] = rng.standard_normal(
            (batch, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return x


def loss_and_grads(api, params, x: dict):
    """The loss and the gradient of every tensor of ``api.param_tree(params)``
    (turning the weights' gradients on), on the weights' device."""
    tree = api.param_tree(params)
    ts = tensors(tree)
    for t in ts:
        t.requires_grad_(True)
    batch = {k: torch.from_numpy(v).to(api.device) for k, v in x.items()}
    loss, _ = api.tree_loss(tree, batch)
    gs = torch.autograd.grad(loss, ts, allow_unused=True)
    return tree, loss.detach(), [torch.zeros_like(t) if g is None else g.detach()
                                 for t, g in zip(ts, gs)]


def _stacked(tree, flat: list) -> list:
    """``flat`` (one tensor per tensor of ``tree``) a leaf at a time, each
    ``Stacked`` group stacked, on the host in float32."""
    out = []
    for leaf in leaves(regroup(tree, flat)):
        t = torch.stack(list(leaf)) if isinstance(leaf, Stacked) else leaf
        out.append(t.detach().float().cpu())
    return out


def step_outside(got: list, want: list, lr: float) -> dict:
    """Elements of ``got`` outside ``rtol=RTOL, atol=ATOL`` of ``want``: their
    share and the largest excess over the bound, in units of ``lr``."""
    n_out = n = 0
    worst = 0.0
    for g, w in zip(got, want):
        excess = (g - w).abs() - (ATOL + RTOL * w.abs())
        n_out += int((excess > 0).sum())
        n += w.numel()
        worst = max(worst, float(excess.max()) / lr)
    return dict(share=n_out / n, over_lr=max(worst, 0.0))


def card_against_cpu(cfg: ModelConfig, device, seed: int = 0, lr: float = 1e-3,
                     optimizers=("adamw", "adafactor")) -> dict:
    """One set of weights drawn on the CPU, copied to ``device``: the loss's
    and every gradient leaf's largest error on the device against the CPU,
    and for each optimizer the parameters after one step from those
    gradients (``step_outside``)."""
    cpu_api, api = get_model(cfg, "cpu"), get_model(cfg, device)
    params = cpu_api.init(torch.Generator().manual_seed(seed))
    x = train_batch(cfg, seed)
    sides = ((cpu_api, copy.deepcopy(params)), (api, copy.deepcopy(params).to(api.device)))
    (p0, tree0, loss0, g0), (p1, tree1, loss1, g1) = (
        (p, *loss_and_grads(a, p, x)) for a, p in sides)
    out = dict(loss=rel_err(loss1, loss0),
               grads=max(rel_err(a, b) for a, b in zip(_stacked(tree1, g1),
                                                       _stacked(tree0, g0))))
    for name in optimizers:
        cfg_o = optim.OptConfig(name=name, lr=lr)
        after = []
        for a, p, g in ((cpu_api, p0, g0), (api, p1, g1)):
            tree = a.param_tree(copy.deepcopy(p))
            optim.apply_updates(tree, regroup(tree, g), optim.init_opt_state(tree, cfg_o), cfg_o)
            after.append(_stacked(tree, tensors(tree)))
        out[name] = step_outside(after[1], after[0], lr)
    return out


def _final_loss(out: str) -> float:
    return float(re.search(r"\[done\] final loss ([0-9.]+)", out).group(1))


def step_losses(out: str) -> dict:
    """``{step: loss}`` of the trainer's step lines."""
    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"step +(\d+) loss ([0-9.]+)", out)}


def resume_one_process(device: str, ckpt: Path, work: Path, src: Path,
                       timeout: float = 300) -> dict:
    """The one-process trainer on ``device`` resumed from the checkpoint
    directory ``ckpt`` (``.../step_N``, copied under ``work`` first: a
    run resuming in ``ckpt``'s directory may write beside it meanwhile)
    for one step: its exit code, whether it said ``restored step N`` and
    that step's loss."""
    import shutil

    n = int(ckpt.name.split("_")[1])
    shutil.copytree(ckpt, work / ckpt.name)
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device",
                           device, *TRAIN_ARGS, "--steps", str(n + 1), "--ckpt-dir",
                           str(work), "--resume"], env={**os.environ, "PYTHONPATH": str(src)},
                          capture_output=True, text=True, timeout=timeout)
    res = dict(rc=proc.returncode, restored=f"[resume] restored step {n}" in proc.stdout,
               loss=step_losses(proc.stdout).get(n))
    if proc.returncode:
        res["stderr"] = proc.stderr[-2000:]
    return res


def crash_and_resume(device: str, work: Path, src: Path, timeout: float = 300,
                     extra=(), alongside=None) -> dict:
    """``python -m repro_torch.launch.train`` on ``device`` (with ``extra``
    arguments, such as ``--devices 2``) three times: an uninterrupted run
    of 12 steps and a run that crashes at step 7 (both at once), then a
    ``--resume`` of the crashed run from its step-5 checkpoint.  Returns
    the exit codes, whether the resume said ``restored step 5``, both final
    losses and every step's loss of the uninterrupted run.  ``alongside``:
    a function of the crashed run's directory, called while the resume
    runs (its result under ``"alongside"``)."""
    env = {**os.environ, "PYTHONPATH": str(src)}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device", device, *TRAIN_ARGS,
           *extra]

    def start(ckpt_dir, *extra):
        return subprocess.Popen([*cmd, "--ckpt-dir", str(ckpt_dir), *extra], env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def finish(proc):
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        return proc.returncode, out, err

    full, crash = start(work / "full"), start(work / "crash", "--simulate-failure",
                                                str(CRASH_STEP))
    (rc_full, out_full, err_full), (rc_crash, _, err_crash) = finish(full), finish(crash)
    resume = start(work / "crash", "--resume")
    other = alongside(work / "crash") if alongside is not None else None
    rc_resume, out_resume, err_resume = finish(resume)
    res = dict(rc_full=rc_full, rc_crash=rc_crash, rc_resume=rc_resume,
               restored=f"[resume] restored step {RESUME_STEP}" in out_resume)
    if alongside is not None:
        res["alongside"] = other
    if rc_full == 0 and rc_resume == 0:
        res.update(final_loss=_final_loss(out_full), resumed_loss=_final_loss(out_resume),
                   losses=step_losses(out_full))
    else:
        res["stderr"] = (err_full or err_crash or err_resume)[-2000:]
    return res
