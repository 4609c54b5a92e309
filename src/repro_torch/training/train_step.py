"""Train step factory: loss and gradients, microbatch accumulation,
gradient compression, optimizer.

The JAX package's ``training/train_step.py`` on the port, run eagerly.
Microbatches are contiguous slices of the batch (the reference's
``x.reshape(mb, B // mb, ...)`` order) and run one after the other, so only
one microbatch's activations are ever live (with remat inside the model);
their gradients accumulate into float32 zeros (bfloat16 for
``grad_acc_dtype="bf16"``), and the loss and the gradients are divided by
the microbatch count.  Compression comes after accumulation; ``grad_norm``
is taken in float32 over the gradients after compression.

The state is updated in place (the optimizer writes the weights and its
moments) and returned.  The reference's ``grad_shardings`` pins the
accumulator to a JAX mesh's parameter layout and has no counterpart on one
card: it is left out.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.training import optim
from repro_torch.training.compress import GradCompressor
from repro_torch.training.tree import regroup, tensors


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor          # 0-d int32, on the host
    error_fb: Any = None        # error-feedback residual (gradient compression)


def init_state(params, opt_cfg: optim.OptConfig, compressor: GradCompressor | None = None):
    """The state of a run that starts at ``params`` (a tree of tensors).
    Turns every weight's gradient on (``requires_grad_``)."""
    for t in tensors(params):
        t.requires_grad_(True)
    return TrainState(
        params=params,
        opt_state=optim.init_opt_state(params, opt_cfg),
        step=torch.zeros((), dtype=torch.int32),
        error_fb=compressor.init_error(params) if compressor else None,
    )


def make_train_step(loss_fn, opt_cfg: optim.OptConfig, microbatch: int = 1,
                    compressor: GradCompressor | None = None, grad_acc_dtype="f32"):
    """loss_fn(params, batch) -> (scalar, metrics dict); a batch is a dict of
    tensors with the batch on axis 0.  Returns ``train_step(state, batch) ->
    (state, metrics)``: ``loss`` (the total, MoE aux included) and
    ``grad_norm``, plus the loss function's own metrics when ``microbatch``
    is 1."""

    def grads_of(params, batch):
        ts = tensors(params)
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch)
            gs = torch.autograd.grad(loss, ts, allow_unused=True)
        gs = [torch.zeros_like(t) if g is None else g for t, g in zip(ts, gs)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, gs

    def train_step(state: TrainState, batch):
        if microbatch > 1:
            acc_dt = torch.bfloat16 if grad_acc_dtype == "bf16" else torch.float32
            acc = [torch.zeros(t.shape, dtype=acc_dt, device=t.device)
                   for t in tensors(state.params)]
            loss = torch.zeros((), dtype=torch.float32, device=acc[0].device)
            for i in range(microbatch):
                mbatch = {k: v.reshape(microbatch, v.shape[0] // microbatch, *v.shape[1:])[i]
                          for k, v in batch.items()}
                mloss, _, gs = grads_of(state.params, mbatch)
                with torch.no_grad():
                    for a, g in zip(acc, gs):
                        a.add_(g.to(acc_dt))
                del gs                  # before the next microbatch's backward
                loss = loss + mloss
            loss = loss / microbatch
            with torch.no_grad():
                for a in acc:
                    a.div_(microbatch)
            grads = regroup(state.params, acc)
            metrics = dict(loss=loss)
        else:
            loss, metrics, gs = grads_of(state.params, batch)
            grads = regroup(state.params, gs)

        error_fb = state.error_fb
        if compressor is not None:
            grads, error_fb = compressor.compress_decompress(grads, error_fb)

        params, opt_state = optim.apply_updates(state.params, grads,
                                                state.opt_state, opt_cfg)
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in tensors(grads)))
        metrics = dict(metrics, grad_norm=gnorm, loss=loss)
        return TrainState(params, opt_state, state.step + 1, error_fb), metrics

    return train_step
