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
moments) and returned.

On a mesh (``make_train_step(..., mesh=)``, a live ``launch.mesh.Mesh``
that the caller has entered with ``distributed.axes.use_mesh``) every
state leaf is this rank's block in the rules' layout and the step takes
the global batch, every rank the same.  Microbatch j is the reference's
``x.reshape(mb, B // mb, ...)[j]`` sharded over the data axes: data rank r
of D takes its rows ``j * B/mb + r * B/(mb*D)`` onwards, ``B/(mb*D)`` of
them.  Each rank differentiates its rows' loss over D; the use sites'
backward reduce-scatters the gradients into the storage layout (the
reference's ``grad_shardings`` pin), so the accumulator is a block of the
global gradient; a leaf stored with no data axis is all-reduced over the
data axes once, after the last microbatch.  The loss and the model's
metrics are the mean over the data axes (the global batch's), and
``grad_norm`` the global one: each leaf's sum of squares all-reduced over
the axes that split it (a replicated leaf counted once).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.axes import use_mesh
from repro_torch.distributed.sharding import spec_axes
from repro_torch.training import optim
from repro_torch.training.compress import GradCompressor
from repro_torch.training.tree import leaves, regroup, spec, tensors


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


def _rows(batch: dict, microbatch: int, mesh) -> list[dict]:
    """The batch's microbatches, on a mesh this rank's rows of each."""
    out = []
    for i in range(microbatch):
        mb = {k: v.reshape(microbatch, v.shape[0] // microbatch, *v.shape[1:])[i]
              for k, v in batch.items()}
        if mesh is not None and mesh.dp_size > 1:
            n = next(iter(mb.values())).shape[0]
            if n % mesh.dp_size:
                raise ValueError(f"a microbatch of {n} rows does not split over "
                                 f"{mesh.dp_size} data-parallel ranks")
            k = n // mesh.dp_size
            mb = {key: v[mesh.dp_rank * k:(mesh.dp_rank + 1) * k] for key, v in mb.items()}
        out.append(mb)
    return out


def _reduce_grads(params, grads: list, mesh):
    """All-reduce over the data axes the gradients of leaves stored with no
    data axis (each rank holds its rows' part of them), in place."""
    it = iter(grads)
    for leaf in leaves(params):
        sp = spec(leaf)
        for _ in (leaf if isinstance(leaf, tuple) else (leaf,)):
            g = next(it)
            if all(e is None or e == mesh.axis_names[-1] for e in sp):
                g.copy_(coll.all_reduce(g, mesh.dp_group))


def _grad_norm(params, grads, mesh):
    """sqrt of the sum of squares over every gradient leaf (on a mesh, of
    the global leaves: each block's sum reduced over the axes that split
    it)."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in tensors(grads)))
    groups = {}
    for leaf, g in zip(leaves(params), leaves(grads)):
        axes = frozenset(spec_axes(spec(leaf)))
        ss = sum(torch.sum(t.float() * t.float()) for t in (g if isinstance(g, tuple) else (g,)))
        groups[axes] = groups.get(axes, 0) + ss
    return torch.sqrt(sum(coll.all_reduce(v, mesh.group(a)) if a else v
                          for a, v in groups.items()))


def make_train_step(loss_fn, opt_cfg: optim.OptConfig, microbatch: int = 1,
                    compressor: GradCompressor | None = None, grad_acc_dtype="f32",
                    mesh=None):
    """loss_fn(params, batch) -> (scalar, metrics dict); a batch is a dict of
    tensors with the batch on axis 0.  Returns ``train_step(state, batch) ->
    (state, metrics)``: ``loss`` (the total, MoE aux included) and
    ``grad_norm``, plus the loss function's own metrics when ``microbatch``
    is 1.  ``mesh``: a live ``launch.mesh.Mesh`` the state is sharded on
    (the module docstring)."""
    dp = 1 if mesh is None else mesh.dp_size

    def grads_of(params, batch):
        ts = tensors(params)
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch)
            # each data rank's rows: the reduce over the data axes sums the
            # ranks' gradients into the global batch's mean
            gs = torch.autograd.grad(loss / dp if dp > 1 else loss, ts, allow_unused=True)
        gs = [torch.zeros_like(t) if g is None else g for t, g in zip(ts, gs)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, gs

    def train_step(state: TrainState, batch):
        with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
            return _step(state, batch)

    def _step(state: TrainState, batch):
        mbs = _rows(batch, microbatch, mesh)
        if microbatch > 1:
            acc_dt = torch.bfloat16 if grad_acc_dtype == "bf16" else torch.float32
            acc = [torch.zeros(t.shape, dtype=acc_dt, device=t.device)
                   for t in tensors(state.params)]
            loss = torch.zeros((), dtype=torch.float32, device=acc[0].device)
            for mbatch in mbs:
                mloss, _, gs = grads_of(state.params, mbatch)
                with torch.no_grad():
                    for a, g in zip(acc, gs):
                        a.add_(g.to(acc_dt))
                del gs                  # before the next microbatch's backward
                loss = loss + mloss
            loss = loss / microbatch
            gs = acc
            metrics = dict(loss=loss)
        else:
            loss, metrics, gs = grads_of(state.params, mbs[0])
        with torch.no_grad():
            if mesh is not None:
                _reduce_grads(state.params, gs, mesh)
                names = sorted(metrics)
                vals = coll.all_reduce(torch.stack([loss] + [metrics[k] for k in names]),
                                       mesh.dp_group) / dp
                loss, metrics = vals[0], dict(zip(names, vals[1:]))
            if microbatch > 1:
                for a in gs:
                    a.div_(microbatch)
        grads = regroup(state.params, gs)

        error_fb = state.error_fb
        if compressor is not None:
            grads, error_fb = compressor.compress_decompress(grads, error_fb, mesh)

        params, opt_state = optim.apply_updates(state.params, grads,
                                                state.opt_state, opt_cfg, mesh)
        with torch.no_grad():
            gnorm = _grad_norm(state.params, grads, mesh)
        metrics = dict(metrics, grad_norm=gnorm, loss=loss)
        return TrainState(params, opt_state, state.step + 1, error_fb), metrics

    return train_step
