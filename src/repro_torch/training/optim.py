"""Optimizers as plain functions over trees of tensors (no ``torch.optim``).

The JAX package's ``training/optim.py`` on the port, with the reference's
formulas in its order of operations:

AdamW     — f32 moments; bias corrections ``1 - b ** step`` in float32;
            ``delta = mhat / (sqrt(vhat) + eps) + wd * p``; the update in
            float32, then cast to the leaf's dtype.  ``torch.optim.AdamW``
            decays before the step and rounds otherwise: not used.
Adafactor — factored second moment (rows/cols) for leaves of two or more
            axes, no first moment; decay ``1 - step ** -decay_pow``, rows
            normalised by their mean, the update clipped by its RMS, weight
            decay after the update.

The state is the reference's dict (``step``, ``mu``/``nu`` or ``v`` holding
``{vr, vc}`` or ``{v}``) with each state leaf in the reference's shape: a
``Stacked`` group of per-layer weights has one state array over the stack,
and Adafactor factors and clips the stacked array as the reference does.
``step`` is a 0-d int32 tensor on the host.  ``apply_updates`` writes the
weights and the state in place (no second copy of either at full width) and
returns them.

On a mesh (``apply_updates(..., mesh=)``) every leaf is this rank's block
(``training.tree.spec`` names its layout).  AdamW is elementwise and runs
on the blocks as they are.  Adafactor's row and column means, the mean of
its row factor and the RMS of the update reduce over dimensions a rank may
hold a block of: each sums its block and all-reduces the sum over the axes
that split the dimensions it reduces (the layout the reference's
``opt_specs`` gives ``vr`` and ``vc``).
"""
from __future__ import annotations

import dataclasses

import math

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import axis_size, entry_names, spec_axes
from repro_torch.training.tree import (leaves, parts, rebuild, spec, stack, stacked_zeros,
                                       tensors)


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    # adafactor
    decay_pow: float = 0.8
    clip_threshold: float = 1.0


def init_opt_state(params, cfg: OptConfig):
    if cfg.name == "adamw":
        zeros = lambda: rebuild(params, [stacked_zeros(p) for p in leaves(params)])
        return dict(step=torch.zeros((), dtype=torch.int32), mu=zeros(), nu=zeros())
    if cfg.name == "adafactor":
        def factored(p):
            shape = tuple(p.shape)
            z = lambda s: torch.zeros(s, dtype=torch.float32, device=tensors(p)[0].device)
            if len(shape) >= 2:
                return dict(vr=z(shape[:-1]), vc=z(shape[:-2] + shape[-1:]))
            return dict(v=z(shape))
        return dict(step=torch.zeros((), dtype=torch.int32),
                    v=rebuild(params, [factored(p) for p in leaves(params)]))
    raise ValueError(cfg.name)


def _f32(x: float, device) -> torch.Tensor:
    """A 0-d float32 tensor made on ``device`` (a fill, not a host copy)."""
    return torch.full((), x, dtype=torch.float32, device=device)


def _adamw_leaf(p, g, m, v, cfg: OptConfig, bc1, bc2):
    """One tensor's AdamW update in place: ``m``, ``v`` float32 slices of
    the state; ``bc1``, ``bc2`` the bias corrections (0-d, float32)."""
    g = g.float()
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
    delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
    p32 = p.float()
    delta.add_(cfg.weight_decay * p32)
    p.copy_(p32 - delta.mul_(cfg.lr))


def _mean(x, dim, entry, mesh, keepdim=False):
    """``x.mean(dim)`` of the global array when ``x`` is a block whose
    dimension ``dim`` is split over the axes of ``entry``."""
    if mesh is None or entry is None:
        return x.mean(dim, keepdim=keepdim)
    total = coll.all_reduce(x.sum(dim, keepdim=keepdim), mesh.group(entry_names(entry)))
    return total / (x.shape[dim] * axis_size(mesh, entry))


def _adafactor_leaf(p, g, v: dict, cfg: OptConfig, decay, mesh=None) -> dict:
    """The reference's Adafactor update of one leaf (stacked when a
    ``Stacked`` group; this rank's block on a mesh): the new weights
    written in place, the new state returned."""
    sp = spec(p) if mesh is not None else (None,) * len(p.shape)
    g = stack(g, torch.float32)
    g2 = g * g + 1e-30
    if g.ndim >= 2:
        vr = decay * v["vr"] + (1 - decay) * _mean(g2, -1, sp[-1], mesh)
        vc = decay * v["vc"] + (1 - decay) * _mean(g2, -2, sp[-2], mesh)
        # g-shaped fused chain: no (..., D, F) denominator buffer
        r = torch.rsqrt(vr / torch.clamp(_mean(vr, -1, sp[-2], mesh, keepdim=True),
                                         min=1e-30) + 1e-30)
        c = torch.rsqrt(vc + 1e-30)
        u = (g * r[..., None]) * c[..., None, :]
        nv = dict(vr=vr, vc=vc)
    else:
        nvv = decay * v["v"] + (1 - decay) * g2
        u = g * torch.rsqrt(nvv + 1e-30)
        nv = dict(v=nvv)
    # update clipping (Shazeer & Stern '18)
    if mesh is None or not spec_axes(sp):
        ms = torch.mean(u * u)
    else:
        ms = coll.all_reduce((u * u).sum(), mesh.group(spec_axes(sp))) / (
            u.numel() * math.prod(axis_size(mesh, e) for e in sp))
    rms = torch.sqrt(ms + 1e-30)
    u = u / torch.clamp(rms / cfg.clip_threshold, min=1.0)
    p32 = stack(p, torch.float32)
    newp = p32 - cfg.lr * u - cfg.lr * cfg.weight_decay * p32
    for t, new in zip(parts(p, p), parts(p, newp)):
        t.copy_(new)
    return nv


@torch.no_grad()
def apply_updates(params, grads, state, cfg: OptConfig, mesh=None):
    """One optimizer step over ``params`` with ``grads`` (a tree of the same
    structure; on ``mesh``, a live ``launch.mesh.Mesh``, this rank's
    blocks); returns ``(params, state)``, both updated in place."""
    step = state["step"] + 1
    ps, gs = leaves(params), leaves(grads)
    dev = tensors(params)[0].device
    s = float(step)             # the host's count: no copy to the device, no sync
    if cfg.name == "adamw":
        bc1 = 1 - _f32(cfg.b1, dev) ** s
        bc2 = 1 - _f32(cfg.b2, dev) ** s
        for p, g, m, v in zip(ps, gs, leaves(state["mu"]), leaves(state["nu"])):
            for pt, gt, mt, vt in zip(parts(p, p), parts(p, g), parts(p, m), parts(p, v)):
                _adamw_leaf(pt, gt, mt, vt, cfg, bc1, bc2)
        return params, dict(step=step, mu=state["mu"], nu=state["nu"])
    if cfg.name == "adafactor":
        decay = 1.0 - _f32(s, dev) ** (-cfg.decay_pow)
        vs = _state_leaves(params, state["v"])
        new_v = [_adafactor_leaf(p, g, v, cfg, decay, mesh) for p, g, v in zip(ps, gs, vs)]
        return params, dict(step=step, v=rebuild(params, new_v))
    raise ValueError(cfg.name)


def _state_leaves(params, v) -> list:
    """Adafactor's per-leaf state dicts, in ``params``' leaf order."""
    if isinstance(params, dict):
        return [x for k in sorted(params) for x in _state_leaves(params[k], v[k])]
    if isinstance(params, list):
        return [x for p, s in zip(params, v) for x in _state_leaves(p, s)]
    return [v]
