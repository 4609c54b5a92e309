"""Trees of tensors for the training half: what the reference's pytrees are.

A tree is a nested dict (or list) whose leaves are tensors or
:class:`Stacked` groups.  A ``Stacked`` leaf is one array of the reference
held as its slices: the reference stacks each pattern position's weights
over the repeat groups (``blocks/pos{i}``, shape (G, ...)) where the port
keeps one module a layer, so the optimizer, the compressor and a checkpoint
see the port's per-layer tensors as the reference's stacked leaf.  Leaves
come in the reference's order: dict keys sorted, as JAX flattens them.

On a mesh every tensor is this rank's block of the reference's array
(``models.convert.shard_params``), so a ``Stacked`` group is a group of
blocks and the optimizer updates its slices in place as on one device.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.axes import storage_spec


def spec(leaf) -> tuple:
    """The storage spec of a leaf in the reference's shape on a mesh (a
    ``Stacked`` group's with its whole leading axis): the tensors carry
    their own (``distributed.axes.storage_spec``)."""
    if isinstance(leaf, Stacked):
        return (None,) + tuple(storage_spec(leaf[0]))
    return tuple(storage_spec(leaf))


class Stacked(tuple):
    """Tensors of one shape that the reference holds as one array stacked
    on a new leading axis, in the order of that axis."""

    @property
    def shape(self) -> tuple:
        return (len(self),) + tuple(self[0].shape)


def leaves(tree) -> list:
    """The leaves (tensors, ``Stacked`` groups, other values) in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def rebuild(tree, values):
    """``tree``'s structure with its leaves replaced, in order, by
    ``values``; every container comes back a plain dict or list."""
    return _rebuild(tree, iter(values))


def _rebuild(tree, it):
    # a module-level recursion: a nested recursive function would be a
    # reference cycle holding ``values`` (a step's gradients) until the
    # garbage collector runs
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def tensors(tree) -> list[torch.Tensor]:
    """Every tensor of the tree, a ``Stacked`` group's in its order."""
    out = []
    for leaf in leaves(tree):
        out.extend(leaf if isinstance(leaf, Stacked) else [leaf])
    return out


def regroup(tree, flat: list) -> object:
    """``tree``'s structure over ``flat`` (one tensor per tensor of
    ``tree``, in :func:`tensors`' order), its ``Stacked`` groups kept."""
    it = iter(flat)
    return rebuild(tree, [Stacked(next(it) for _ in leaf) if isinstance(leaf, Stacked)
                          else next(it) for leaf in leaves(tree)])


def stacked_zeros(leaf, dtype=torch.float32) -> torch.Tensor:
    """Zeros of the reference's shape of ``leaf`` (a ``Stacked`` group's
    stacked shape), on its device."""
    first = leaf[0] if isinstance(leaf, Stacked) else leaf
    return torch.zeros(tuple(leaf.shape), dtype=dtype, device=first.device)


def stack(leaf, dtype=None) -> torch.Tensor:
    """A leaf as one tensor of the reference's shape (a ``Stacked`` group
    stacked on a new axis 0), cast to ``dtype`` when given."""
    if isinstance(leaf, Stacked):
        return torch.stack([t if dtype is None else t.to(dtype) for t in leaf])
    return leaf if dtype is None else leaf.to(dtype)


def parts(leaf, x) -> list:
    """``x``, a leaf of another tree over ``leaf`` (a ``Stacked`` group, or
    one array of the reference's shape), cut into one part a tensor of
    ``leaf``: the slices of a stacked array are views."""
    if not isinstance(leaf, Stacked):
        return [x]
    return list(x) if isinstance(x, Stacked) else list(x.unbind(0))


def like(leaf, x):
    """``x``, one array of ``leaf``'s reference shape, as a leaf of
    ``leaf``'s kind: a ``Stacked`` group of its slices for a group."""
    return Stacked(x.unbind(0)) if isinstance(leaf, Stacked) else x
