"""Elastic scaling: place a state on a different mesh.

The JAX package's ``ft/elastic.py`` on the port.  Checkpoints and the
trees ``models.convert.gather_train_state`` gives carry the global
arrays, so scaling in or out is placing each leaf by the new mesh's rules:
every rank keeps its block, a leaf at a time, and only the block goes to
the device.  The trainer does this when the world size changes between
restarts (``ft.checkpoint.restore(..., mesh=)``).
"""
from __future__ import annotations

from repro_torch.distributed import sharding as sh


def _zip(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def reshard(tree, new_mesh, spec_fn=None):
    """``tree`` (nested dicts of global arrays: tensors or numpy) as this
    rank's blocks on ``new_mesh`` (a live ``launch.mesh.Mesh``), on its
    device.  ``spec_fn(tree, mesh) -> specs``; defaults to the parameter
    rules."""
    specs = (spec_fn or sh.param_specs)(tree, new_mesh)
    return _zip(lambda x, s: sh.place(x, s, new_mesh), tree, specs)
