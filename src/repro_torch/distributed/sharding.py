"""Sharding rules: parameter, optimizer, cache and batch specs for any mesh.

The JAX package's ``distributed/sharding.py`` on the port.  Baseline scheme:
  * TP (Megatron): head/ffn/expert contraction dims over ``model``
  * FSDP (ZeRO-3): the other big dim over the data axes (pod+data flattened)
  * EP: experts over ``model``
  * decode KV caches: sequence axis over ``model``
  * batch over the data axes

A spec is a tuple with one entry a dimension, the reference's
``PartitionSpec`` entries: ``None`` (whole), an axis name, or a tuple of
axis names (the data axes of a three-axis mesh, flattened pod major).  The
rules are path-keyed over the reference's trees (``models/convert.py``'s
``param_tree`` and ``train_state_tree``), whose leaves are anything with a
``shape`` (tensors, ``training.tree.Stacked`` groups, tensors on the meta
device), and read of the mesh only ``axis_names`` and its shape
(``devices.shape`` or ``shape``), so the 256- and 512-way production shapes
need no ranks.  A dimension stays whole when the axis does not divide it.

:func:`shard` cuts a rank's block of a global array (where the reference
builds ``NamedSharding``; :func:`place` copies the block to the device)
and :func:`gather` puts the blocks of a live mesh back together.  The live
layout of the port's training state is built from these in
``models/convert.py``.
"""
from __future__ import annotations

import math


def _sizes(mesh) -> dict:
    shape = mesh.devices.shape if hasattr(mesh, "devices") else tuple(mesh.shape)
    return dict(zip(mesh.axis_names, shape))


def mesh_axes(mesh):
    """(the data axes: one name, a tuple of names or None; the model axis)."""
    names = tuple(mesh.axis_names)
    model = "model" if "model" in names else names[-1]
    dp = tuple(n for n in names if n != model)
    return (dp if len(dp) > 1 else (dp[0] if dp else None)), model


def entry_names(entry) -> tuple:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def axis_size(mesh, entry) -> int:
    sizes = _sizes(mesh)
    return math.prod(sizes[a] for a in entry_names(entry))


def _divisible(shape, axis, mesh, axis_name) -> bool:
    if axis_name is None:
        return False
    return shape[axis] % axis_size(mesh, axis_name) == 0


def _ndim(x) -> int:
    return len(tuple(x.shape))


def _spec_for_param(path: str, x, dp, model, mesh, mode: str) -> tuple:
    shape = tuple(x.shape)
    r = len(shape)

    def ok(axis, name):
        return _divisible(shape, axis, mesh, name)

    serve = mode == "serve"
    if "embed" in path:
        return (model if ok(0, model) else None,
                None if serve else (dp if ok(1, dp) else None))
    if path.endswith("head"):
        return (None if serve else (dp if ok(0, dp) else None),
                model if ok(1, model) else None)
    if r <= 2 and ("norm" in path or "bias" in path.lower() or
                   path.endswith(("a_log", "d_skip", "dt_bias", "bq", "bk", "bv", "conv_b"))):
        return (None,) * r
    if "moe" in path and r == 4:                 # (G, E, D, F) / (G, E, F, D)
        if serve:
            big = 2 if shape[2] >= shape[3] else 3
            spec = [None, dp if ok(1, dp) else None, None, None]
            spec[big] = model if ok(big, model) else None
            return tuple(spec)
        return (None, model if ok(1, model) else None, dp if ok(2, dp) else None, None)
    if "router" in path:                         # (G, D, E)
        return (None, None if serve else (dp if ok(1, dp) else None), None)
    if "conv_w" in path:                         # (G, k, P)
        return (None, None, model if ok(2, model) else None)
    if r == 3:                                   # (G, in, out) block matmuls
        _, din, dout = shape
        if din >= dout:
            return (None, None if serve else (dp if ok(1, dp) else None),
                    model if ok(2, model) else None)
        return (None, model if ok(1, model) else None,
                None if serve else (dp if ok(2, dp) else None))
    if r == 2:                                   # unstacked matmul
        return (None if serve else (dp if ok(0, dp) else None),
                model if ok(1, model) else None)
    return (None,) * r


def _map(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of nested dicts (and lists)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    return fn("/".join(path), tree)


def param_specs(abstract_params, mesh, mode: str = "train"):
    """mode="train": FSDP(dp)+TP(model) storage.  mode="serve": TP/EP-only
    storage (the use layout)."""
    dp, model = mesh_axes(mesh)
    return _map(lambda path, x: _spec_for_param(path, x, dp, model, mesh, mode),
                abstract_params)


def _get_by_path(tree, path: str):
    cur = tree
    for part in path.split("/"):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            return None
    return cur if isinstance(cur, tuple) else None


def opt_specs(abstract_opt, pspecs, mesh):
    """Optimizer state mirrors the parameters' specs; a factored moment
    drops an axis (``vr`` the last, ``vc`` the one before it)."""
    def spec(path, x):
        if path.endswith("step"):
            return ()
        parts = path.split("/")
        tail = parts[-1]
        core = "/".join(parts[1:-1] if tail in ("vr", "vc", "v") else parts[1:])
        ref = _get_by_path(pspecs, core)
        if ref is None:
            return (None,) * _ndim(x)
        if tail == "vr":
            return ref[:-1]
        if tail == "vc":
            return ref[:-2] + ref[-1:]
        return ref

    return _map(spec, abstract_opt)


def cache_specs(abstract_cache, mesh):
    """The reference's decode-cache layout: K/V (G, B, S, K, dh) batch over
    the data axes and sequence over ``model``; SSM states heads over
    ``model``."""
    dp, model = mesh_axes(mesh)

    def spec(path, x):
        shape, r = tuple(x.shape), _ndim(x)
        if path.endswith("pos"):
            return ()
        b_ok = r >= 2 and _divisible(shape, 1, mesh, dp)
        if r == 5 and ("/k" in path or "/v" in path or "cross" in path):
            s_ok = _divisible(shape, 2, mesh, model)
            return (None, dp if b_ok else None, model if s_ok else None, None, None)
        if r == 5 and "ssm" in path:
            h_ok = _divisible(shape, 2, mesh, model)
            return (None, dp if b_ok else None, model if h_ok else None, None, None)
        if r == 4 and "conv" in path:
            p_ok = _divisible(shape, 3, mesh, model)
            return (None, dp if b_ok else None, None, model if p_ok else None)
        return (None,) * r

    return _map(spec, abstract_cache)


def batch_specs(abstract_batch, mesh):
    dp, _ = mesh_axes(mesh)

    def spec(path, x):
        r = _ndim(x)
        if r == 0:
            return ()
        if _divisible(tuple(x.shape), 0, mesh, dp):
            return (dp,) + (None,) * (r - 1)
        return (None,) * r

    return _map(spec, abstract_batch)


def state_specs(abstract_state: dict, mesh) -> dict:
    """Specs of a ``TrainState`` in ``train_state_tree``'s keys
    (``.params``, ``.opt_state``, ``.step``, ``.error_fb``): the error
    feedback lies as the parameters."""
    pspecs = param_specs(abstract_state[".params"], mesh)
    out = {".params": pspecs, ".opt_state": opt_specs(abstract_state[".opt_state"], pspecs, mesh),
           ".step": ()}
    if ".error_fb" in abstract_state:
        out[".error_fb"] = pspecs
    return out


def spec_axes(spec) -> set:
    """Every axis name a spec shards over."""
    return {a for e in spec for a in entry_names(e)}


def coordinate(mesh, entry) -> int:
    """This rank's block index along the axes of one spec entry (row-major
    over them, as the mesh lays its ranks out)."""
    sizes = _sizes(mesh)
    coords, r = {}, mesh.rank
    for a in reversed(tuple(mesh.axis_names)):
        r, coords[a] = divmod(r, sizes[a])
    idx = 0
    for a in entry_names(entry):
        idx = idx * sizes[a] + coords[a]
    return idx


def shard(x, spec, mesh):
    """This rank's block of ``x`` (a global array: tensor or numpy) under
    ``spec``: a view."""
    idx = []
    for n, e in zip(x.shape, spec):
        k = axis_size(mesh, e)
        if n % k:
            raise ValueError(f"dimension {n} does not split {k} ways ({spec})")
        b = coordinate(mesh, e) if k > 1 else 0
        idx.append(slice(b * (n // k), (b + 1) * (n // k)))
    return x[tuple(idx)]


def flat(tree, prefix=()) -> dict:
    """``{"a/b": leaf}`` of a tree of nested dicts (a spec tree, or a tree
    of arrays), keys sorted: the keys of a checkpoint."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], prefix + (str(k),)))
        return out
    return {"/".join(prefix): tree}


def place(x, spec, mesh, device=None):
    """This rank's block of ``x`` (a global array: tensor or numpy) under
    ``spec``, as its own tensor on ``device`` (the mesh's by default): only
    the block is copied to the device."""
    import numpy as np
    import torch

    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    block = shard(x, spec, mesh) if len(spec) else x
    return block.to(device if device is not None else mesh.device).contiguous().clone()


def gather(x, spec, mesh):
    """The global array of which ``x`` is this rank's block under ``spec``
    on a live mesh: gathered along each split dimension over its axes'
    group (every rank gets it)."""
    from repro_torch.distributed import collectives as coll

    for d, e in enumerate(spec):
        if e is not None and axis_size(mesh, e) > 1:
            x = coll.all_gather(x, d, mesh.group(entry_names(e)))
    return x


def sharded_bytes(abstract_tree, specs, mesh) -> int:
    """Bytes a rank holds of a tree under its specs (exact; the reference
    dry run's count)."""
    sp = flat(specs)
    return sum(math.prod(tuple(x.shape)) * x.element_size()
               // math.prod(axis_size(mesh, e) for e in sp[k])
               for k, x in flat(abstract_tree).items())
