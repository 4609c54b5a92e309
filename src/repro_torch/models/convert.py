"""Carry weights and decode caches between the JAX package's trees and the
port's modules.

The reference keeps a decoder's weights as ``blocks/pos{i}/...`` leaves of
shape (G, ...), one slice per repeat group g, and whisper's as
``enc_blocks/...`` and ``dec_blocks/...`` stacked over layers.  The port
holds one block a layer (layer ``g * period + i`` is ``pos{i}[g]``).
Trees arrive as nested dicts of numpy arrays; bfloat16 comes as an
``ml_dtypes`` array or as its ``uint16`` bit view.  Nothing here imports
JAX: a caller hands over ``jax.device_get(tree)``.

Training works on the reference's layout directly: :func:`param_tree` views
the port's weights as the reference's tree (each stacked leaf a
``training.tree.Stacked`` group of the per-layer parameters), so the
optimizer's moments and the error feedback are arrays of the reference's
shapes, and :func:`train_state_tree` / :func:`load_train_state` carry a
whole ``TrainState`` in the keys of the reference's checkpoint
(``.params/...``, ``.opt_state/...``, ``.step``, ``.error_fb/...`` when
set) both ways.

On a mesh of ranks the weights are cut to each rank's block of the
sharding rules' layout (:func:`shard_params`; :func:`from_jax_params` with
``mesh=`` carries the reference's arrays in so), the train layout or, with
``mode="serve"``, the serve layout; a sharded state is gathered a leaf at
a time for a checkpoint (:func:`gather_train_state`); the layout on disk
is the global one either way.  A decode cache is cut to the rules' cache
layout by :func:`shard_cache` (and put back together by
:func:`gather_cache`); :func:`cache_tree` gives its global shapes in the
reference's layout, the tree the rules read.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.ft.checkpoint import _bfloat16
from repro_torch.models.common import ModelConfig, Params
from repro_torch.models.transformer import layer_specs
from repro_torch.training.tree import Stacked, leaves, parts, rebuild


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint16 or a.dtype.name == "bfloat16":
        return _bfloat16(np.array(a.view(np.uint16)), device)
    return torch.from_numpy(np.array(a)).to(device)


def _module(tree: dict, device, index=None) -> Params:
    """A nested dict as ``Params``; ``index`` slices every leaf's axis 0."""
    return Params(**{k: _module(v, device, index) if isinstance(v, dict)
                     else _tensor(v if index is None else np.asarray(v)[index], device)
                     for k, v in tree.items()})


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view of the tensor: a cache is written in place)."""
    t = t.detach().cpu().clone()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(np.uint16).view(ml_dtypes.bfloat16)
    return t.numpy()


def _tree(module) -> dict:
    """A ``Params`` back as a nested dict of numpy arrays."""
    out = {k: _numpy(p) for k, p in module.named_parameters(recurse=False)}
    out.update({k: _tree(m) for k, m in module.named_children()})
    return out


def _stack(trees: list[dict]) -> dict:
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else np.stack([t[k] for t in trees]) for k in trees[0]}


def from_jax_params(cfg: ModelConfig, tree: dict, device="cuda", mesh=None) -> Params:
    """The reference's parameter tree as the port's weights on ``device``;
    on ``mesh`` (a live ``launch.mesh.Mesh``) this rank's blocks
    (:func:`shard_params`), cut on the host."""
    dev = resolve_device(device)
    if mesh is not None:
        return shard_params(cfg, from_jax_params(cfg, tree, "cpu"), mesh).to(dev)
    items = {k: _tensor(v, dev) for k, v in tree.items() if not isinstance(v, dict)}
    if cfg.is_encdec:
        items.update(enc_blocks=[_module(tree["enc_blocks"], dev, i)
                                 for i in range(cfg.encoder_layers)],
                     dec_blocks=[_module(tree["dec_blocks"], dev, i)
                                 for i in range(cfg.n_layers)])
    else:
        items["blocks"] = [_module(tree["blocks"][f"pos{l % cfg.period}"], dev, l // cfg.period)
                           for l in range(len(layer_specs(cfg)))]
    return Params(**items)


def params_to_numpy(cfg: ModelConfig, params: Params) -> dict:
    """The port's weights in the reference's tree layout (numpy)."""
    tree = _tree(params)
    if cfg.is_encdec:
        for k in ("enc_blocks", "dec_blocks"):
            tree[k] = _stack([tree[k][str(i)] for i in range(len(tree[k]))])
        return tree
    blocks = tree["blocks"]
    tree["blocks"] = {f"pos{i}": _stack([blocks[str(g * cfg.period + i)]
                                          for g in range(cfg.n_groups)])
                      for i in range(cfg.period)}
    return tree


def cache_from_jax(cfg: ModelConfig, cache: dict, device="cuda") -> dict:
    """The reference's decode cache as the port's (``pos`` a host integer)."""
    dev = resolve_device(device)
    out = dict(pos=int(np.asarray(cache["pos"])))
    if cfg.is_encdec:
        out.update({k: _tensor(cache[k], dev)
                    for k in ("self_k", "self_v", "cross_k", "cross_v")})
        return out
    out["layers"] = [{k: _tensor(np.asarray(v)[l // cfg.period], dev) for k, v in
                      cache["blocks"][f"pos{l % cfg.period}"].items()}
                     for l in range(len(layer_specs(cfg)))]
    return out


def cache_to_numpy(cfg: ModelConfig, cache: dict) -> dict:
    """The port's decode cache in the reference's layout (numpy)."""
    out = dict(pos=np.int32(cache["pos"]))
    if cfg.is_encdec:
        out.update({k: _numpy(cache[k]) for k in ("self_k", "self_v", "cross_k", "cross_v")})
        return out
    layers = cache["layers"]
    out["blocks"] = {f"pos{i}": {k: np.stack([_numpy(layers[g * cfg.period + i][k])
                                              for g in range(cfg.n_groups)])
                                 for k in layers[i]}
                     for i in range(cfg.period)}
    return out


@torch.no_grad()
def shard_params(cfg: ModelConfig, params: Params, mesh, abstract: Params | None = None,
                 mode: str = "train") -> Params:
    """Cut every weight of ``params`` (the global arrays) to this rank's
    block of the rules' ``mode`` layout on ``mesh`` (train: FSDP over the
    data axes and TP/EP over ``model``; serve: TP/EP only, experts over the
    data axes), in place, a leaf at a time: each parameter keeps its
    object and holds its block, with its spec in ``mesh_spec`` (a
    ``Stacked`` group's tensors the spec without the group axis, which the
    rules never split).  With ``abstract`` (the model's
    ``abstract_params()``: the global shapes) a weight that is already its
    block is left as it is.  Returns ``params``."""
    tree = param_tree(cfg, params)
    shapes = tree if abstract is None else param_tree(cfg, abstract)
    for leaf, full, spec in zip(leaves(tree), leaves(shapes),
                                leaves(sh.param_specs(shapes, mesh, mode))):
        if isinstance(leaf, Stacked):
            if spec[0] is not None:
                raise ValueError(f"the rules split a stacked group axis: {spec}")
            spec = spec[1:]
        ts, fs = ((leaf, full) if isinstance(leaf, Stacked) else ((leaf,), (full,)))
        for t, f in zip(ts, fs):
            if t.shape == f.shape:
                t.data = sh.shard(t.data, spec, mesh).clone()
            t.mesh_spec = tuple(spec)
    return params


@torch.no_grad()
def init_sharded(api, generator, mesh, mode: str = "train") -> Params:
    """``shard_params(cfg, api.init(generator), mesh, mode=mode)``, drawn a
    weight at a time: each draw of ``uinit`` is cut to this rank's block as it is made
    and the global draw freed before the next, so a rank holds its blocks
    and at most one global weight (the generator draws every weight in
    full, so the values are the one-process ones).  Works on anything with
    ``axis_names``, a shape and a ``rank`` as ``mesh``."""
    from repro_torch.models.common import each_draw

    cfg = api.cfg
    drawn = {}                          # storage of a meta draw -> its number

    def note(w):
        drawn[_storage(w)] = len(drawn)
        return w

    with each_draw(note):
        abstract = api.abstract_params()
    tree = param_tree(cfg, abstract)
    spec_of = {}                        # draw number -> the spec of its block
    for leaf, spec in zip(leaves(tree), leaves(sh.param_specs(tree, mesh, mode))):
        if isinstance(leaf, Stacked):
            spec = spec[1:]
        for t in (leaf if isinstance(leaf, Stacked) else (leaf,)):
            if _storage(t) in drawn:
                spec_of[drawn[_storage(t)]] = tuple(spec)
    count = iter(range(len(drawn)))

    def cut(w):
        spec = spec_of.get(next(count))
        return w if spec is None else sh.shard(w, spec, mesh).clone()

    with each_draw(cut):
        params = api.init(generator)
    return shard_params(cfg, params, mesh, abstract, mode)


def cache_tree(cfg: ModelConfig, cache: dict) -> dict:
    """The global shapes of a port decode cache (tensors, or their shapes
    on the meta device) as the reference's cache tree on the meta device:
    a decoder's layers stacked over the groups (``blocks/pos{i}/k`` (G, B,
    S, K, dh), ...), whisper's as they are; ``pos`` an int32 scalar.  The
    tree ``sharding.cache_specs`` reads."""
    meta = lambda shape, dtype: torch.empty(tuple(shape), dtype=dtype, device="meta")
    out = dict(pos=meta((), torch.int32))
    if cfg.is_encdec:
        out.update({k: meta(cache[k].shape, cache[k].dtype)
                    for k in ("self_k", "self_v", "cross_k", "cross_v")})
        return out
    layers = cache["layers"]
    out["blocks"] = {f"pos{i}": {k: meta((cfg.n_groups, *t.shape), t.dtype)
                                 for k, t in layers[i].items()}
                     for i in range(cfg.period)}
    return out


def _cache_items(cfg: ModelConfig, cache: dict, specs: dict):
    """(container, key, tensor, its spec) of each array of a port decode
    cache, under the reference tree's specs (a layer's spec without the
    group axis)."""
    if cfg.is_encdec:
        for k in ("self_k", "self_v", "cross_k", "cross_v"):
            yield cache, k, cache[k], specs[k]
        return
    for l, layer in enumerate(cache["layers"]):
        for k, t in layer.items():
            spec = specs["blocks"][f"pos{l % cfg.period}"][k]
            if spec[0] is not None:
                raise ValueError(f"the rules split a cache's group axis: {spec}")
            yield layer, k, t, spec[1:]


def live_cache_specs(cfg: ModelConfig, cache: dict, mesh) -> dict:
    """The specs of a live cache's arrays, in :func:`cache_tree`'s keys:
    the rules' ``cache_specs``, except that whisper's self-attention window
    lies as a decoder's K/V does (batch over the data axes, sequence over
    ``model``).  The rules match K/V by the paths ``/k``, ``/v`` and
    ``cross``, which ``self_k`` and ``self_v`` are not, so they hold the
    self window whole on every rank, rows included, while a rank of the
    live mesh computes only its rows (the dry run's ``analytic_memory``
    keeps the rules' count)."""
    tree = cache_tree(cfg, cache)
    if not cfg.is_encdec:
        return sh.cache_specs(tree, mesh)
    tree["self"] = {"k": tree.pop("self_k"), "v": tree.pop("self_v")}
    specs = sh.cache_specs(tree, mesh)
    self_specs = specs.pop("self")
    specs.update(self_k=self_specs["k"], self_v=self_specs["v"])
    return specs


@torch.no_grad()
def shard_cache(cfg: ModelConfig, cache: dict, mesh, device=None) -> dict:
    """A decode cache (the global arrays; ``pos`` a host integer) as this
    rank's blocks of the rules' cache layout on ``mesh``
    (:func:`live_cache_specs`: K/V batch over the data axes and sequence
    over ``model``, SSM states heads over ``model``, the conv tail channels
    over ``model``; a dimension stays whole where its axis does not divide
    it), each block with its spec in ``mesh_spec``, on ``device`` (default
    the array's).  A cache on the meta device gives zeroed blocks
    allocated at their own size (on the meta device when ``device`` is
    too): the global cache is never made.  Returns a new cache dict."""
    specs = live_cache_specs(cfg, cache, mesh)
    out = dict(cache)
    if not cfg.is_encdec:
        out["layers"] = [dict(layer) for layer in cache["layers"]]
    for holder, k, t, spec in _cache_items(cfg, out, specs):
        dev = torch.device(device) if device is not None else t.device
        if t.device.type == "meta":
            block = torch.zeros(tuple(sh.shard(t, spec, mesh).shape), dtype=t.dtype,
                                device=dev)
        else:
            block = sh.shard(t, spec, mesh).to(dev).clone()
        block.mesh_spec = tuple(spec)
        holder[k] = block
    return out


@torch.no_grad()
def gather_cache(cfg: ModelConfig, cache: dict, mesh) -> dict:
    """A cache of :func:`shard_cache`'s blocks on a live mesh put back
    together (every rank gets the global arrays)."""
    out = dict(cache)
    if not cfg.is_encdec:
        out["layers"] = [dict(layer) for layer in cache["layers"]]
    for holder, k, t, spec in _cache_items(cfg, out, _spec_tree(cfg, out)):
        holder[k] = sh.gather(t, spec, mesh)
    return out


def _spec_tree(cfg: ModelConfig, cache: dict) -> dict:
    """The specs a sharded cache's blocks carry, in the reference tree's
    keys (each layer's with the group axis put back)."""
    if cfg.is_encdec:
        return {k: cache[k].mesh_spec for k in ("self_k", "self_v", "cross_k", "cross_v")}
    return {"blocks": {f"pos{i}": {k: (None, *t.mesh_spec)
                                   for k, t in cache["layers"][i].items()}
                       for i in range(cfg.period)}}


def _storage(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage (a parameter shares its tensor's,
    on the meta device too)."""
    return t.untyped_storage()._cdata


class ParamTree(dict):
    """The port's weights in the reference's tree layout: a dict whose leaves
    are the module's own parameters, a stacked leaf of the reference a
    ``Stacked`` group of per-layer parameters; ``module`` is the ``Params``
    the model's functions take."""

    def __init__(self, items: dict, module: Params):
        super().__init__(items)
        self.module = module


def _param_dict(module) -> dict:
    out = dict(module.named_parameters(recurse=False))
    out.update({k: _param_dict(m) for k, m in module.named_children()})
    return out


def _group(trees: list[dict]) -> dict:
    return {k: _group([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else Stacked(t[k] for t in trees) for k in trees[0]}


def param_tree(cfg: ModelConfig, params: Params) -> ParamTree:
    """``params`` as the reference's parameter tree, over the same tensors."""
    tree = dict(params.named_parameters(recurse=False))
    if cfg.is_encdec:
        for k in ("enc_blocks", "dec_blocks"):
            tree[k] = _group([_param_dict(b) for b in getattr(params, k)])
    else:
        tree["blocks"] = {f"pos{i}": _group([_param_dict(params.blocks[g * cfg.period + i])
                                             for g in range(cfg.n_groups)])
                          for i in range(cfg.period)}
    return ParamTree(tree, params)


def _host(tree, abstract: bool):
    """A tree's leaves as host tensors of the reference's shapes (a
    ``Stacked`` group stacked), or shapes only on the meta device."""
    def one(leaf):
        if abstract:
            return torch.empty(tuple(leaf.shape), dtype=_dtype(leaf), device="meta")
        if isinstance(leaf, Stacked):
            return torch.stack([t.detach().cpu() for t in leaf])
        return leaf.detach().cpu().clone()
    return rebuild(tree, [one(leaf) for leaf in leaves(tree)])


def _dtype(leaf):
    return (leaf[0] if isinstance(leaf, Stacked) else leaf).dtype


def train_state_tree(state, abstract: bool = False) -> dict:
    """A ``training.TrainState`` in the keys the reference's checkpoint gives
    its ``TrainState``, as host tensors (``repro_torch.ft.checkpoint.save``
    writes them, bfloat16 included), or, with ``abstract``, as shapes on the
    meta device (the structure ``checkpoint.restore`` takes)."""
    out = {".params": _host(state.params, abstract),
           ".opt_state": _host(state.opt_state, abstract),
           ".step": _host(state.step, abstract)}
    if state.error_fb is not None:
        out[".error_fb"] = _host(state.error_fb, abstract)
    return out


def abstract_param_tree(cfg: ModelConfig, abstract_params: Params) -> dict:
    """The reference's parameter tree of ``abstract_params`` as tensors of
    its shapes on the meta device (a ``Stacked`` group stacked)."""
    return _host(param_tree(cfg, abstract_params), True)


def abstract_train_state(cfg: ModelConfig, abstract_params: Params, opt_cfg,
                         compress: bool = False) -> dict:
    """The global shapes (on the meta device) of a ``TrainState`` of the
    model, in :func:`train_state_tree`'s keys: what the sharding rules and
    a checkpoint's restore read, with no array allocated."""
    from repro_torch.training import GradCompressor, optim

    tree = param_tree(cfg, abstract_params)
    out = {".params": abstract_param_tree(cfg, abstract_params),
           ".opt_state": _host(optim.init_opt_state(tree, opt_cfg), True),
           ".step": torch.empty((), dtype=torch.int32, device="meta")}
    if compress:
        out[".error_fb"] = _host(GradCompressor().init_error(tree), True)
    return out


@torch.no_grad()
def gather_train_state(state, specs: dict, mesh, writer: int = 0):
    """A ``TrainState`` sharded on ``mesh`` as :func:`train_state_tree`'s
    host tensors of the global arrays, on rank ``writer`` (None on the
    others).  A leaf at a time: each is gathered (a ``Stacked`` group's
    blocks stacked first), copied to the writer's host and dropped, so no
    rank holds more than one global leaf on its device."""
    live = {".params": state.params, ".opt_state": state.opt_state, ".step": state.step}
    if state.error_fb is not None:
        live[".error_fb"] = state.error_fb
    out = []
    for leaf, spec in zip(leaves(live), leaves({k: specs[k] for k in live})):
        x = torch.stack(list(leaf)) if isinstance(leaf, Stacked) else leaf
        x = sh.gather(x.detach(), spec, mesh)
        out.append(x.cpu().clone() if mesh.rank == writer else None)
        del x
    return rebuild(live, out) if mesh.rank == writer else None


@torch.no_grad()
def load_train_state(state, tree: dict):
    """Copy a checkpoint's tree (the keys of :func:`train_state_tree`, numpy
    arrays or tensors) into ``state``'s tensors, in place; returns
    ``state``."""
    live = {".params": state.params, ".opt_state": state.opt_state, ".step": state.step}
    if state.error_fb is not None:
        live[".error_fb"] = state.error_fb
    if sorted(live) != sorted(tree):
        raise ValueError(f"train state keys {sorted(tree)} != {sorted(live)}")
    dst, src = leaves(live), leaves(tree)
    if len(dst) != len(src):
        raise ValueError(f"{len(src)} arrays for a train state of {len(dst)}")
    for leaf, x in zip(dst, src):
        x = x if isinstance(x, torch.Tensor) else _tensor(x, "cpu")
        if tuple(x.shape) != tuple(leaf.shape):
            raise ValueError(f"shape {tuple(x.shape)} for a leaf of {tuple(leaf.shape)}")
        for t, part in zip(parts(leaf, leaf), parts(leaf, x)):
            t.copy_(part)
    return state
