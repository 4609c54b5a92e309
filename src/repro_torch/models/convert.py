"""Carry weights and decode caches between the JAX package's trees and the
port's modules.

The reference keeps a decoder's weights as ``blocks/pos{i}/...`` leaves of
shape (G, ...), one slice per repeat group g, and whisper's as
``enc_blocks/...`` and ``dec_blocks/...`` stacked over layers.  The port
holds one block a layer (layer ``g * period + i`` is ``pos{i}[g]``).
Trees arrive as nested dicts of numpy arrays; bfloat16 comes as an
``ml_dtypes`` array or as its ``uint16`` bit view.  Nothing here imports
JAX: a caller hands over ``jax.device_get(tree)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ft.checkpoint import _bfloat16
from repro_torch.models.common import ModelConfig, Params
from repro_torch.models.transformer import layer_specs


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


def from_jax_params(cfg: ModelConfig, tree: dict, device="cuda") -> Params:
    """The reference's parameter tree as the port's weights on ``device``."""
    dev = resolve_device(device)
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
