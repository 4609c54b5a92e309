"""Uniform model API over the decoder-only and enc-dec families.

The JAX package's ``models/registry.py`` on the port.  ``ModelAPI`` bundles
what the launchers and tests need, on one device:
    init(generator) / abstract_params()      weights from a torch.Generator
    loss(params, batch)                      -> (scalar, metrics)
    prefill(params, batch, kv_len)           -> (logits_last, cache)
    decode(params, cache, tokens)            -> (logits, cache)
    init_cache(batch, kv_len)
    param_tree(params) / tree_loss(tree, batch)   the training functions' view

Prefill and decode run without autograd.  The decoder's prefill computes the
cache and the last position's logits in one pass over the prompt, where the
reference runs the backbone twice (``lm_forward``, then
``tr_prefill_cache``); the final norm is per position, so slicing to the
last position before the head gives the reference's numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.models import convert
from repro_torch.models import transformer as tr
from repro_torch.models import whisper as wh
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    init: Callable
    loss: Callable
    init_cache: Callable
    decode: Callable
    prefill: Callable
    abstract_params: Callable

    def abstract_cache(self, batch: int, kv_len: int):
        return self.init_cache(batch, kv_len, device="meta")

    def generator(self, seed: int = 0) -> torch.Generator:
        """A generator on this API's device, seeded."""
        return _gen(self.device, seed)

    def param_tree(self, params) -> convert.ParamTree:
        """``params`` in the reference's tree layout, the tree the training
        functions take (``convert.param_tree``)."""
        return convert.param_tree(self.cfg, params)

    def tree_loss(self, tree: convert.ParamTree, batch):
        """``loss`` over a :meth:`param_tree`'s module: the train step's
        loss function."""
        return self.loss(tree.module, batch)


def tr_prefill_cache(params, batch, cache, cfg: ModelConfig):
    """Populate a decode cache from a prompt in one forward pass."""
    return tr.prefill_pass(params, batch, cache, cfg)[1]


def _decoder_api(cfg: ModelConfig, dev: torch.device) -> ModelAPI:
    @torch.no_grad()
    def prefill(params, batch, kv_len):
        """Last-position logits and a cache covering the prompt."""
        b = batch["tokens"].shape[0]
        cache = tr.init_cache(cfg, b, kv_len, device=params.embed.device)
        x, cache = tr.prefill_pass(params, batch, cache, cfg)
        return x[:, -1] @ tr.lm_head(params, cfg), cache

    return ModelAPI(
        cfg=cfg, device=dev,
        init=lambda generator=None: tr.init_params(generator or _gen(dev), cfg),
        loss=lambda params, batch: tr.lm_loss(params, batch, cfg),
        init_cache=lambda b, s, device=dev: tr.init_cache(cfg, b, s, device=device),
        decode=torch.no_grad()(lambda params, cache, tokens:
                               tr.decode_step(params, cache, tokens, cfg)),
        prefill=prefill,
        abstract_params=lambda: tr.abstract_params(cfg),
    )


def _encdec_api(cfg: ModelConfig, dev: torch.device) -> ModelAPI:
    @torch.no_grad()
    def prefill(params, batch, kv_len):
        """Cross K/V from the frames, then one decode step of token 0; the
        reference ignores ``kv_len`` (the self window is the config's)."""
        frames = batch["frames"]
        cache = wh.init_encdec_cache(params, cfg, frames.shape[0], frames.shape[1])
        cache = wh.prefill_cross(params, frames, cache, cfg)
        tokens = torch.zeros((frames.shape[0],), dtype=torch.long, device=frames.device)
        return wh.encdec_decode_step(params, cache, tokens, cfg)

    return ModelAPI(
        cfg=cfg, device=dev,
        init=lambda generator=None: wh.init_whisper(generator or _gen(dev), cfg),
        loss=lambda params, batch: wh.encdec_loss(params, batch, cfg),
        init_cache=lambda b, s, device=dev: wh.init_encdec_cache(None, cfg, b, s,
                                                                  device=device),
        decode=torch.no_grad()(lambda params, cache, tokens:
                               wh.encdec_decode_step(params, cache, tokens, cfg)),
        prefill=prefill,
        abstract_params=lambda: wh.abstract_whisper(cfg),
    )


def _gen(dev: torch.device, seed: int = 0) -> torch.Generator:
    return torch.Generator(dev).manual_seed(seed)


def get_model(cfg: ModelConfig, device="cuda") -> ModelAPI:
    """The model API on ``device`` (default ``cuda``, which raises without a
    card)."""
    dev = resolve_device(device)
    return _encdec_api(cfg, dev) if cfg.is_encdec else _decoder_api(cfg, dev)
