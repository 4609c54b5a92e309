"""Encoder-decoder transformer (whisper-base backbone).

The JAX package's ``models/whisper.py`` on torch tensors.  The conv/mel
frontend is a STUB: ``input_specs()`` provides precomputed frame embeddings
(B, S_enc, D).  The decoder is causal with cross-attention to the encoder
memory.

``decode_*`` shapes put seq_len on the *cross-attention* KV (the encoder
memory — whisper's long axis), with the self-attention cache capped at
``decoder_self_window`` (448, whisper's max target positions).  The cache is
a dict of per-layer stacked tensors (``self_k``/``self_v`` (L, B, W, K, dh),
``cross_k``/``cross_v`` (L, B, S_enc, K, dh)) and a host integer ``pos``;
a decode step writes the new token's self K/V in place and raises at ``pos
>= W``, where the reference clamps the write onto the last slot.

On a live mesh the cache holds this rank's blocks
(``models.convert.shard_cache``: rows over the data axes, the self window's
and the cross K/V's sequence over ``model`` where the axis divides it):
self- and cross-attention run over the rank's positions and merge the
partials over ``model``, as the decoder's attention does
(``transformer.cached_attention``).
"""
from __future__ import annotations

import torch

from repro_torch.distributed.axes import block_of, constrain, embed_lookup, linear
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import chunked_attention
from repro_torch.models.common import (ModelConfig, Params, cross_entropy, ones, remat,
                                       rms_norm, uinit)
from repro_torch.models.transformer import (attn_decode, attn_forward, cached_attention,
                                            check_room, fit, init_attn, init_dense_mlp,
                                            write_token)


def init_whisper(generator, cfg: ModelConfig, device=None):
    dtype = cfg.dtype
    dev = torch.device(device) if device is not None else generator.device
    d = cfg.d_model

    def enc_block():
        return Params(norm1=ones(d, dtype, dev), attn=init_attn(generator, cfg, dtype, dev),
                      norm2=ones(d, dtype, dev),
                      mlp=init_dense_mlp(generator, cfg, dtype, dev))

    def dec_block():
        return Params(norm1=ones(d, dtype, dev), attn=init_attn(generator, cfg, dtype, dev),
                      norm_x=ones(d, dtype, dev),
                      xattn=init_attn(generator, cfg, dtype, dev),
                      norm2=ones(d, dtype, dev),
                      mlp=init_dense_mlp(generator, cfg, dtype, dev))

    return Params(
        enc_blocks=[enc_block() for _ in range(cfg.encoder_layers)],
        dec_blocks=[dec_block() for _ in range(cfg.n_layers)],
        enc_norm=ones(d, dtype, dev),
        final_norm=ones(d, dtype, dev),
        embed=uinit(generator, (cfg.vocab, d), 0.02, dtype, dev),
        head=uinit(generator, (d, cfg.vocab), d**-0.5, dtype, dev),
    )


def abstract_whisper(cfg: ModelConfig):
    return init_whisper(None, cfg, device="meta")


def _mlp(x, p, cfg: ModelConfig):
    h = rms_norm(x, p.norm2, cfg.norm_eps)
    return x + moe_mod.swiglu(h, p.mlp.wi, p.mlp.wg, p.mlp.wo)


def _xattn(x, p, memory, cfg: ModelConfig):
    b, t, _ = x.shape
    h, k, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = linear(x, p.wq, None, None).reshape(b, t, h, dh)
    kx = linear(memory, p.wk, None, None).reshape(b, -1, k, dh)
    vx = linear(memory, p.wv, None, None).reshape(b, -1, k, dh)
    o = chunked_attention(q, kx, vx, causal=False)
    return linear(o.reshape(b, t, h * dh), p.wo, None, None)


def _enc_block(x, p, cfg: ModelConfig, positions):
    h = rms_norm(x, p.norm1, cfg.norm_eps)
    x = x + attn_forward(h, p.attn, cfg, positions, causal=False)
    return _mlp(x, p, cfg)


def _dec_block(x, p, memory, cfg: ModelConfig, positions):
    h = rms_norm(x, p.norm1, cfg.norm_eps)
    x = x + attn_forward(h, p.attn, cfg, positions, causal=True)
    h = rms_norm(x, p.norm_x, cfg.norm_eps)
    x = x + _xattn(h, p.xattn, memory, cfg)
    return _mlp(x, p, cfg)


def encode(params, frames, cfg: ModelConfig):
    """The encoder over the frames; each block recomputed in the backward
    pass under ``cfg.remat``."""
    positions = torch.arange(frames.shape[1], dtype=torch.int32, device=frames.device)[None]
    x = frames.to(cfg.dtype)
    for p in params.enc_blocks:
        x = remat(_enc_block, cfg, x, p, cfg, positions)
    return rms_norm(x, params.enc_norm, cfg.norm_eps)


def encdec_forward(params, frames, tokens, cfg: ModelConfig):
    memory = encode(params, frames, cfg)
    x = embed_lookup(params.embed, tokens)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None]
    for p in params.dec_blocks:
        x = remat(_dec_block, cfg, x, p, memory, cfg, positions)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return constrain(linear(x, params.head, None, "model"), "dp", None, "model")


def encdec_loss(params, batch, cfg: ModelConfig):
    logits = encdec_forward(params, batch["frames"], batch["tokens"], cfg)
    loss = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss, dict(loss=loss, aux=torch.zeros((), dtype=torch.float32,
                                                  device=logits.device))


# --------------------------- decode path ------------------------------------


def init_encdec_cache(params, cfg: ModelConfig, batch: int, enc_len: int, device=None):
    """Cross-KV computed once from the encoder memory + small self-KV window,
    on ``device`` (default: the device of ``params``)."""
    k, dh = cfg.n_kv_heads, cfg.head_dim
    n, w = cfg.n_layers, cfg.decoder_self_window
    dev = device if device is not None else params.embed.device
    z = lambda s: torch.zeros((n, batch, s, k, dh), dtype=cfg.dtype, device=dev)
    return dict(pos=0, self_k=z(w), self_v=z(w), cross_k=z(enc_len), cross_v=z(enc_len))


def prefill_cross(params, frames, cache, cfg: ModelConfig):
    """Fill the cross K/V of every decoder layer from the encoder memory
    (this rank's block of it on a live mesh)."""
    memory = encode(params, frames, cfg)
    b, s = memory.shape[:2]
    shape = (b, s, cfg.n_kv_heads, cfg.head_dim)
    for name, w in (("cross_k", "wk"), ("cross_v", "wv")):
        kv = torch.stack([linear(memory, getattr(p.xattn, w), None, None).reshape(shape)
                          for p in params.dec_blocks])
        cache[name].copy_(fit(kv, cache[name], 2))
    return cache


def encdec_decode_step(params, cache, tokens, cfg: ModelConfig):
    """tokens (B,) -> logits (B, V), and the cache (the same object, the self
    K/V written in place at ``pos``, ``pos`` advanced)."""
    x = embed_lookup(params.embed, tokens)[:, None]
    pos = cache["pos"]
    self_blk, cross_blk = block_of(cache["self_k"], 2), block_of(cache["cross_k"], 2)
    check_room(pos, cache["self_k"].shape[2] * self_blk[1], "encdec_decode_step")
    enc_len = cache["cross_k"].shape[2] * cross_blk[1]
    hh, kk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b = x.shape[0]
    for li, p in enumerate(params.dec_blocks):
        sks, svs = cache["self_k"][li], cache["self_v"][li]
        ck, cv = cache["cross_k"][li], cache["cross_v"][li]
        h = rms_norm(x, p.norm1, cfg.norm_eps)
        y, kx, vx = attn_decode(h, p.attn, sks, svs, pos, cfg, self_blk)
        write_token(sks, kx[:, 0], pos, self_blk)
        write_token(svs, vx[:, 0], pos, self_blk)
        x = x + y
        h = rms_norm(x, p.norm_x, cfg.norm_eps)
        q = linear(h, p.xattn.wq, None, None).reshape(b, hh, dh)
        qr = q.reshape(b, kk, hh // kk, dh) * dh**-0.5
        o = cached_attention(qr, ck, cv, enc_len, cross_blk)    # every encoder position
        o = o.reshape(b, hh * dh).to(x.dtype)
        x = x + linear(o, p.xattn.wo, None, None)[:, None]
        x = _mlp(x, p, cfg)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    cache["pos"] = pos + 1
    return linear(x[:, 0], params.head, None, "model"), cache
