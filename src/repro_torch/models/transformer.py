"""Composable decoder LM covering all assigned architecture families.

The JAX package's ``models/transformer.py`` on torch tensors.  One
parameterization drives dense GQA (llama/qwen/yi), MoE (arctic/qwen2-moe),
SSM (mamba2), hybrid interleave (jamba) and — via models/whisper.py —
enc-dec.

The reference stacks each pattern position's weights over the repeat groups
and scans over the groups; here the model holds one block per layer
(``params.blocks[l]``, layer ``l = g * period + i`` is group g's position i,
the reference's ``blocks/pos{i}[g]``) and a Python loop runs them.  Each
weight meets its activation at a use site of ``distributed.axes``
(``linear``, ``embed_lookup``), at the reference's ``weight_use`` lines:
with no mesh in scope it is the plain product; on a live mesh it gathers
the weight from its storage layout and completes the product over the
``model`` axis (``distributed/axes.py``).

The decode cache is ``dict(pos=int, layers=[...])``: ``pos`` is a host
integer, so a step never waits on the device to read it, and each layer
holds ``k``/``v`` (B, S, K, dh) or ``conv``/``ssm`` states.  ``decode_step``
writes the new token's K/V in place and returns the same cache object with
``pos`` advanced.  A step at ``pos >= S`` raises, where the reference's
``dynamic_update_slice`` clamps the write onto the last slot.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.distributed.axes import constrain, embed_lookup, linear
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import NEG, chunked_attention
from repro_torch.models.common import (BlockSpec, ModelConfig, Params, cross_entropy,
                                       ones, remat, rms_norm, rope, uinit, zeros)


# ---------------------------------------------------------------------------
# per-block params
# ---------------------------------------------------------------------------


def init_attn(generator, cfg: ModelConfig, dtype, device=None):
    d, dh = cfg.d_model, cfg.head_dim
    h, k = cfg.n_heads, cfg.n_kv_heads
    dev = device if device is not None else generator.device
    p = dict(
        wq=uinit(generator, (d, h * dh), d**-0.5, dtype, dev),
        wk=uinit(generator, (d, k * dh), d**-0.5, dtype, dev),
        wv=uinit(generator, (d, k * dh), d**-0.5, dtype, dev),
        wo=uinit(generator, (h * dh, d), (h * dh) ** -0.5, dtype, dev),
    )
    if cfg.qkv_bias:
        p.update(bq=zeros(h * dh, dtype, dev), bk=zeros(k * dh, dtype, dev),
                 bv=zeros(k * dh, dtype, dev))
    if cfg.qk_norm:
        p.update(q_norm=ones(dh, dtype, dev), k_norm=ones(dh, dtype, dev))
    return Params(**p)


def init_dense_mlp(generator, cfg: ModelConfig, dtype, device=None):
    d, f = cfg.d_model, cfg.d_ff
    dev = device if device is not None else generator.device
    return Params(wi=uinit(generator, (d, f), d**-0.5, dtype, dev),
                  wg=uinit(generator, (d, f), d**-0.5, dtype, dev),
                  wo=uinit(generator, (f, d), f**-0.5, dtype, dev))


def init_block(generator, spec: BlockSpec, cfg: ModelConfig, dtype, device=None):
    dev = device if device is not None else generator.device
    p = dict(norm1=ones(cfg.d_model, dtype, dev))
    if spec.mixer == "attn":
        p["attn"] = init_attn(generator, cfg, dtype, dev)
    else:
        p["mamba"] = m2.init_mamba2(generator, cfg, dtype, dev)
    if spec.mlp != "none":
        p["norm2"] = ones(cfg.d_model, dtype, dev)
        if spec.mlp == "dense":
            p["mlp"] = init_dense_mlp(generator, cfg, dtype, dev)
        else:
            p["moe"] = moe_mod.init_moe(generator, cfg, dtype, dev)
    return Params(**p)


def layer_specs(cfg: ModelConfig):
    """The spec of every layer, in the order the reference's scan runs them."""
    return [cfg.pattern[l % cfg.period] for l in range(cfg.n_groups * cfg.period)]


def init_params(generator, cfg: ModelConfig, device=None):
    """All weights from ``generator``, on its device (or ``device``; "meta"
    gives shapes only)."""
    dtype = cfg.dtype
    dev = torch.device(device) if device is not None else generator.device
    p = dict(blocks=[init_block(generator, spec, cfg, dtype, dev)
                     for spec in layer_specs(cfg)],
             embed=uinit(generator, (cfg.vocab, cfg.d_model), 0.02, dtype, dev),
             final_norm=ones(cfg.d_model, dtype, dev))
    if not cfg.tie_embeddings:
        p["head"] = uinit(generator, (cfg.d_model, cfg.vocab), cfg.d_model**-0.5, dtype, dev)
    return Params(**p)


def abstract_params(cfg: ModelConfig):
    return init_params(None, cfg, device="meta")


def lm_head(params, cfg: ModelConfig):
    return params.embed.T if cfg.tie_embeddings else params.head


def logits_of(x, params, cfg: ModelConfig):
    """``x @ lm_head(params, cfg)`` at the head's use site (the vocabulary
    over ``model``)."""
    if cfg.tie_embeddings:
        return linear(x, params.embed, "model", None, transpose=True)
    return linear(x, params.head, None, "model")


# ---------------------------------------------------------------------------
# block forward (train / prefill)
# ---------------------------------------------------------------------------


def _naive_attention(q, k, v, *, causal: bool):
    """The reference's unchunked attention (``cfg.scan_unroll``)."""
    b, t, h, dh = q.shape
    s, kk = k.shape[1], k.shape[2]
    g = h // kk
    qq = q.reshape(b, t, kk, g, dh) * dh**-0.5
    sc = torch.einsum("btkgh,bskh->bkgts", qq.float(), k.float())
    if causal:
        mask = torch.tril(torch.ones((t, s), dtype=torch.bool, device=q.device))
        sc = torch.where(mask[None, None, None], sc, -1e30)
    pw = torch.softmax(sc, dim=-1).to(q.dtype)
    o = torch.einsum("bkgts,bskh->btkgh", pw, v)
    return o.reshape(b, t, h, dh)


def _qkv(x, p, cfg: ModelConfig, positions):
    b, t, _ = x.shape
    h, k, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # FSDP: weights stored dp-sharded; gathered to the TP layout at use
    q = linear(x, p.wq, None, "model")
    kx = linear(x, p.wk, None, "model")
    vx = linear(x, p.wv, None, "model")
    if cfg.qkv_bias:
        q, kx, vx = q + p.bq, kx + p.bk, vx + p.bv
    q = q.reshape(b, t, h, dh)
    kx = kx.reshape(b, t, k, dh)
    vx = vx.reshape(b, t, k, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        kx = rms_norm(kx, p.k_norm, cfg.norm_eps)
    return rope(q, positions, cfg.rope_theta), rope(kx, positions, cfg.rope_theta), vx


def attn_forward(x, p, cfg: ModelConfig, positions, causal=True, kv_len=None,
                 return_kv=False):
    b, t, _ = x.shape
    q, kx, vx = _qkv(x, p, cfg, positions)
    if cfg.scan_unroll:
        o = _naive_attention(q, kx, vx, causal=causal)
    else:
        o = chunked_attention(q, kx, vx, causal=causal, kv_len=kv_len)
    out = linear(o.reshape(b, t, -1), p.wo, "model", None)
    if return_kv:
        return out, (kx, vx)
    return out


def _mlp(x, p, spec: BlockSpec, cfg: ModelConfig):
    """The block's second half: x plus its FFN, and the MoE aux loss."""
    h = rms_norm(x, p.norm2, cfg.norm_eps)
    if spec.mlp == "dense":
        return x + moe_mod.swiglu(h, p.mlp.wi, p.mlp.wg, p.mlp.wo), None
    y, aux = moe_mod.moe_ffn(h, p.moe, cfg)
    return x + y, aux


def block_forward(x, p, spec: BlockSpec, cfg: ModelConfig, positions):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p.norm1, cfg.norm_eps)
    if spec.mixer == "attn":
        x = x + attn_forward(h, p.attn, cfg, positions)
    else:
        y, _ = m2.mamba2_mixer(h, p.mamba, cfg)
        x = x + y
    if spec.mlp != "none":
        x, a = _mlp(x, p, spec, cfg)
        if a is not None:
            aux = aux + a
    return x, aux


def backbone(params, x, cfg: ModelConfig, positions):
    """Every layer in turn (each recomputed in the backward pass under
    ``cfg.remat``); returns the hidden states and the summed aux."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, spec in zip(params.blocks, layer_specs(cfg)):
        x, a = remat(block_forward, cfg, x, p, spec, cfg, positions)
        aux = aux + a
    return x, aux


def _embed(params, tokens, prefix_embeds):
    x = embed_lookup(params.embed, tokens)                       # (B,T,D)
    if prefix_embeds is None:
        return x, 0
    return torch.cat([prefix_embeds.to(x.dtype), x], dim=1), prefix_embeds.shape[1]


def lm_forward(params, tokens, cfg: ModelConfig, prefix_embeds=None):
    """tokens (B, T) -> logits (B, T', V) in ``cfg.dtype``, and the aux loss.

    prefix_embeds (B, P, D): stub modality frontend output (VLM patches /
    audio frames) prepended to the token embeddings; logits cover only the
    token positions.
    """
    x, n_prefix = _embed(params, tokens, prefix_embeds)
    x = constrain(x, "dp", None, None)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None, :]
    x, aux = backbone(params, x, cfg, positions)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    if n_prefix:
        x = x[:, n_prefix:]
    logits = constrain(logits_of(x, params, cfg), "dp", None, "model")
    return logits, aux


def lm_loss(params, batch, cfg: ModelConfig):
    logits, aux = lm_forward(params, batch["tokens"], cfg,
                             prefix_embeds=batch.get("prefix_embeds"))
    loss = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss + 0.01 * aux, dict(loss=loss, aux=aux)


# ---------------------------------------------------------------------------
# decode (serve_step): one token, KV cache of kv_len
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, kv_len: int, dtype=None, device="cuda"):
    """A zeroed decode cache on ``device`` (default ``cuda``, which raises
    without a card; "meta" gives shapes only)."""
    if torch.device(device).type != "meta":
        device = resolve_device(device)
    dtype = dtype or cfg.dtype
    dh, k = cfg.head_dim, cfg.n_kv_heads
    layers = []
    for spec in layer_specs(cfg):
        if spec.mixer == "attn":
            layers.append(dict(
                k=torch.zeros((batch, kv_len, k, dh), dtype=dtype, device=device),
                v=torch.zeros((batch, kv_len, k, dh), dtype=dtype, device=device)))
        else:
            layers.append(dict(
                conv=torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state),
                                 dtype=dtype, device=device),
                ssm=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state, dh),
                                dtype=torch.float32, device=device)))
    return dict(pos=0, layers=layers)


def check_room(pos: int, kv_len: int, what: str):
    """A write at ``pos`` must land inside the cache; the reference would
    clamp it onto the last slot and overwrite that token's K/V."""
    if not 0 <= pos < kv_len:
        raise ValueError(f"{what}: decode position {pos} is past the cache "
                         f"({kv_len} slots); allocate a longer cache")


def attn_decode(x, p, kcache, vcache, pos: int, cfg: ModelConfig):
    """x (B, 1, D); kcache/vcache (B, S, K, dh) of this layer.

    Reads the cache only: attention runs over the cached prefix [0, pos)
    plus the current token's (kx, vx) merged explicitly (flash-decoding
    style); the caller writes kx, vx at ``pos``."""
    b = x.shape[0]
    h, k, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pp = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q, kx, vx = _qkv(x, p, cfg, pp)
    gq = h // k
    qr = q[:, 0].reshape(b, k, gq, dh) * dh**-0.5
    sc = torch.einsum("bkgh,bskh->bkgs", qr.float(), kcache.float())
    valid = torch.arange(kcache.shape[1], device=x.device) < pos  # cached prefix only
    sc = torch.where(valid[None, None, None, :], sc, NEG)
    sc_cur = torch.einsum("bkgh,bkh->bkg", qr, kx[:, 0].to(qr.dtype))[..., None]
    m = torch.maximum(sc.amax(-1, keepdim=True), sc_cur)
    pw = torch.exp(sc - m)
    p_cur = torch.exp(sc_cur - m)                                # current token
    o = torch.einsum("bkgs,bskh->bkgh", pw.to(kcache.dtype).float(), vcache.float())
    o = o + p_cur * vx[:, 0, :, None, :].float()
    o = o / (pw.sum(-1)[..., None] + p_cur)
    out = linear(o.reshape(b, h * dh).to(x.dtype), p.wo, "model", None)
    return out[:, None], kx, vx


def decode_step(params, cache, tokens, cfg: ModelConfig):
    """tokens (B,) -> logits (B, V) in ``cfg.dtype``, and the cache (the same
    object, written in place, ``pos`` advanced).  One serve_step."""
    x = params.embed[tokens][:, None]                            # (B,1,D)
    pos = cache["pos"]
    for p, spec, c in zip(params.blocks, layer_specs(cfg), cache["layers"]):
        h = rms_norm(x, p.norm1, cfg.norm_eps)
        if spec.mixer == "attn":
            check_room(pos, c["k"].shape[1], "decode_step")
            y, kx, vx = attn_decode(h, p.attn, c["k"], c["v"], pos, cfg)
            c["k"][:, pos] = kx[:, 0].to(c["k"].dtype)
            c["v"][:, pos] = vx[:, 0].to(c["v"].dtype)
        else:
            y, (conv, ssm) = m2.mamba2_mixer(h, p.mamba, cfg, conv_state=c["conv"],
                                             ssm_state=c["ssm"], decode=True)
            c["conv"], c["ssm"] = conv.to(c["conv"].dtype), ssm
        x = x + y
        if spec.mlp != "none":
            x, _ = _mlp(x, p, spec, cfg)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    cache["pos"] = pos + 1
    return x[:, 0] @ lm_head(params, cfg), cache


def prefill_pass(params, batch, cache, cfg: ModelConfig):
    """One forward pass over the prompt that fills ``cache`` (K/V at [0, T),
    the conv tail and the final SSM state) and returns the final hidden
    states (B, T', D) of the token positions, after the final norm."""
    x, n_prefix = _embed(params, batch["tokens"], batch.get("prefix_embeds"))
    t = x.shape[1]
    positions = torch.arange(t, dtype=torch.int32, device=x.device)[None]
    for p, spec, c in zip(params.blocks, layer_specs(cfg), cache["layers"]):
        h = rms_norm(x, p.norm1, cfg.norm_eps)
        if spec.mixer == "attn":
            if t > c["k"].shape[1]:
                raise ValueError(f"prefill: a prompt of {t} positions is longer "
                                 f"than the cache ({c['k'].shape[1]} slots)")
            y, (kx, vx) = attn_forward(h, p.attn, cfg, positions, return_kv=True)
            c["k"][:, :t] = kx.to(c["k"].dtype)
            c["v"][:, :t] = vx.to(c["v"].dtype)
        else:
            y, (conv_tail, ssm_final) = m2.mamba2_mixer(h, p.mamba, cfg)
            c["conv"], c["ssm"] = conv_tail.to(c["conv"].dtype), ssm_final
        x = x + y
        if spec.mlp != "none":
            x, _ = _mlp(x, p, spec, cfg)
    cache["pos"] = t
    return rms_norm(x[:, n_prefix:], params.final_norm, cfg.norm_eps), cache
