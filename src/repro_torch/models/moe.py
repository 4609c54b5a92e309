"""Mixture-of-Experts FFN with capacity-based dispatch (GShard/Switch style).

The JAX package's ``models/moe.py`` on torch tensors.  Supports the assigned
MoE variants:
  * top-k routed experts (qwen2-moe top-4, arctic/jamba top-2)
  * shared experts always on (qwen2-moe: 4 shared)
  * a dense residual FFN in parallel with the routed experts (arctic)

Tokens are grouped into one chunk per data-parallel shard of the ambient
mesh (``distributed.axes.dp_size()``, 1 with none) and the
position-in-expert prefix sum runs within a chunk, as the reference's.
On a live mesh a rank's rows are its chunk; the load-balance fractions
are averaged over the data axes, so the aux loss is the global batch's.
Weights meet their activations at the use sites of ``distributed.axes``
(experts over ``model``: EP).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.axes import constrain, dp_size, dp_sum, linear, live, weight_use
from repro_torch.models.common import ModelConfig, Params, uinit


def swiglu(x, wi, wg, wo):
    h = linear(x, wi, None, "model")
    g = linear(x, wg, None, "model")
    h = F.silu(g) * h               # native dtype, as the reference
    return linear(h, wo, "model", None)


def expert_swiglu(x, wi, wg, wo):
    """x (..., E, C, D); w* (E, D, F)/(E, F, D) -> (..., E, C, D)."""
    h = linear(x, wi, "model", None, None)      # EP kept; dp gathered
    g = linear(x, wg, "model", None, None)
    h = F.silu(g) * h
    return linear(h, wo, "model", None, None)


def top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the lower
    index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(xt, router, cfg: ModelConfig):
    """Router of ``moe_ffn`` over token chunks xt (g, n, D): the softmax
    ``probs`` (g, n, E), the renormalised top-k weights and experts (g, n,
    k), each (token, choice)'s position in its expert's buffer, token-major
    then over choices (g, n, k), whether it fits the capacity, and the
    capacity."""
    e, k = cfg.moe_experts, cfg.moe_top_k
    g, nl, _ = xt.shape
    router = weight_use(router, xt, None, None)
    logits = torch.einsum("gnd,de->gne", xt.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, k)                               # (g, nl, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    cap = max(1, int(cfg.capacity_factor * k * nl / e))
    onehot = F.one_hot(top_e, e).to(torch.int32)                 # (g, nl, k, E)
    flat = onehot.reshape(g, nl * k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(g, nl, k, e)
    pos = (pos * onehot).sum(-1)                                 # (g, nl, k)
    return probs, top_p, top_e, pos, pos < cap, cap


def moe_ffn(x, p, cfg: ModelConfig):
    """x (B, T, D) -> (B, T, D), plus the aux load-balance loss."""
    b, t, d = x.shape
    e = cfg.moe_experts
    n = b * t
    g = 1 if live() is not None else dp_size()   # a live rank holds one chunk
    if n % g:
        g = 1
    xt = constrain(x.reshape(g, n // g, d), "dp", None, None)
    probs, top_p, top_e, pos, keep, cap = route(xt, p.router, cfg)
    oh_e = F.one_hot(top_e, e).to(x.dtype)                       # (g,nl,k,E)
    # a dropped choice points one past the buffer: an all-zero one-hot
    oh_c = F.one_hot(torch.where(keep, pos, cap), cap + 1)[..., :cap].to(x.dtype)
    dispatch = torch.einsum("gnke,gnkc->gnec", oh_e, oh_c)
    combine = torch.einsum("gnke,gnkc,gnk->gnec", oh_e, oh_c, top_p.to(x.dtype))

    xe = torch.einsum("gnec,gnd->gecd", dispatch, xt)            # (g, E, C, D)
    ye = expert_swiglu(xe, p.wi, p.wg, p.wo)
    yt = torch.einsum("gnec,gecd->gnd", combine, ye)

    if cfg.moe_shared_experts:
        yt = yt + swiglu(xt, p.shared_wi, p.shared_wg, p.shared_wo)
    if cfg.moe_dense_residual:
        yt = yt + swiglu(xt, p.dense_wi, p.dense_wg, p.dense_wo)

    # GShard aux loss: mean(fraction routed * mean prob) * E
    frac = oh_e.sum(2).mean((0, 1))                              # (E,)
    if live() is not None:           # over every chunk: the data axes' mean
        frac = dp_sum(frac) / dp_size()
    aux = (frac * probs.mean((0, 1))).sum() * e
    return yt.reshape(b, t, d), aux


def init_moe(generator, cfg: ModelConfig, dtype, device=None):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    w = lambda shape, scale, dt=dtype: uinit(generator, shape, scale, dt, device)
    p = dict(
        router=w((d, e), d**-0.5, torch.float32),
        wi=w((e, d, f), d**-0.5),
        wg=w((e, d, f), d**-0.5),
        wo=w((e, f, d), f**-0.5),
    )
    if cfg.moe_shared_experts:
        fs = f * cfg.moe_shared_experts
        p.update(shared_wi=w((d, fs), d**-0.5), shared_wg=w((d, fs), d**-0.5),
                 shared_wo=w((fs, d), fs**-0.5))
    if cfg.moe_dense_residual:
        p.update(dense_wi=w((d, f), d**-0.5), dense_wg=w((d, f), d**-0.5),
                 dense_wo=w((f, d), f**-0.5))
    return Params(**p)
