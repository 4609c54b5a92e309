"""Attention: the chunked (FlashAttention-style) prefill path and the
partial-softmax decode path used for sequence-sharded KV caches.

The JAX package's ``models/attention.py`` on torch tensors.  Scores, the
online-softmax statistics and the accumulators are float32: where the
reference asks XLA for float32 products of bfloat16 operands
(``preferred_element_type``), the port casts the operands to float32 first
(a bfloat16 product is exact in float32).

``merge_partials`` is a ``pmax``/``psum`` over a mesh axis in the reference;
here it reduces over a leading axis of stacked partials, as
``distributed/comm.py::LocalShards`` stacks shards, and
:func:`merge_partials_over` is the reference's form over the ranks of a
process group (a decode cache's sequence blocks over ``model``).
"""
from __future__ import annotations

import torch

NEG = -1.0e30


def _gqa_scores(q, k):
    """q (B, T, K, G, dh), k (B, S, K, dh) -> scores (B, K, G, T, S) f32."""
    return torch.einsum("btkgh,bskh->bkgts", q.float(), k.float())


def chunked_attention(q, k, v, *, causal: bool, q_offset=0,
                      q_chunk: int = 512, kv_chunk: int = 1024,
                      kv_len=None):
    """Memory-efficient attention with online softmax.

    q (B, T, H, dh); k, v (B, S, K, dh); H = K * G (GQA).
    q_offset: global position of q[0] (for causal masking in chunked prefill).
    kv_len:   optional number of valid kv positions (int or 0-d tensor).
    Returns (B, T, H, dh) in q.dtype.
    """
    b, t, h, dh = q.shape
    s, kk = k.shape[1], k.shape[2]
    g = h // kk
    scale = dh ** -0.5
    qc = min(q_chunk, t)
    kc = min(kv_chunk, s)
    nq, nk = t // qc, s // kc
    assert nq * qc == t and nk * kc == s, (t, s, qc, kc)

    dev = q.device
    qr = (q * scale).reshape(b, nq, qc, kk, g, dh).to(q.dtype)
    kr = k.reshape(b, nk, kc, kk, dh)
    vr = v.reshape(b, nk, kc, kk, dh)
    kv_pos = torch.arange(s, device=dev).reshape(nk, kc)
    valid = (torch.ones((nk, kc), dtype=torch.bool, device=dev) if kv_len is None
             else kv_pos < kv_len)

    # a causal kv block wholly after a q block's last position adds exactly
    # nothing (its scores are masked, so p = 0 and alpha = 1): skipped; a
    # block every position of which is visible needs no mask
    static = isinstance(q_offset, int) and (kv_len is None or isinstance(kv_len, int))
    outs = []
    for qi in range(nq):
        qb = qr[:, qi].float()
        first = q_offset + qi * qc
        q_pos = first + torch.arange(qc, device=dev)
        m = torch.full((b, kk, g, qc), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((b, kk, g, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kk, g, qc, dh), dtype=torch.float32, device=dev)
        for ki in range(nk):
            if static and causal and ki * kc > first + qc - 1:
                break
            sc = _gqa_scores(qb, kr[:, ki])                      # (B,K,G,qc,kc)
            if not (static and (ki + 1) * kc <= (s if kv_len is None else kv_len)
                    and (not causal or (ki + 1) * kc - 1 <= first)):
                mask = valid[ki][None, :]
                if causal:
                    mask = mask & (kv_pos[ki][None, :] <= q_pos[:, None])
                sc = torch.where(mask[None, None, None], sc, NEG)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("bkgts,bskh->bkgth", p, vr[:, ki].float())
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]         # (B,K,G,qc,dh)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, qc, h, dh))
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention_partial(q, k, v, kv_valid):
    """One-token attention over a LOCAL KV slice -> partial (o, m, l).

    q (B, H, dh); k, v (B, Sl, K, dh); kv_valid (B, Sl) bool.
    Returns o (B, H, dh) f32 un-normalized, m (B, H) row max, l (B, H) sum.
    Merge rule across shards (flash-decoding / the DaM tiny-merge):
        m* = max(m_i); o* = sum_i o_i * exp(m_i - m*); l* = sum_i l_i * exp(m_i - m*)
        out = o* / l*
    """
    b, h, dh = q.shape
    kk = k.shape[2]
    g = h // kk
    scale = dh ** -0.5
    qr = (q * scale).reshape(b, kk, g, dh)
    sc = torch.einsum("bkgh,bskh->bkgs", qr.float(), k.float())
    sc = torch.where(kv_valid[:, None, None, :], sc, NEG)
    m = sc.amax(-1)                                              # (B,K,G)
    p = torch.exp(sc - m[..., None])
    p = torch.where(kv_valid[:, None, None, :], p, 0.0)
    l = p.sum(-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v.float())
    return o.reshape(b, h, dh), m.reshape(b, h), l.reshape(b, h)


def merge_partials(o, m, l, dim: int = 0):
    """LSE merge of decode partials stacked on ``dim`` (one per shard)."""
    m_g = m.amax(dim, keepdim=True)
    alpha = torch.exp(m - m_g)
    o_g = (o * alpha[..., None]).sum(dim)
    l_g = (l * alpha).sum(dim)
    return o_g / torch.clamp(l_g, min=1e-30)[..., None]


def merge_partials_over(o, m, l, group):
    """LSE merge of this rank's decode partial with those of the other
    ranks of ``group`` (the reference's ``merge_partials`` over an axis
    name): an all-reduce max of ``m``, then one all-reduce sum of the
    rescaled ``o`` and ``l`` together.  o (..., dh) f32, m and l (...)."""
    from repro_torch.distributed import collectives as coll

    m_g = coll.all_reduce(m, group, op="max")
    alpha = torch.exp(m - m_g)
    ol = coll.all_reduce(torch.cat([o * alpha[..., None], (l * alpha)[..., None]], -1), group)
    return ol[..., :-1] / torch.clamp(ol[..., -1], min=1e-30)[..., None]
