"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) mixer.

The JAX package's ``models/mamba2.py`` on torch tensors.  Chunked SSD:
within a chunk the output is a masked, decay-weighted quadratic form; across
chunks a small recurrent state (H heads x d_state x dh) is carried by a
sequential scan (a Python loop over chunks here).  All of it in float32.
Decode is the O(1) recurrence.

Layout follows mamba2: in_proj -> [z | x | B | C | dt], causal depthwise conv
over (x|B|C), scalar A per head, head-wise D skip, gated RMSNorm out.

On a live mesh a decode cache holds this rank's block of the conv
channels and of the SSM heads (``models.convert.shard_cache``): a decode
step runs the conv over its channels and the recurrence over its heads
and all-gathers each result over ``model``.  A conv weight stored split
over ``model`` (serve mode) runs a prompt's conv over its channels the
same way.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.axes import block_of, linear, live, weight_use
from repro_torch.models.common import ModelConfig, Params, ones, rms_norm, uinit, zeros


def _segsum_decay(log_a):
    """log_a (..., T) -> L (..., T, S) with L[t,s] = exp(sum_{s<u<=t} log_a_u),
    masked to s <= t (the 1-semiseparable mask of SSD)."""
    t = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]                   # sum over (s, t]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=log_a.device))
    # masked before the exp: the upper triangle's exp can overflow, and its
    # inf would turn the where's zero gradient into a NaN
    return torch.exp(torch.where(mask, diff, -torch.inf))


def ssd_chunked(x, dt, a_log, b, c, chunk: int):
    """SSD scan.

    x (B, T, H, dh); dt (B, T, H) >0; a_log (H,) <0 params as -exp(a_log);
    b, c (B, T, S) shared across heads (mamba2 n_groups=1).
    Returns y (B, T, H, dh) and the final state (B, H, S, dh), both float32.
    """
    bsz, t, h, dh = x.shape
    s = b.shape[-1]
    nc = t // chunk
    assert nc * chunk == t, (t, chunk)
    a = -torch.exp(a_log.float())                                # (H,)
    la = dt.float() * a                                          # (B,T,H) log decay
    xdt = x.float() * dt.float()[..., None]

    lac = la.reshape(bsz, nc, chunk, h)
    xc = xdt.reshape(bsz, nc, chunk, h, dh)
    bc = b.reshape(bsz, nc, chunk, s).float()
    cc = c.reshape(bsz, nc, chunk, s).float()

    # intra-chunk (quadratic)
    ldec = _segsum_decay(lac.permute(0, 1, 3, 2))                # (B,nc,H,T,T)
    scores = torch.einsum("bnts,bnus->bntu", cc, bc)             # (B,nc,T,T)
    y_intra = torch.einsum("bntu,bnhtu,bnuhd->bnthd", scores, ldec, xc)

    # chunk-final states: S_n = sum_u decay(chunk_end - u) * B_u x_u^T
    cum = torch.cumsum(lac, dim=2)
    dec_end = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bnus,bnuh,bnuhd->bnhsd", bc, dec_end, xc)
    chunk_decay = torch.exp(lac.sum(2))                          # (B,nc,H)

    state = torch.zeros((bsz, h, s, dh), dtype=torch.float32, device=x.device)
    h_prev = []
    for n in range(nc):                                          # state entering chunk n
        h_prev.append(state)
        state = state * chunk_decay[:, n, :, None, None] + states[:, n]
    h_prev = torch.stack(h_prev, dim=1)                          # (B,nc,H,S,dh)

    # inter-chunk contribution: y_t += C_t . decay(start->t) . h_prev
    dec_in = torch.exp(cum)                                      # (B,nc,T,H)
    y_inter = torch.einsum("bnts,bnth,bnhsd->bnthd", cc, dec_in, h_prev)
    y = (y_intra + y_inter).reshape(bsz, t, h, dh)
    return y, state


def mamba2_mixer(x, p, cfg: ModelConfig, conv_state=None, ssm_state=None,
                 decode: bool = False):
    """x (B, T, D) -> (B, T, D) and (conv state, ssm state).  decode=True
    requires T == 1 and both states."""
    bsz, t, d = x.shape
    di, s, heads, dh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.head_dim
    k = cfg.ssm_conv

    zxbcdt = linear(x, p.in_proj, None, "model")
    z, xin, b, c, dt = torch.split(zxbcdt, [di, di, s, s, heads], dim=-1)
    dt = F.softplus(dt.float() + p.dt_bias)                      # (B,T,H)

    conv_in = torch.cat([xin, b, c], dim=-1)                     # (B,T,di+2s)
    conv_w = weight_use(p.conv_w, x, None, None)
    conv_b = p.conv_b
    # the channels this rank runs: its cache block, or its block of a conv
    # weight used as stored
    ci, cn = (block_of(conv_state, 2) if decode
              else block_of(p.conv_w, 1) if conv_w.shape[-1] < conv_in.shape[-1] else (0, 1))
    if cn > 1:
        conv_in = coll.block(conv_in, 2, ci, cn)
        conv_b = coll.block(conv_b, 0, ci, cn)
        if conv_w.shape[-1] != conv_in.shape[-1]:
            conv_w = coll.block(conv_w, 1, ci, cn)
    if decode:
        window = torch.cat([conv_state, conv_in], dim=1)         # (B,k,di+2s)
        new_conv_state = window[:, 1:]
        conv = torch.einsum("bkp,kp->bp", window, conv_w)[:, None] + conv_b
    else:
        pad = F.pad(conv_in, (0, 0, k - 1, 0))
        windows = torch.stack([pad[:, i: i + t] for i in range(k)], dim=2)  # (B,T,k,P)
        conv = torch.einsum("btkp,kp->btp", windows, conv_w) + conv_b
        new_conv_state = pad[:, -(k - 1):] if k > 1 else None
    conv = F.silu(conv.float()).to(x.dtype)
    if cn > 1:
        conv = coll.all_gather(conv, 2, live().model_group)
    xc, bc, cc = torch.split(conv, [di, s, s], dim=-1)
    xh = xc.reshape(bsz, -1, heads, dh)

    if decode:
        # the heads of this rank's SSM state
        hi, hn = block_of(ssm_state, 1)
        a = -torch.exp(p.a_log.float())
        dt0, xh0 = dt[:, 0], xh[:, 0]
        if hn > 1:
            a = coll.block(a, 0, hi, hn)
            dt0 = coll.block(dt0, 1, hi, hn)
            xh0 = coll.block(xh0, 1, hi, hn)
        dec = torch.exp(dt0 * a)                                 # (B,H)
        dbx = torch.einsum("bs,bh,bhd->bhsd", bc[:, 0].float(), dt0, xh0.float())
        new_ssm = ssm_state * dec[..., None, None] + dbx
        y = torch.einsum("bs,bhsd->bhd", cc[:, 0].float(), new_ssm)
        if hn > 1:
            y = coll.all_gather(y, 1, live().model_group)
        y = y[:, None]                                           # (B,1,H,dh)
    else:
        chunk = min(cfg.ssm_chunk, t)
        while t % chunk:                          # largest divisor of t <= cfg chunk
            chunk -= 1
        y, new_ssm = ssd_chunked(xh, dt, p.a_log, bc, cc, chunk)

    y = y + xh.float() * p.d_skip[None, None, :, None]
    y = y.reshape(bsz, -1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p.out_norm, cfg.norm_eps)
    out = linear(y, p.out_proj, "model", None)
    return out, (new_conv_state, new_ssm)


def init_mamba2(generator, cfg: ModelConfig, dtype, device=None):
    d, di, s, heads = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    k = cfg.ssm_conv
    dev = device if device is not None else generator.device
    proj_out = 2 * di + 2 * s + heads
    f32 = torch.float32
    return Params(
        in_proj=uinit(generator, (d, proj_out), d**-0.5, dtype, dev),
        conv_w=uinit(generator, (k, di + 2 * s), 0.3, dtype, dev),
        conv_b=zeros(di + 2 * s, dtype, dev),
        dt_bias=zeros(heads, f32, dev),
        a_log=zeros(heads, f32, dev),
        d_skip=ones(heads, f32, dev),
        out_norm=ones(di, dtype, dev),
        out_proj=uinit(generator, (di, d), di**-0.5, dtype, dev),
    )
