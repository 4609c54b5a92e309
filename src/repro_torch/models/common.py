"""Shared model primitives: config, norms, RoPE, losses, init helpers.

The JAX package's ``models/common.py`` on torch tensors.  ``ModelConfig``
keeps every field of the reference.  Of its training fields, ``remat``
recomputes each block in the backward pass (:func:`remat`) and the trainer
(``repro_torch.launch.train``) takes ``optimizer`` and sets ``microbatch``
from its flag; ``grad_acc_dtype`` stays for parity (the reference's trainer
does not read it either).  ``dtype`` is a ``torch.dtype``.

A model's weights are a tree of :class:`Params` modules whose attribute
names are the reference's parameter-dict keys (``p.wq``, ``p.mlp.wi``), so
the forward functions read as the reference's.  Weights are created with
``requires_grad=False``, for inference; training turns their gradients on
(``requires_grad_(True)``, which ``training.init_state`` calls).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.axes import dp_sum, live


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One position in the repeating layer pattern."""
    mixer: str   # "attn" | "mamba"
    mlp: str     # "dense" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                      # 0 -> d_model // n_heads
    # layer pattern (cycled): e.g. dense = [A*], jamba = 7xM + 1xA
    pattern: tuple[BlockSpec, ...] = (BlockSpec("attn", "dense"),)
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_shared_experts: int = 0
    moe_dense_residual: bool = False     # arctic: dense FFN parallel to MoE
    capacity_factor: float = 1.25
    # attention details
    qkv_bias: bool = False               # qwen2
    qk_norm: bool = False                # qwen3
    rope_theta: float = 1e6
    # mamba2 / SSD
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # enc-dec (whisper)
    encoder_layers: int = 0
    decoder_len_train: int = 512
    decoder_self_window: int = 448       # whisper max target positions
    # modality frontend stub ("none" | "vision" | "audio"): input_specs()
    # provides precomputed patch/frame embeddings
    frontend: str = "none"
    frontend_tokens: int = 0             # tokens occupied by the stub frontend
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # training memory policy
    remat: bool = True                   # recompute each block in the backward
    microbatch: int = 0                  # 0 -> no accumulation
    optimizer: str = "adamw"             # "adamw" | "adafactor"
    grad_acc_dtype: str = "f32"          # "bf16" for the 400B-class archs
    scan_unroll: bool = False            # the reference's flops-analysis lowering

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.period == 0, (self.n_layers, self.period)
        return self.n_layers // self.period

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return all(b.mixer == "mamba" for b in self.pattern)

    def param_count(self, active_only: bool = False) -> int:
        """Analytical parameter count (for MODEL_FLOPS = 6*N*D)."""
        d, dh = self.d_model, self.head_dim
        n = 0
        for b in self.pattern:
            if b.mixer == "attn":
                n += d * dh * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * dh * d
            else:
                di = self.d_inner
                heads = self.ssm_heads
                n += d * (2 * di + 2 * self.ssm_state + heads) + di * d \
                    + self.ssm_conv * (di + 2 * self.ssm_state) + 2 * heads
            if b.mlp == "dense":
                n += 3 * d * self.d_ff
            elif b.mlp == "moe":
                e = self.moe_top_k if active_only else self.moe_experts
                n += 3 * d * self.d_ff * e + d * self.moe_experts
                if self.moe_shared_experts:
                    n += 3 * d * self.d_ff * self.moe_shared_experts
                if self.moe_dense_residual:
                    n += 3 * d * self.d_ff
            n += 2 * d
        n *= self.n_groups
        n += self.vocab * d * (1 if self.tie_embeddings else 2) + d
        if self.is_encdec:
            enc = d * dh * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * dh * d \
                + 3 * d * self.d_ff + 2 * d
            n += self.encoder_layers * enc
            n += self.n_layers * (d * dh * (self.n_heads + 2 * self.n_kv_heads)
                                  + self.n_heads * dh * d + d)  # cross-attn
        return n


class Params(nn.Module):
    """A named set of weights and nested sets: one parameter dict of the
    reference as a module.  Tensors become parameters (no gradient), modules
    submodules and lists of modules a ``ModuleList``."""

    def __init__(self, **items):
        super().__init__()
        for name, v in items.items():
            if isinstance(v, nn.Module):
                self.add_module(name, v)
            elif isinstance(v, (list, tuple)):
                self.add_module(name, nn.ModuleList(v))
            else:
                self.register_parameter(name, nn.Parameter(v, requires_grad=False))


def remat(fn, cfg: ModelConfig, *args):
    """``fn(*args)``; when ``cfg.remat`` and gradients are being recorded, its
    activations are not kept but recomputed in the backward pass (the
    reference's ``jax.checkpoint`` with nothing saveable)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def rms_norm(x, w, eps=1e-5):
    """In float32, times ``w`` (which may be bfloat16), then back to x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * w).to(dt)


def rope(x, positions, theta: float):
    """x: (..., T, H, Dh); positions (..., T).  The half-split ("rotate
    half") layout; frequencies and angles in float32."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions[..., None].float() * freqs                   # (..., T, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def cross_entropy(logits, labels, mask=None):
    """Mean CE over valid positions (the label's log-prob is gathered; the
    reference's masked sum over the vocab gives the same value)."""
    logits = logits.float()
    m = logits.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    ll = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    # on a live mesh: this rank's share of the global batch's masked mean
    # (the count over every rank of the data axes; the ranks' losses average
    # to the global one)
    mesh = live()
    count = dp_sum(mask.sum().detach())
    return (nll * mask).sum() * (mesh.dp_size if mesh else 1) / torch.clamp(count, min=1.0)


# a function every ``uinit`` draw goes through while :func:`each_draw` is in
# force (``models.convert.init_sharded`` cuts each to a rank's block)
_EACH_DRAW = {"fn": None}


@contextlib.contextmanager
def each_draw(fn):
    """Within: ``uinit`` returns ``fn(w)`` for each weight ``w`` it makes
    (on the meta device too), in the order it makes them."""
    prev = _EACH_DRAW["fn"]
    _EACH_DRAW["fn"] = fn
    try:
        yield
    finally:
        _EACH_DRAW["fn"] = prev


def uinit(generator, shape, scale, dtype, device=None):
    """A normal draw in float32 from ``generator``, times ``scale``, then cast.
    On the meta device (shapes only) nothing is drawn."""
    device = torch.device(device) if device is not None else generator.device
    if device.type == "meta":
        w = torch.empty(shape, dtype=dtype, device=device)
    else:
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        w = w.mul_(scale).to(dtype)
    fn = _EACH_DRAW["fn"]
    return w if fn is None else fn(w)


def ones(n, dtype, device):
    return torch.ones((n,), dtype=dtype, device=device)


def zeros(n, dtype, device):
    return torch.zeros((n,), dtype=dtype, device=device)
