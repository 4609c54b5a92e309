"""Assigned architecture registry + input shape grid (the JAX package's
``configs``, with torch dtypes).

10 architectures x 4 shapes = 40 cells.  ``long_500k`` requires sub-quadratic
attention and is SKIPPED for the pure full-attention archs; it runs for the
SSM/hybrid archs.  ``decode_*`` shapes run ``serve_step`` (one token, KV
cache of seq_len), not ``train_step``.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.common import ModelConfig

ARCHS = {
    "arctic-480b": "arctic_480b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "llama3.2-1b": "llama3_2_1b",
    "qwen2-72b": "qwen2_72b",
    "qwen3-8b": "qwen3_8b",
    "yi-9b": "yi_9b",
    "mamba2-780m": "mamba2_780m",
    "llava-next-34b": "llava_next_34b",
    "whisper-base": "whisper_base",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").SMOKE


def has_subquadratic_path(cfg: ModelConfig) -> bool:
    return any(b.mixer == "mamba" for b in cfg.pattern)


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and not has_subquadratic_path(cfg):
        return False, "long_500k needs sub-quadratic attention (pure full-attention arch)"
    return True, ""


def cells(include_skipped: bool = False):
    """All (arch, shape) cells; skipped cells carry the reason."""
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            ok, why = shape_applicable(cfg, shape)
            if ok or include_skipped:
                out.append((arch, shape, ok, why))
    return out


def input_specs(cfg: ModelConfig, shape: ShapeSpec):
    """Stand-ins for every model input of the step: tensors on the ``meta``
    device (shape and dtype, no storage), where the reference gives
    ``jax.ShapeDtypeStruct``."""
    b, s = shape.global_batch, shape.seq_len

    def sd(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    i32, f32 = torch.int32, torch.float32
    if shape.kind in ("train", "prefill"):
        if cfg.is_encdec:
            dec = min(cfg.decoder_len_train, s // 8)
            return dict(frames=sd((b, s, cfg.d_model), f32), tokens=sd((b, dec), i32),
                        labels=sd((b, dec), i32))
        if cfg.frontend == "vision":
            ft = cfg.frontend_tokens
            return dict(prefix_embeds=sd((b, ft, cfg.d_model), f32),
                        tokens=sd((b, s - ft), i32), labels=sd((b, s - ft), i32))
        return dict(tokens=sd((b, s), i32), labels=sd((b, s), i32))

    # decode: one new token against a cache of seq_len
    return dict(tokens=sd((b,), i32))
