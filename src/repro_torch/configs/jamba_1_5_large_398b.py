"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, 16-expert
top-2 MoE every other layer. [arXiv:2403.19887]"""
import torch

from repro_torch.models.common import BlockSpec, ModelConfig

# period-8 pattern: 1 attention layer per 8 (1:7), MoE on every other layer
_PATTERN = (
    BlockSpec("attn", "moe"),
    BlockSpec("mamba", "dense"),
    BlockSpec("mamba", "moe"),
    BlockSpec("mamba", "dense"),
    BlockSpec("mamba", "moe"),
    BlockSpec("mamba", "dense"),
    BlockSpec("mamba", "moe"),
    BlockSpec("mamba", "dense"),
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=24576, vocab=65536,
    pattern=_PATTERN,
    moe_experts=16, moe_top_k=2,
    ssm_state=64, ssm_expand=2, ssm_chunk=256,
    rope_theta=1e6, dtype=torch.bfloat16,
    optimizer="adafactor", microbatch=8,
    grad_acc_dtype="bf16",
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    n_layers=4, d_model=96, n_heads=4, n_kv_heads=2, d_head=24,
    d_ff=128, vocab=512,
    pattern=(BlockSpec("attn", "moe"), BlockSpec("mamba", "dense"),
             BlockSpec("mamba", "moe"), BlockSpec("mamba", "dense")),
    moe_experts=4, moe_top_k=2, ssm_state=16, ssm_chunk=8,
    dtype=torch.float32, remat=False,
)
