"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4 experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
import torch

from repro_torch.models.common import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab=151936,
    pattern=(BlockSpec("attn", "moe"),),
    moe_experts=60, moe_top_k=4, moe_shared_experts=4,
    qkv_bias=True, rope_theta=1e6, dtype=torch.bfloat16,
    optimizer="adamw", microbatch=4,
)

SMOKE = ModelConfig(
    name="qwen2-moe-smoke",
    n_layers=2, d_model=96, n_heads=4, n_kv_heads=4, d_head=24,
    d_ff=64, vocab=512,
    pattern=(BlockSpec("attn", "moe"),),
    moe_experts=6, moe_top_k=4, moe_shared_experts=2,
    qkv_bias=True, dtype=torch.float32, remat=False,
)
