"""qwen3-8b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B]"""
import torch

from repro_torch.models.common import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=12288, vocab=151936,
    pattern=(BlockSpec("attn", "dense"),),
    qk_norm=True, rope_theta=1e6, dtype=torch.bfloat16,
    optimizer="adamw", microbatch=4,
)

SMOKE = ModelConfig(
    name="qwen3-8b-smoke",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
    d_ff=256, vocab=512,
    pattern=(BlockSpec("attn", "dense"),),
    qk_norm=True, dtype=torch.float32, remat=False,
)
