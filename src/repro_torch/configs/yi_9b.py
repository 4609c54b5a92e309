"""yi-9b [dense] — llama-arch GQA (kv=4). [arXiv:2403.04652]"""
import torch

from repro_torch.models.common import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=11008, vocab=64000,
    pattern=(BlockSpec("attn", "dense"),),
    rope_theta=5e6, dtype=torch.bfloat16,
    optimizer="adamw", microbatch=4,
)

SMOKE = ModelConfig(
    name="yi-9b-smoke",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
    d_ff=256, vocab=512,
    pattern=(BlockSpec("attn", "dense"),),
    dtype=torch.float32, remat=False,
)
