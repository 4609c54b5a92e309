"""qwen2-72b [dense] — GQA with QKV bias. [arXiv:2407.10671]"""
import torch

from repro_torch.models.common import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=29568, vocab=152064,
    pattern=(BlockSpec("attn", "dense"),),
    qkv_bias=True, rope_theta=1e6, dtype=torch.bfloat16,
    optimizer="adafactor", microbatch=8,
    grad_acc_dtype="bf16",
)

SMOKE = ModelConfig(
    name="qwen2-72b-smoke",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
    d_ff=320, vocab=512,
    pattern=(BlockSpec("attn", "dense"),),
    qkv_bias=True, dtype=torch.float32, remat=False,
)
