"""llava-next-34b [vlm] — dense GQA backbone + anyres patch frontend STUB
(input_specs provides precomputed patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf]"""
import torch

from repro_torch.models.common import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=20480, vocab=64000,
    pattern=(BlockSpec("attn", "dense"),),
    frontend="vision", frontend_tokens=576,
    rope_theta=5e6, dtype=torch.bfloat16,
    optimizer="adafactor", microbatch=8,
    grad_acc_dtype="bf16",
)

SMOKE = ModelConfig(
    name="llava-next-34b-smoke",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
    d_ff=256, vocab=512,
    pattern=(BlockSpec("attn", "dense"),),
    frontend="vision", frontend_tokens=16,
    dtype=torch.float32, remat=False,
)
