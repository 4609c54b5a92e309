"""llama3.2-1b [dense] — small llama3 GQA. [hf:meta-llama/Llama-3.2-1B]"""
import torch

from repro_torch.models.common import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, d_head=64,
    d_ff=8192, vocab=128256,
    pattern=(BlockSpec("attn", "dense"),),
    tie_embeddings=True, rope_theta=5e5, dtype=torch.bfloat16,
    optimizer="adamw", microbatch=2,
)

SMOKE = ModelConfig(
    name="llama3.2-1b-smoke",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
    d_ff=256, vocab=512,
    pattern=(BlockSpec("attn", "dense"),),
    tie_embeddings=True, dtype=torch.float32, remat=False,
)
