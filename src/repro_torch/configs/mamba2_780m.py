"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060]"""
import torch

from repro_torch.models.common import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_head=64,
    d_ff=0, vocab=50280,
    pattern=(BlockSpec("mamba", "none"),),
    ssm_state=128, ssm_expand=2, ssm_chunk=256,
    tie_embeddings=True, dtype=torch.bfloat16,
    optimizer="adamw", microbatch=2,
)

SMOKE = ModelConfig(
    name="mamba2-780m-smoke",
    n_layers=2, d_model=96, n_heads=4, n_kv_heads=4, d_head=24,
    d_ff=0, vocab=512,
    pattern=(BlockSpec("mamba", "none"),),
    ssm_state=16, ssm_chunk=8, tie_embeddings=True,
    dtype=torch.float32, remat=False,
)
