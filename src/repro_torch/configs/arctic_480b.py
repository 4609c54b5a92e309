"""arctic-480b [moe] — 128-expert top-2 MoE + dense residual FFN.
[hf:Snowflake/snowflake-arctic-base; hf]"""
import torch

from repro_torch.models.common import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=4864, vocab=32000,
    pattern=(BlockSpec("attn", "moe"),),
    moe_experts=128, moe_top_k=2, moe_dense_residual=True,
    rope_theta=1e6, dtype=torch.bfloat16,
    optimizer="adafactor", microbatch=8,
    grad_acc_dtype="bf16",
)

SMOKE = ModelConfig(
    name="arctic-480b-smoke",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
    d_ff=96, vocab=512,
    pattern=(BlockSpec("attn", "moe"),),
    moe_experts=8, moe_top_k=2, moe_dense_residual=True,
    dtype=torch.float32, remat=False,
)
