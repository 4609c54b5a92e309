"""whisper-base [audio] — enc-dec, conv/mel frontend STUB (input_specs
provides precomputed frame embeddings). [arXiv:2212.04356]"""
import torch

from repro_torch.models.common import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_head=64,
    d_ff=2048, vocab=51865,
    pattern=(BlockSpec("attn", "dense"),),
    encoder_layers=6, decoder_len_train=512, decoder_self_window=448,
    frontend="audio", dtype=torch.bfloat16,
    optimizer="adamw", microbatch=1,
)

SMOKE = ModelConfig(
    name="whisper-base-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab=512,
    pattern=(BlockSpec("attn", "dense"),),
    encoder_layers=2, decoder_len_train=16, decoder_self_window=16,
    frontend="audio", dtype=torch.float32, remat=False,
)
