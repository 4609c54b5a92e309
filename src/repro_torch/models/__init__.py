"""The LM stack's inference half on torch: the JAX package's ``models`` (dense
GQA, MoE, Mamba-2 SSD, hybrid and encoder-decoder families) with one block
module per layer, and ``convert`` to carry the reference's weights and caches
across."""
from repro_torch.models.common import BlockSpec, ModelConfig
from repro_torch.models.registry import ModelAPI, get_model

__all__ = ["BlockSpec", "ModelConfig", "ModelAPI", "get_model"]
