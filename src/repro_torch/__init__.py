"""PyTorch + CUDA port of the NasZip index (build, persist, FEE beam search).

A sibling of the JAX package ``repro``: the same public surface under
``repro_torch.index`` (``Index``, ``IndexSpec``, ``SearchParams``,
``SearchResult``), with every Pallas kernel on the search path rewritten as a
hand-written CUDA kernel for Hopper (``repro_torch/kernels/csrc``).  The
package imports ``torch`` and never ``jax`` or any ``repro`` module.

Every entry point takes ``device=`` (default ``"cuda"``) and raises when no
card is present unless the caller asked for ``device="cpu"``.
"""
import torch


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on; never a silent CPU fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; expected cuda or cpu")
    return dev
