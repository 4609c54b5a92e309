"""Fault tolerance: crash-ordered, checksummed checkpoints (``checkpoint``)
and placing a state on another mesh (``elastic``)."""
from repro_torch.ft import checkpoint, elastic  # noqa: F401
