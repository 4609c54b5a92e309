"""Fault tolerance: crash-ordered, checksummed checkpoints (``checkpoint``)
and placing a state on another mesh (``elastic``)."""
