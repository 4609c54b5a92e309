"""Fault tolerance: crash-ordered, checksummed checkpoints (``checkpoint``)."""
