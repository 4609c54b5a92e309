"""Artifact integrity: per-array checksums and the corruption error type."""
from repro_torch.resilience.checksum import CorruptArtifactError  # noqa: F401
