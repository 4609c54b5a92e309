"""Per-array checksums for on-disk artifacts + the corruption error type.

Every array an index artifact persists (``arrays.npz``) gets a checksum over
its raw bytes, recorded in the sibling JSON manifest as::

    "checksums": {"algo": "crc32c", "arrays": {"<key>": <int>, ...}}

Readers verify after load and raise :class:`CorruptArtifactError` naming the
first mismatching array — a flipped bit or torn tail is *detected*, never
served as garbage neighbors.

The preferred algorithm is CRC32C (Castagnoli); when neither
``google_crc32c`` nor ``crc32c`` is importable we fall back to zlib's CRC-32
and record ``"algo": "crc32"`` so artifacts stay self-describing.
Verification uses the algorithm the manifest names; an artifact written with
a checksum algorithm this host can't compute fails loudly instead of silently
skipping verification.  The manifest format is the JAX package's, so either
package verifies the other's artifacts.
"""
from __future__ import annotations

import zlib


class CorruptArtifactError(ValueError):
    """An on-disk artifact failed integrity verification (checksum mismatch,
    torn/truncated file, unreadable container).  Subclasses ValueError so
    ``except ValueError`` load-error handling still applies."""


def _load_crc32c():
    try:
        import google_crc32c

        return lambda b: int.from_bytes(google_crc32c.Checksum(bytes(b))
                                        .digest(), "big")
    except ImportError:
        pass
    try:
        import crc32c as _c

        return lambda b: _c.crc32c(bytes(b))
    except ImportError:
        return None


_CRC32C = _load_crc32c()
ALGO = "crc32c" if _CRC32C is not None else "crc32"


def checksum_bytes(data, algo: str = ALGO) -> int:
    if algo == "crc32c":
        if _CRC32C is None:
            raise CorruptArtifactError(
                "artifact records crc32c checksums but no crc32c "
                "implementation is available on this host")
        return _CRC32C(data)
    if algo == "crc32":
        return zlib.crc32(data) & 0xFFFFFFFF
    raise CorruptArtifactError(f"unknown checksum algorithm {algo!r}")


def checksum_array(a, algo: str = ALGO) -> int:
    """Checksum an array's raw bytes (C-order; shape/dtype live in the
    container, so corrupting them fails at load before verification)."""
    import numpy as np

    return checksum_bytes(np.ascontiguousarray(a).tobytes(), algo)


def manifest_checksums(arrays: dict) -> dict:
    """The ``checksums`` manifest block for a dict of host arrays."""
    return dict(algo=ALGO,
                arrays={k: checksum_array(v) for k, v in arrays.items()})


def verify_arrays(arrays: dict, checksums: dict | None, where) -> None:
    """Verify loaded ``arrays`` against a manifest ``checksums`` block.

    ``checksums=None`` (a pre-checksum artifact) verifies nothing — old
    artifacts stay loadable.  Raises :class:`CorruptArtifactError` naming the
    first corrupt array otherwise.
    """
    if not checksums:
        return
    algo = checksums.get("algo", "crc32")
    expected = checksums.get("arrays", {})
    missing = set(expected) - set(arrays)
    if missing:
        raise CorruptArtifactError(
            f"{where}: arrays missing from container: {sorted(missing)[:5]}")
    for k in sorted(expected):
        got = checksum_array(arrays[k], algo)
        if got != expected[k]:
            raise CorruptArtifactError(
                f"{where}: checksum mismatch on array {k!r} "
                f"({algo} {got:#010x} != recorded {expected[k]:#010x}) — "
                "artifact is corrupt")
