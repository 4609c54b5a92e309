"""CUDA kernel: Dfloat bitstream decode, packed (N, W) words -> (C, D) f32.

Replaces ``repro/kernels/dfloat_unpack.py::dfloat_unpack_pallas`` (body
``_kernel``, ``pallas_call`` at :48), which unrolls the layout's static
shifts over a VMEM tile.  Source: ``csrc/dfloat_unpack.cu``.  One thread
decodes one 16 B burst of a row, read with one 16 B load (consecutive
threads on consecutive bursts); the burst's fields lie at compile-time
positions for its width (every segment starts a 128-bit burst) and are
widened with their format's constants, from the per-burst descriptors of
:func:`burst_descriptors`.  A block decodes its rows into a shared tile and
writes the tile out with consecutive threads on consecutive 16 B of each
output row: a thread's eight 16-bit fields are 32 B apart from its
neighbours', so storing them from registers would half-fill every sector a
store touches (that design, tried first, ran slower than the kernel it
replaced).  A layout whose bursts are not 128 bits, or whose widths lie
outside :data:`BURST_WIDTHS`, takes the per-field path of the same source
(:func:`field_table`), exact too.

The wrapper gathers rows by id inside the kernel (``ids``: no copy of the
gathered rows first) and writes at a column offset of a wider output
(``out``, ``col``: the tiered decode fills one matrix from both tiers).

Bound on this card: bytes — each output is 4 B written for a few integer
operations, plus the packed words (and ids) read once.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import dfloat as dfl
from repro_torch.kernels import _build, ref

_LIB = "dfloat_unpack"
_ARGS = (_build.P, _build.LL, _build.LL, _build.P, _build.LL, _build.I,
         _build.I, _build.I, _build.P, _build.P, _build.LL, _build.I, _build.P)
BURST_WIDTHS = (32, 24, 21, 18, 16, 14, 12)   # the widths the burst path is built for


def widen_constants(sg: dfl.DfloatSegment) -> tuple[int, int]:
    """``naszip::widen_field``'s mul and ebias of a format: ``1 << (23 -
    n_man)`` and ``(127 - bias) << 23`` modulo 2^32."""
    return 1 << (23 - sg.n_man), ((127 - sg.bias) << 23) % (1 << 32)


def by_burst(cfg: dfl.DfloatConfig) -> bool:
    """Whether the kernel decodes ``cfg``'s rows a 16 B burst a thread: 128
    bit bursts and every width in :data:`BURST_WIDTHS`."""
    return cfg.burst_bits == 128 and all(s.width in BURST_WIDTHS
                                         for s in cfg.segments)


def burst_descriptors(cfg: dfl.DfloatConfig) -> np.ndarray:
    """(W / 4, 4) int32, one row per 128-bit burst of the packed row: its
    first output feature, its field count | width << 8, and its format's mul
    and ebias (:func:`widen_constants`).  Field l of the burst lies at bit
    ``l * width``."""
    rows = []
    for s, _, nb, per in dfl.burst_layout(cfg)[0]:
        mul, ebias = widen_constants(s)
        rows += [(s.start + b * per, min(per, s.n_dims - b * per) | s.width << 8,
                  mul, ebias) for b in range(nb)]
    return np.array(rows, np.uint32).reshape(-1, 4).view(np.int32)


def field_table(cfg: dfl.DfloatConfig) -> np.ndarray:
    """(D, 4) int32, one row per feature, for the per-field path: word index,
    bit offset | width << 8, and its format's mul and ebias."""
    pos, _ = dfl.feature_positions(cfg)
    return np.array([(wi, ofs | s.width << 8, *widen_constants(s))
                     for wi, ofs, s in pos], np.uint32).reshape(-1, 4).view(np.int32)


@functools.lru_cache(maxsize=64)
def _table(cfg: dfl.DfloatConfig, device: torch.device) -> tuple[bool, torch.Tensor]:
    """(by burst, the table that path reads) on ``device``."""
    burst = by_burst(cfg)
    tab = burst_descriptors(cfg) if burst else field_table(cfg)
    return burst, torch.from_numpy(tab).to(device)


def row_pitch(xp: torch.Tensor, cfg: dfl.DfloatConfig) -> int:
    """The pitch in words of ``xp``'s rows; raises unless ``xp`` is an
    (N, W) int32/uint32 word matrix of ``cfg``'s layout whose rows are
    contiguous (``stride(1) == 1``) at a pitch of at least W words: the
    whole matrix or a row view of a wider one.  An empty matrix (an empty
    tier) takes any strides: the kernels read none of it."""
    if xp.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"packed rows must be int32/uint32 words, got {xp.dtype}")
    if xp.dim() != 2 or xp.shape[1] != dfl.packed_words(cfg):
        raise ValueError(f"packed rows {tuple(xp.shape)} do not match the "
                         f"layout's {dfl.packed_words(cfg)} words per row")
    if xp.numel() and (xp.stride(1) != 1 or xp.stride(0) < xp.shape[1]):
        raise ValueError(f"packed rows must be contiguous at a pitch of at least "
                         f"{xp.shape[1]} words, got strides {xp.stride()}")
    return xp.stride(0)


def check_packed(xp: torch.Tensor, cfg: dfl.DfloatConfig) -> int:
    """Raise unless ``xp`` is a CUDA tensor of packed rows that
    :func:`row_pitch` takes; returns their pitch in words."""
    if xp.device.type != "cuda":
        raise ValueError(f"packed rows must be a CUDA tensor, got {xp.device}")
    return row_pitch(xp, cfg)


def _check_target(packed, cfg, ids, out, col) -> int:
    """Raise unless ``ids`` (if given) is a contiguous 1-D int64 tensor and
    ``out`` (if given) a float32 matrix of contiguous rows, one per decoded
    row, with room for ``cfg.dim`` columns from ``col``, both on ``packed``'s
    device; returns the number of decoded rows."""
    n = packed.shape[0]
    if ids is not None:
        if ids.dtype != torch.int64 or ids.dim() != 1 or not ids.is_contiguous():
            raise TypeError(f"ids must be a contiguous 1-D int64 tensor, got "
                            f"{ids.dtype} {tuple(ids.shape)}")
        if ids.device != packed.device:
            raise ValueError(f"ids on {ids.device}, packed rows on {packed.device}")
        n = ids.shape[0]
    if out is None:
        if col:
            raise ValueError("a column offset needs an out= matrix")
        return n
    if out.dtype != torch.float32 or out.dim() != 2 or out.device != packed.device:
        raise TypeError(f"out must be a float32 matrix on {packed.device}, got "
                        f"{out.dtype} {tuple(out.shape)} on {out.device}")
    if out.shape[0] != n or not 0 <= col <= out.shape[1] - cfg.dim:
        raise ValueError(f"out {tuple(out.shape)} has no room for {n} rows of "
                         f"{cfg.dim} features at column {col}")
    if out.numel() and out.stride(1) != 1:
        raise ValueError(f"out rows must be contiguous, got strides {out.stride()}")
    return n


def dfloat_unpack(packed: torch.Tensor, cfg: dfl.DfloatConfig, *,
                  ids: torch.Tensor | None = None, out: torch.Tensor | None = None,
                  col: int = 0) -> torch.Tensor:
    """Decode rows of ``packed`` (N, W) int32/uint32 words (rows at any pitch
    >= W) to f32, bit-exact vs ``dfloat.unpack_db``: rows ``ids`` (int64,
    (C,); an id that names no row decodes as zeros) or all N.  Writes
    ``out[:, col:col + D]`` and returns ``out`` when ``out`` is given, else
    returns a new (C, D) matrix.  CPU tensors take the plain version."""
    n = _check_target(packed, cfg, ids, out, col)
    if packed.device.type == "cpu":
        dec = ref.dfloat_unpack_ref(packed, cfg, ids)
        if out is None:
            return dec
        out[:, col:col + cfg.dim] = dec
        return out
    pitch = check_packed(packed, cfg)
    if out is None:
        out = torch.empty((n, cfg.dim), dtype=torch.float32, device=packed.device)
    if n == 0 or cfg.dim == 0:
        return out
    burst, table = _table(cfg, packed.device)
    fn = _build.function(_LIB, "naszip_dfloat_unpack", _ARGS)
    code = fn(packed.data_ptr(), pitch, packed.shape[0], _build.ptr(ids), n,
              int(burst), table.shape[0], cfg.dim, table.data_ptr(), out.data_ptr(),
              out.stride(0), col, _build.stream_ptr(packed))
    _build.check(_LIB, "dfloat_unpack", code)
    dfloat_unpack.launches += 1
    return out


dfloat_unpack.launches = 0
