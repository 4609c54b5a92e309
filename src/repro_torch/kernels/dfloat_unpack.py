"""CUDA kernel: Dfloat bitstream decode, packed (C, W) words -> (C, D) f32.

Replaces ``repro/kernels/dfloat_unpack.py::dfloat_unpack_pallas`` (body
``_kernel``), which unrolls the layout's static shifts over a VMEM tile.
Source: ``csrc/dfloat_unpack.cu``.  One thread decodes one (row, feature)
from a per-feature table (:func:`decode_table`) staged in shared memory, so
one compiled kernel serves every layout; reads and writes are coalesced.

Bound on this card: bytes — each output is 4 B written for a few integer
operations, plus the packed words read once.  The design keeps the decode
in registers and touches each word and each output once.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import dfloat as dfl
from repro_torch.kernels import _build, ref

_LIB = "dfloat_unpack"
_ARGS = (_build.P, _build.LL, _build.I, _build.I, _build.P, _build.P,
         _build.P)
MAX_TABLE_DIM = 48 * 1024 // 16     # table rows that fit the default shared memory


@functools.lru_cache(maxsize=64)
def decode_table(cfg: dfl.DfloatConfig, device: torch.device) -> torch.Tensor:
    """(D, 4) int32 per-feature decode table on ``device``: word index,
    bit offset | width << 8, n_exp | n_man << 8, exponent bias."""
    pos, _ = dfl.feature_positions(cfg)
    tab = np.array([(wi, ofs | s.width << 8, s.n_exp | s.n_man << 8, s.bias)
                    for wi, ofs, s in pos], np.int32).reshape(-1, 4)
    return torch.from_numpy(tab).to(device)


def check_packed(xp: torch.Tensor, cfg: dfl.DfloatConfig) -> None:
    """Raise unless ``xp`` is a contiguous (N, W) int32/uint32 word matrix of
    ``cfg``'s layout on a CUDA device."""
    if xp.device.type != "cuda":
        raise ValueError(f"packed rows must be a CUDA tensor, got {xp.device}")
    if xp.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"packed rows must be int32/uint32 words, got {xp.dtype}")
    if xp.dim() != 2 or xp.shape[1] != dfl.packed_words(cfg):
        raise ValueError(f"packed rows {tuple(xp.shape)} do not match the "
                         f"layout's {dfl.packed_words(cfg)} words per row")
    if not xp.is_contiguous():
        raise ValueError("packed rows must be contiguous")
    if cfg.dim > MAX_TABLE_DIM:
        raise ValueError(f"dim {cfg.dim} > {MAX_TABLE_DIM}: decode table "
                         "exceeds the kernel's shared memory")


def dfloat_unpack(packed: torch.Tensor, cfg: dfl.DfloatConfig) -> torch.Tensor:
    """packed (C, W) int32/uint32 words -> (C, D) f32, bit-exact vs
    ``dfloat.unpack_db``.  CPU tensors take the plain version."""
    if packed.device.type == "cpu":
        return ref.dfloat_unpack_ref(packed, cfg)
    check_packed(packed, cfg)
    out = torch.empty((packed.shape[0], cfg.dim), dtype=torch.float32,
                      device=packed.device)
    fn = _build.function(_LIB, "naszip_dfloat_unpack", _ARGS)
    code = fn(packed.data_ptr(), packed.shape[0], packed.shape[1], cfg.dim,
              decode_table(cfg, packed.device).data_ptr(), out.data_ptr(),
              _build.stream_ptr(packed))
    _build.check(_LIB, "dfloat_unpack", code)
    dfloat_unpack.launches += 1
    return out


dfloat_unpack.launches = 0
