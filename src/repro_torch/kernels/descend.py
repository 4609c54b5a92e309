"""CUDA kernel: the greedy descent through the graph's upper levels, from the
entry node to each query's base-level entry.

Replaces no TPU kernel: the JAX package leaves the descent to XLA
(``repro/core/search.py::descend_entry``), and the port ran it as a host
loop of batched torch steps (the adjacency and ids gathers, the rows' read
and decode, the distance ops, an argmin and a ``bool(better.any())`` sync a
step, ~28 steps a call).  Source: ``csrc/descend.cu``; plain version:
``ref.descend_ref``.  One warp a query walks every level, top first, in one
launch: a binary search of the level's sorted ids for its entry, then
greedy steps, each reading the current node's neighbour positions and ids
and scoring their rows with the loads of several rows in flight before any
arithmetic; the first minimum wins, a move only when strictly nearer, and a
query that stops improving leaves the level at once.

Rows are read and decoded in the kernel: f32 rows four features a unit,
packed and tier rows a 128-bit burst a unit (:func:`unit_table`, the
decode's burst descriptors), layouts of other bursts a field a unit (the
decode's field table); each decoded row is bit-equal to ``row_reader``'s
(:func:`decode_rows`, the test hook).  Distances are f32: each unit's
terms summed in feature order by the FEE kernels' ``fee_term`` rule, a
lane's unit sums in order and the lanes' sums in a fixed butterfly order;
not torch's sums, so near ties may walk another way than the plain version.

Bound on this card: the latency of each step's dependent loads, decode and
sums, hidden only by the other resident warps.  A call allocates its
outputs only (the entries and a per-level counter of the most moves any
query made, which the caller reads back only when it wants the step count
and the launcher zeroes on the stream) and does not synchronise.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import dfloat_unpack as unpack_kernel

_LIB = "descend"
_P, _I, _LL = _build.P, _build.I, _build.LL
_ARGS = (_I, _I, _P, _LL, _P, _LL, _I, _P, _I, _I, _I, _I, _P, _LL, _P, _P, _P, _I,
         _I, _P, _P, _P)
_ROW_ARGS = (_I, _P, _LL, _P, _LL, _I, _P, _I, _I, _I, _P, _LL, _P, _P)
MAX_M = 256         # a level's adjacency width a launch takes (csrc/descend.cu's kMaxM)
F32, BURST, FIELD = 0, 1, 2
METRICS = ("l2", "ip")


@functools.lru_cache(maxsize=64)
def unit_table(cfgs: tuple, device: torch.device) -> tuple[int, torch.Tensor, int, int]:
    """``(kind, table, units0, width)`` of the packed rows of the layouts ``cfgs``
    (one layout, or the coarse and residual tiers' in order) on ``device``.
    Burst kind when every tier's bursts are 128 bits of palette widths: one
    row per burst, ``dfloat_unpack.burst_descriptors`` with the residual
    tier's first features moved past the coarse tier's; ``units0`` counts
    the coarse tier's bursts.  Field kind otherwise: one row per feature,
    ``dfloat_unpack.field_table`` with the tier in bit 16 of its second
    column; ``units0`` counts the coarse tier's features.  ``width`` is the
    field width of every segment when they share one (the kernel then
    decodes a burst at compile-time positions without a switch), else 0."""
    burst = all(unpack_kernel.by_burst(c) for c in cfgs if c.dim)
    parts, col, units0 = [], 0, 0
    for t, cfg in enumerate(cfgs):
        if not cfg.dim:
            continue
        tab = (unpack_kernel.burst_descriptors(cfg) if burst
               else unpack_kernel.field_table(cfg)).copy()
        if burst:
            tab[:, 0] += col
        else:
            tab[:, 1] |= t << 16
        parts.append(tab)
        col += cfg.dim
        if t == 0:
            units0 = tab.shape[0]
    tab = np.concatenate(parts) if parts else np.zeros((0, 4), np.int32)
    widths = {sg.width for c in cfgs for sg in c.segments}
    width = widths.pop() if burst and len(widths) == 1 else 0
    return (BURST if burst else FIELD), torch.from_numpy(tab).to(device), units0, width


def _tiers(vectors, storage: str, dfloat_cfg):
    """The storage's row tensors and their layouts as tuples (one tensor for
    f32 and packed rows, the tier pair for tiered)."""
    if storage == "tiered":
        return tuple(vectors), tuple(dfloat_cfg)
    return (vectors,), (None if storage == "f32" else (dfloat_cfg,))


def _rows_args(vectors, storage: str, dfloat_cfg, dim: int, device) -> list:
    """The kernel's storage arguments (kind, p0, pitch0, p1, pitch1, in16,
    table, units, units0, dim) after checking the row tensors, and the
    layout's one field width (0 for f32 rows or several widths)."""
    tensors, cfgs = _tiers(vectors, storage, dfloat_cfg)
    for t in tensors:
        if t.device != device:
            raise ValueError(f"descend: rows on {t.device}, queries on {device}")
    if cfgs is None:
        x, = tensors
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != dim or (
                x.numel() and x.stride(1) != 1):
            raise TypeError(f"descend: f32 rows must be a (N, {dim}) float32 matrix of "
                            f"contiguous rows, got {x.dtype} {tuple(x.shape)} strides "
                            f"{x.stride()}")
        pitch = x.stride(0)
        in16 = int(dim % 4 == 0 and pitch % 4 == 0 and x.data_ptr() % 16 == 0)
        return [F32, x.data_ptr(), pitch, None, 0, in16, None, -(-dim // 4), 0, dim], 0
    if sum(c.dim for c in cfgs) != dim:
        raise ValueError(f"descend: the layouts hold {sum(c.dim for c in cfgs)} features, "
                         f"the queries {dim}")
    pitches = [unpack_kernel.row_pitch(t, c) for t, c in zip(tensors, cfgs)]
    kind, table, units0, width = unit_table(cfgs, device)
    in16 = sum(1 << i for i, (t, p) in enumerate(zip(tensors, pitches))
               if t.data_ptr() % 16 == 0 and p % 4 == 0)
    p1, pitch1 = (tensors[1].data_ptr(), pitches[1]) if len(tensors) > 1 else (None, 0)
    return [kind, tensors[0].data_ptr(), pitches[0], p1, pitch1, in16, table.data_ptr(),
            table.shape[0], units0, dim], width


def _check_levels(levels, device) -> None:
    """Raise unless the levels' flat arrays are contiguous int32 vectors and
    their table an (L, 4) int64 matrix on ``device``, every adjacency width
    within 1..:data:`MAX_M`."""
    for name in ("ids", "adj"):
        t = getattr(levels, name)
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"descend: level {name} must be a contiguous int32 vector, "
                            f"got {t.dtype} {tuple(t.shape)}")
    tab = levels.table
    if tab.dtype != torch.int64 or tuple(tab.shape) != (len(levels.spans), 4) or (
            not tab.is_contiguous()):
        raise TypeError(f"descend: the level table must be a contiguous ({len(levels.spans)}"
                        f", 4) int64 matrix, got {tab.dtype} {tuple(tab.shape)}")
    for t in (levels.ids, levels.adj, tab):
        if t.device != device:
            raise ValueError(f"descend: levels on {t.device}, queries on {device}")
    for _, n, _, m in levels.spans:
        if n < 1 or not 1 <= m <= MAX_M:
            raise ValueError(f"descend: a level of {n} nodes and width {m}; the kernel "
                             f"takes 1..{MAX_M} neighbours a node")


def descend(levels, vectors, storage: str, dfloat_cfg, queries: torch.Tensor,
            metric: str):
    """Each query's greedy walk through ``levels`` (a
    ``core.search.DeviceLevels``), top level first, over the rows of
    ``vectors`` in ``storage`` (``"f32"``, ``"packed"`` with ``dfloat_cfg``
    its layout, or ``"tiered"`` with the (coarse, residual) pairs).  Returns
    (entries (Q,) int32: the base level's entry ids, moves (L,) int32: the
    most moves any query made on each level, bottom level first,
    kernel_levels: the levels the kernel walked, 0 where it launched
    nothing).  CPU tensors take the plain version, which walks no level in
    the kernel."""
    if queries.device.type == "cpu":
        return (*ref.descend_ref(levels, vectors, storage, dfloat_cfg, queries, metric), 0)
    dev = queries.device
    if metric not in METRICS:
        raise ValueError(f"descend: metric={metric!r}; expected one of {METRICS}")
    if queries.dtype != torch.float32 or queries.dim() != 2 or not queries.is_contiguous():
        raise TypeError(f"descend: queries must be a contiguous float32 matrix, got "
                        f"{queries.dtype} {tuple(queries.shape)}")
    _check_levels(levels, dev)
    rows, width = _rows_args(vectors, storage, dfloat_cfg, queries.shape[1], dev)
    n_q = queries.shape[0]
    entries = torch.empty((n_q,), dtype=torch.int32, device=dev)
    moves = torch.empty((len(levels.spans),), dtype=torch.int32, device=dev)
    fn = _build.function(_LIB, "naszip_descend", _ARGS)
    code = fn(rows[0], int(metric == "ip"), *rows[1:], width, queries.data_ptr(), n_q,
              levels.ids.data_ptr(), levels.adj.data_ptr(), levels.table.data_ptr(),
              len(levels.spans), levels.entry, entries.data_ptr(), moves.data_ptr(),
              _build.stream_ptr(queries))
    _build.check(_LIB, "descend", code)
    if n_q == 0:
        return entries, moves, 0
    descend.launches += 1
    return entries, moves, len(levels.spans)


descend.launches = 0


def decode_rows(vectors, storage: str, dfloat_cfg, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` ((C,) int64, each naming a row) as the descent kernel reads
    and decodes them, (C, D) f32: the hook that holds its reads to
    ``core.search.row_reader``.  CUDA tensors only."""
    tensors, cfgs = _tiers(vectors, storage, dfloat_cfg)
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"descend: the kernel takes CUDA tensors, got {dev}")
    if ids.dtype != torch.int64 or ids.dim() != 1 or not ids.is_contiguous() or (
            ids.device != dev):
        raise TypeError(f"descend: ids must be a contiguous int64 vector on {dev}")
    dim = tensors[0].shape[1] if cfgs is None else sum(c.dim for c in cfgs)
    rows, _ = _rows_args(vectors, storage, dfloat_cfg, dim, dev)
    out = torch.empty((ids.shape[0], dim), dtype=torch.float32, device=dev)
    fn = _build.function(_LIB, "naszip_descend_rows", _ROW_ARGS)
    code = fn(*rows, ids.data_ptr(), ids.shape[0], out.data_ptr(), _build.stream_ptr(out))
    _build.check(_LIB, "descend_rows", code)
    return out

