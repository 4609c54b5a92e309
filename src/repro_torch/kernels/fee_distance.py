"""CUDA kernels: FEE-sPCA early-exit distance over f32 rows or packed Dfloat
rows, batched over queries with the row gather fused by id.

``fee_distance`` replaces ``repro/kernels/fee_distance.py::
fee_distance_pallas`` (body ``_kernel``); ``fee_distance_packed`` replaces
``fee_distance_packed_pallas`` with ``skip_dma=False`` (``_packed_kernel``,
``_decode_block``).  Source: ``csrc/fee_distance.cu``.

The JAX kernels score one query against pre-gathered rows under ``vmap``;
these take the resident DB, (Q, L) row ids, an optional (Q, L) alive mask,
the (Q, D) queries and per-query thresholds (Q,), and launch once for every
lane of the batch.  One thread scores one lane: a loop over segments inside
the thread replaces the TPU's sequential grid axis, and a lane reads segment
``s`` of its row only while it is alive — exited and dead lanes stop moving
bytes.  The packed kernel decodes each live segment's fields (the word span
``[w0, w1)`` of ``_block_positions``) with the ``dfloat_unpack`` table and
shares the accumulate/exit code with the f32 kernel, so packed scores are
bit-identical to f32 scores over the emulated rows.

Bound on this card: bytes.  A live segment is a 64 B (f32) or ~32 B
(packed) gather for ~3 flops per feature; the design reads each live
segment's bytes once and no exited lane's.

Outputs are (dist, rejected, segs_used), each (Q, L): ``dist`` is the full
score for survivors, the partial score for rejected lanes, and 0 for dead
lanes (``segs_used == 0``).  The plain versions in ``ref.py`` give the same
outputs over the gathered rows ``db[ids]``.
"""
from __future__ import annotations

import torch

from repro_torch.core import dfloat as dfl
from repro_torch.kernels import _build, ref
from repro_torch.kernels.dfloat_unpack import check_packed, decode_table

_LIB = "fee_distance"
P, I, LL = _build.P, _build.I, _build.LL
_F32_ARGS = (P, LL, I, P, P, P, P, P, P, P, LL, I, I, I, P, P, P, P)
_PACKED_ARGS = (P, LL, I, I, P, P, P, P, P, P, P, P, LL, I, I, I, P, P, P, P)
METRICS = {"l2": 0, "ip": 1}


def _check_lanes(ids, q, threshold, alpha, beta, margin, lane_mask, dim, seg,
                 metric):
    """Raise on any input the kernels do not take; returns (Q, L)."""
    dev = ids.device
    if metric not in METRICS:
        raise ValueError(f"metric={metric!r}; expected one of {tuple(METRICS)}")
    if seg <= 0 or dim % seg:
        raise ValueError(f"seg={seg} must divide dim={dim}")
    if ids.dim() != 2 or ids.dtype != torch.int32:
        raise TypeError(f"ids must be (Q, L) int32, got {ids.dtype} "
                        f"{tuple(ids.shape)}")
    n_q, lanes = ids.shape
    want = {"q": (q, torch.float32, (n_q, dim)),
            "threshold": (threshold, torch.float32, (n_q,)),
            "alpha": (alpha, torch.float32, (dim // seg,)),
            "beta": (beta, torch.float32, (dim // seg,)),
            "margin": (margin, torch.float32, (dim // seg,))}
    if lane_mask is not None:
        want["lane_mask"] = (lane_mask, torch.bool, (n_q, lanes))
    for name, (t, dtype, shape) in want.items():
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not ids.is_contiguous():
        raise ValueError("ids must be contiguous")
    return n_q, lanes


def _outputs(n_q, lanes, device):
    return (torch.empty((n_q, lanes), dtype=torch.float32, device=device),
            torch.empty((n_q, lanes), dtype=torch.bool, device=device),
            torch.empty((n_q, lanes), dtype=torch.int32, device=device))


def fee_distance(db, ids, q, threshold, alpha, beta, margin, *, seg: int,
                 metric: str = "l2", lane_mask=None):
    """Early-exit scores of rows ``db[ids]`` ((N, D) f32, (Q, L) int32 ids)
    against ``q`` (Q, D) with per-query ``threshold`` (Q,).  CPU tensors take
    the plain version."""
    if db.device.type == "cpu":
        return ref.fee_distance_gather_ref(db, ids, q, threshold, alpha, beta,
                                           margin, seg=seg, metric=metric,
                                           lane_mask=lane_mask)
    if db.dtype != torch.float32 or db.dim() != 2 or not db.is_contiguous():
        raise ValueError(f"db must be a contiguous (N, D) float32 tensor, got "
                         f"{db.dtype} {tuple(db.shape)}")
    n_q, lanes = _check_lanes(ids, q, threshold, alpha, beta, margin,
                              lane_mask, db.shape[1], seg, metric)
    dist, rej, segs = _outputs(n_q, lanes, db.device)
    fn = _build.function(_LIB, "naszip_fee_distance_f32", _F32_ARGS)
    code = fn(db.data_ptr(), db.shape[0], db.shape[1], ids.data_ptr(),
              _build.ptr(lane_mask), q.data_ptr(), threshold.data_ptr(),
              alpha.data_ptr(), beta.data_ptr(), margin.data_ptr(), n_q, lanes,
              seg, METRICS[metric], dist.data_ptr(), rej.data_ptr(),
              segs.data_ptr(), _build.stream_ptr(db))
    _build.check(_LIB, "fee_distance", code)
    fee_distance.launches += 1
    return dist, rej, segs


def fee_distance_packed(xp, ids, q, threshold, alpha, beta, margin, *,
                        dfloat_cfg: dfl.DfloatConfig, seg: int,
                        metric: str = "l2", lane_mask=None):
    """Fused Dfloat decode + early-exit scores of packed rows ``xp[ids]``
    ((N, W) int32/uint32 words of ``dfloat_cfg``'s layout).  Bit-identical
    to :func:`fee_distance` over the emulated rows.  CPU tensors take the
    plain version."""
    if xp.device.type == "cpu":
        return ref.fee_distance_packed_gather_ref(
            xp, ids, q, threshold, alpha, beta, margin, dfloat_cfg=dfloat_cfg,
            seg=seg, metric=metric, lane_mask=lane_mask)
    check_packed(xp, dfloat_cfg)
    dim = dfloat_cfg.dim
    n_q, lanes = _check_lanes(ids, q, threshold, alpha, beta, margin,
                              lane_mask, dim, seg, metric)
    dist, rej, segs = _outputs(n_q, lanes, xp.device)
    fn = _build.function(_LIB, "naszip_fee_distance_packed", _PACKED_ARGS)
    code = fn(xp.data_ptr(), xp.shape[0], xp.shape[1], dim,
              decode_table(dfloat_cfg, xp.device).data_ptr(), ids.data_ptr(),
              _build.ptr(lane_mask), q.data_ptr(), threshold.data_ptr(),
              alpha.data_ptr(), beta.data_ptr(), margin.data_ptr(), n_q, lanes,
              seg, METRICS[metric], dist.data_ptr(), rej.data_ptr(),
              segs.data_ptr(), _build.stream_ptr(xp))
    _build.check(_LIB, "fee_distance_packed", code)
    fee_distance_packed.launches += 1
    return dist, rej, segs


fee_distance.launches = 0
fee_distance_packed.launches = 0
