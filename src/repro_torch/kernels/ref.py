"""Plain PyTorch versions of every CUDA kernel in this package.

They run on any device.  The kernel wrappers take them for CPU tensors, the
CPU tests hold them against the JAX package's kernels and oracles, and
``chip_smoke.py`` holds each kernel against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import dfloat as dfl


def fee_distance_ref(q, x, threshold, alpha, beta, margin, *, seg,
                     metric="l2"):
    """FEE early-exit contract on gathered rows, with any leading batch dims.

    ``x`` (..., C, D), ``q`` (..., D), ``threshold`` (...) -> (dist,
    rejected, segs_used), each (..., C).  ``dist`` is the *partial*
    accumulated score for rejected lanes (the hardware stops streaming), the
    full score otherwise — the contract of the JAX ``fee_distance_ref``.
    """
    *lead, c, d = x.shape
    s = d // seg
    if metric == "l2":
        per = ((x - q[..., None, :]) ** 2).reshape(*lead, c, s, seg).sum(-1)
    else:
        per = -(x * q[..., None, :]).reshape(*lead, c, s, seg).sum(-1)
    cum = torch.cumsum(per, dim=-1)
    est = alpha * cum / beta - margin
    thr = torch.as_tensor(threshold, dtype=cum.dtype, device=cum.device)
    exit_mask = est[..., : s - 1] >= thr[..., None, None]
    any_exit = exit_mask.any(dim=-1)
    first_exit = torch.argmax(exit_mask.to(torch.uint8), dim=-1)
    segs_used = torch.where(any_exit, first_exit + 1, s).to(torch.int32)
    dist = torch.gather(cum, -1, (segs_used - 1).long()[..., None])[..., 0]
    return dist, any_exit, segs_used


def fold_lane_mask(out, lane_mask):
    """Fold an alive-lane mask (bool, False = dead) into the FEE outputs.

    A dead lane streams nothing: it comes back rejected with ``segs_used ==
    0`` and ``dist == 0`` (the partial score of zero segments), exactly what
    the CUDA kernels write for a lane they never score.
    """
    if lane_mask is None:
        return out
    dist, rejected, segs_used = out
    return (torch.where(lane_mask, dist, 0.0), rejected | ~lane_mask,
            torch.where(lane_mask, segs_used, 0).to(segs_used.dtype))


def fee_distance_gather_ref(db, ids, q, threshold, alpha, beta, margin, *,
                            seg, metric="l2", lane_mask=None):
    """Plain version of the batched ``fee_distance`` kernel: rows ``db[ids]``
    ((Q, L) ids into (N, D) rows) against ``q`` (Q, D), per-query
    ``threshold`` (Q,), with the optional ``lane_mask`` (Q, L) folded in."""
    out = fee_distance_ref(q, db[ids.long()], threshold, alpha, beta, margin,
                           seg=seg, metric=metric)
    return fold_lane_mask(out, lane_mask)


def fee_distance_packed_ref(q, xp, threshold, alpha, beta, margin, *,
                            dfloat_cfg: dfl.DfloatConfig, seg, metric="l2"):
    """Packed-input contract: decode the bitstream rows ``xp`` (..., C, W),
    then score with the exact same FEE arithmetic — packed scoring is
    bit-identical to scoring ``dfloat.emulate_db`` data."""
    *lead, c, w = xp.shape
    x = dfl.unpack_rows(xp.reshape(-1, w), dfloat_cfg).reshape(*lead, c, -1)
    return fee_distance_ref(q, x, threshold, alpha, beta, margin,
                            seg=seg, metric=metric)


def fee_distance_packed_gather_ref(xp, ids, q, threshold, alpha, beta, margin,
                                   *, dfloat_cfg: dfl.DfloatConfig, seg,
                                   metric="l2", lane_mask=None):
    """Plain version of the batched ``fee_distance_packed`` kernel over
    packed rows ``xp[ids]``."""
    out = fee_distance_packed_ref(q, xp[ids.long()], threshold, alpha, beta,
                                  margin, dfloat_cfg=dfloat_cfg, seg=seg,
                                  metric=metric)
    return fold_lane_mask(out, lane_mask)


def dfloat_unpack_ref(packed, cfg: dfl.DfloatConfig):
    """Plain version of the ``dfloat_unpack`` kernel (bit-exact decoder)."""
    return dfl.unpack_rows(packed, cfg)
