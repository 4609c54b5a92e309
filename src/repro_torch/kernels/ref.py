"""Plain PyTorch versions of every CUDA kernel in this package.

They run on any device.  The kernel wrappers take them for CPU tensors, the
CPU tests hold them against the JAX package's kernels and oracles (and
:func:`frontier_ref` against the JAX package's hop pieces), and
``chip_smoke.py`` holds each kernel against them on the card
(:func:`descend_ref` against the ``descend`` kernel it stands in for on the
CPU).  The skip-DMA
kernels compute the contracts of ``fee_distance_gather_ref`` and
``fee_distance_packed_gather_ref``; they differ only in which bytes they
move, so they have no plain version of their own.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import dfloat as dfl
from repro_torch.core import fee as fee_mod
from repro_torch.core import search


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


def fee_search_semantics_ref(q, x, threshold, alpha, beta, margin, *, seg,
                             metric="l2"):
    """The full-distance FEE contract that ``core.search`` uses
    (``core.fee.fee_distance``): every lane's score is its full distance,
    with the same ``rejected`` and ``segs_used`` as :func:`fee_distance_ref`,
    so survivors' scores agree between the two contracts."""
    return fee_mod.fee_distance(q, x, threshold, alpha, beta, margin,
                                seg=seg, metric=metric)


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


def dfloat_unpack_tiered_ref(xc, xr, coarse_cfg: dfl.DfloatConfig,
                             resid_cfg: dfl.DfloatConfig, ids=None):
    """Decode a (coarse (N, Wc), residual (N, Wr)) tier-row pair (rows
    ``ids`` of it, as :func:`dfloat_unpack_ref` takes them) back to (C, D)
    f32: each tier is its own burst-aligned bitstream, and
    ``dfloat.split_config`` keeps every feature's format, so the result
    equals the parent layout's decode bit for bit."""
    return torch.cat([dfloat_unpack_ref(xc, coarse_cfg, ids),
                      dfloat_unpack_ref(xr, resid_cfg, ids)], dim=1)


def fee_distance_tiered_ref(q, xc, xr, threshold, alpha, beta, margin, *,
                            coarse_cfg: dfl.DfloatConfig,
                            resid_cfg: dfl.DfloatConfig, seg, metric="l2"):
    """Tiered contract: decode both tiers (``xc`` (..., C, Wc), ``xr``
    (..., C, Wr)), concatenate them along the feature axis and score with the
    exact FEE arithmetic of :func:`fee_distance_ref` — bit-identical to
    :func:`fee_distance_packed_ref` over the parent layout's rows at any
    split.  Which residual words a lane fetches is a traffic property of the
    kernel; the arithmetic here is unconditional."""
    *lead, c, wc = xc.shape
    rows = math.prod(lead) * c
    x = dfloat_unpack_tiered_ref(xc.reshape(rows, wc),
                                 xr.reshape(rows, xr.shape[-1]),
                                 coarse_cfg, resid_cfg).reshape(*lead, c, -1)
    return fee_distance_ref(q, x, threshold, alpha, beta, margin,
                            seg=seg, metric=metric)


def fee_distance_tiered_gather_ref(xc, xr, ids, q, threshold, alpha, beta,
                                   margin, *, coarse_cfg: dfl.DfloatConfig,
                                   resid_cfg: dfl.DfloatConfig, seg,
                                   metric="l2", lane_mask=None):
    """Plain version of the batched ``fee_distance_tiered`` kernel over the
    tier rows ``xc[ids]`` and ``xr[ids]``."""
    i = ids.long()
    out = fee_distance_tiered_ref(q, xc[i], xr[i], threshold, alpha, beta,
                                  margin, coarse_cfg=coarse_cfg,
                                  resid_cfg=resid_cfg, seg=seg, metric=metric)
    return fold_lane_mask(out, lane_mask)


def dfloat_unpack_ref(packed, cfg: dfl.DfloatConfig, ids=None):
    """Plain version of the ``dfloat_unpack`` kernel (bit-exact decoder):
    rows ``ids`` ((C,) int64) of ``packed``, or all of them; an id that
    names no row decodes as zeros, as in the kernel."""
    if ids is None:
        return dfl.unpack_rows(packed, cfg)
    if not packed.shape[0]:
        return torch.zeros((ids.shape[0], cfg.dim), dtype=torch.float32,
                           device=packed.device)
    ok = (ids >= 0) & (ids < packed.shape[0])
    rows = dfl.unpack_rows(packed[torch.where(ok, ids, 0)], cfg)
    return torch.where(ok[:, None], rows, 0.0)


def frontier_ref(nodes, sel, adj, visited, width):
    """Plain version of the ``frontier`` kernel: one hop's frontier step,
    what ``core.search._hop_body`` does between the pop and the scoring.

    ``nodes``/``sel`` (Q, E) are the popped nodes and which pops are real,
    ``adj`` (N, M) the base adjacency, ``visited`` (Q, ceil(N/32)) int32
    words.  Returns (nbrs, safe, fresh, src), each (Q, width): the gathered
    ids deduped against ``visited`` and across the batch
    (``search.first_occurrence_mask``, both arms), in a stable fresh-first
    partition cut to ``width`` lanes (E == 1 keeps the E*M = M slots in
    order), with each lane's pop slot.  Overflowing fresh candidates are
    dropped unmarked (still discoverable through other parents on later
    hops); the kept fresh ids' bits are added to ``visited`` in place."""
    n_q, e = nodes.shape
    m = adj.shape[1]
    nbrs = adj[nodes.clamp(min=0).long()].reshape(n_q, e * m)
    valid = (nbrs >= 0) & sel.repeat_interleave(m, dim=1)
    safe = nbrs.clamp(min=0)
    seen = (torch.gather(visited, 1, (safe >> 5).long()) & search._bits(safe)) != 0
    fresh = valid & ~seen & search.first_occurrence_mask(safe, valid)
    if e > 1:
        keep = torch.argsort(fresh.to(torch.int8), dim=1, descending=True,
                             stable=True)[:, :width]
        nbrs, safe, fresh = (torch.gather(t, 1, keep) for t in (nbrs, safe, fresh))
        src = (keep // m).to(torch.int32)
    else:
        src = (torch.arange(e * m, device=nbrs.device, dtype=torch.int32) // m
               ).expand(n_q, -1)
    visited.scatter_add_(1, (safe >> 5).long(),
                         torch.where(fresh, search._bits(safe), 0))
    return nbrs, safe, fresh, src


def greedy_level(ids_l, adj_l, rows, queries, cur, *, metric: str):
    """One upper level's greedy walk for a whole query batch: each query
    moves to its nearest neighbour while that improves its distance (a
    query that stops improving is a fixed point of the step).  ``cur`` and
    the result are positions in the level; each step reads the rows it
    compares, by global id.  Returns the positions reached, the steps taken
    (each one a sync) and the moves of all queries together."""
    c = cur.long()
    d = fee_mod.exact_distance(queries, rows(ids_l[c])[:, None, :],
                               metric=metric)[:, 0]
    steps = moves = 0
    while True:
        steps += 1
        nb = adj_l[c].long()
        nd = fee_mod.exact_distance(queries, rows(ids_l[nb]), metric=metric)
        j = torch.argmin(nd, dim=1, keepdim=True)      # first minimum
        ndj = torch.gather(nd, 1, j)[:, 0]
        better = ndj < d
        moved = int(better.sum())
        if not moved:
            return c, steps, moves
        moves += moved
        c = torch.where(better, torch.gather(nb, 1, j)[:, 0], c)
        d = torch.minimum(ndj, d)


def level_start(ids_l, entries):
    """Each entry's position among a level's sorted ids, position 0 where
    an entry is not there."""
    pos = torch.searchsorted(ids_l, entries).clamp_(max=len(ids_l) - 1)
    return torch.where(ids_l[pos] == entries, pos, 0)


def descend_ref(levels, vectors, storage: str, dfloat_cfg, queries, metric: str):
    """Plain version of the ``descend`` kernel: greedy top-down routing
    through ``levels`` (a ``search.DeviceLevels``, read through its views)
    over the rows ``search.row_reader`` gives for ``storage``, every query
    of the batch through every step of a level.  A level's entries are
    found among its sorted ids by ``torch.searchsorted`` (position 0 where
    an entry is not there).  Returns (entries (Q,) int32, moves (L,) int32:
    a level's steps less one, the most moves any query made there, bottom
    level first)."""
    rows = search.row_reader(vectors, storage, dfloat_cfg)
    entries = torch.full((queries.shape[0],), levels.entry, dtype=torch.int32,
                         device=queries.device)
    moves = []
    for ids, adj in reversed(levels.levels):
        cur, n, _ = greedy_level(ids, adj, rows, queries, level_start(ids, entries),
                                 metric=metric)
        moves.append(n - 1)
        entries = ids[cur]
    return entries, torch.tensor(moves[::-1], dtype=torch.int32, device=queries.device)
