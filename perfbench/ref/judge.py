"""The judge: holds every answer of a window against the reference.

An answer is one query's ``k`` ids and distances.  The numbers compared:

  missing    answers due in the window that never came (limit 0)
  malformed  answers with an id outside the rows, an id twice, a distance
             that is not finite, or distances out of order (limit 0)
  gap_max    the widest relative gap between a returned distance and the
             reference's float64 distance of the same id
  gap_mean   the mean of those gaps
  recall_at_10  the share of each answer's first 10 ids among its query's
             exact first 10 (a floor: the number must be at least its
             limit), which a beam cut short, an early exit that prunes true
             neighbours or a lower ef move while every distance stays exact

A gap is ``|d - d_ref| / max(|d_ref|, s)``, ``s`` the median ``|d_ref|`` of
the answers judged.  Dfloat stores rows with a few mantissa bits, so a
sound answer's distances sit a little off the float64 ones; the limits of
``gap_*`` (in each configuration's file, which compares the numbers it
gives a limit) lie between what sound runs read and what the control (the
exact search in bfloat16) reads.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.ref import exact

NUMBERS = ("missing", "malformed", "gap_max", "gap_mean", "recall_at_10")
FLOORS = ("recall_at_10",)    # numbers held from below


def malformed_rows(ids: np.ndarray, dists: np.ndarray, n: int) -> np.ndarray:
    """(m,) bool: the answers that say nothing sound."""
    ids = np.asarray(ids)
    dists = np.asarray(dists, np.float64)
    bad = ((ids < 0) | (ids >= n)).any(1) | ~np.isfinite(dists).all(1)
    srt = np.sort(ids, axis=1)
    bad |= (srt[:, 1:] == srt[:, :-1]).any(1)
    bad |= (np.diff(dists, axis=1) < 0).any(1)
    return bad


def judge(rows: torch.Tensor, queries: torch.Tensor, qidx, ids, dists,
          metric: str, n_missing: int = 0, gt: np.ndarray | None = None,
          k: int = 10) -> dict:
    """The numbers of the answers ``(qidx, ids, dists)``: (m,), (m, k),
    (m, k) host arrays; ``rows``/``queries`` the raw float32 inputs on the
    device the reference runs on; ``gt`` the reference's exact ids of every
    query, nearest first (``recall_at_<k>`` is left out without it)."""
    ids = np.asarray(ids, np.int64)
    dists = np.asarray(dists, np.float64)
    bad = malformed_rows(ids, dists, rows.shape[0])
    good = ~bad
    out = dict(missing=int(n_missing), malformed=int(bad.sum()),
               gap_max=0.0, gap_mean=0.0)
    if gt is not None:
        out[f"recall_at_{k}"] = recall(ids, qidx, gt, k) if len(ids) else 0.0
    if good.any():
        ref = exact.distances(rows, queries, np.asarray(qidx)[good], ids[good],
                              metric).numpy()
        scale = max(float(np.median(np.abs(ref))), 1e-30)
        gap = np.abs(dists[good] - ref) / np.maximum(np.abs(ref), scale)
        out["gap_max"] = float(gap.max())
        out["gap_mean"] = float(gap.mean())
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, checks)``: each number the configuration holds (a key of
    ``limits``) beside its limit; correct when none is above its limit, or
    below it for a floor (``"at_least"`` in its check).  A number held that
    the run could not read (no answer to judge) fails."""
    checks = {}
    for k in NUMBERS:
        if k in limits:
            checks[k] = {"value": numbers.get(k), "limit": limits[k]}
            if k in FLOORS:
                checks[k]["at_least"] = True

    def holds(c):
        if c["value"] is None:
            return False
        return c["value"] >= c["limit"] if c.get("at_least") else c["value"] <= c["limit"]

    return all(holds(c) for c in checks.values()), checks


def recall(ids: np.ndarray, qidx, gt: np.ndarray, k: int) -> float:
    """Mean share of each answer's first ``k`` ids among its query's exact
    first ``k``."""
    ids = np.asarray(ids)[:, :k]
    truth = np.asarray(gt)[np.asarray(qidx), :k]
    hits = 0
    for s in range(0, len(ids), 1 << 16):
        a, b = ids[s: s + (1 << 16)], truth[s: s + (1 << 16)]
        hits += int((a[:, :, None] == b[:, None, :]).any(2).sum())
    return hits / max(1, ids.size)
