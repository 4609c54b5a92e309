"""Exact nearest neighbours and exact distances, in plain PyTorch.

``topk`` is the ground truth: a blocked float32 scan of every row (the
``|q|^2 + |x|^2 - 2 q.x`` expansion for L2, ``-q.x`` for inner product),
whose best ``k + RERANK`` candidates are re-ranked by their float64
distances, so that the expansion's rounding cannot reorder near ties.
``distances`` gives the float64 distance of chosen rows, the number every
returned distance is held against.  Both run on the device of the rows
they are given, in blocks; float32 products run with TF32 off.
"""
from __future__ import annotations

import torch

RERANK = 16
BLOCK_BYTES = 1 << 30


def _f64_dist(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """Distances of ``q`` (..., d) to ``x`` (..., d), float64, directly
    (no expansion): ``sum (q - x)^2`` for L2, ``-q.x`` for inner product."""
    q, x = q.double(), x.double()
    if metric == "l2":
        return ((q - x) ** 2).sum(-1)
    return -(q * x).sum(-1)


def topk(rows: torch.Tensor, queries: torch.Tensor, k: int, metric: str,
         block_bytes: int = BLOCK_BYTES) -> torch.Tensor:
    """(Q, k) int64 ids of each query's ``k`` nearest rows, nearest first,
    ties to the lower id."""
    n = rows.shape[0]
    kk = min(n, k + RERANK)
    xn = (rows * rows).sum(1)
    qb = max(1, block_bytes // (4 * n))
    out = []
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for s in range(0, queries.shape[0], qb):
            q = queries[s: s + qb]
            dot = q @ rows.T
            score = -dot if metric == "ip" else (q * q).sum(1, keepdim=True) + xn - 2 * dot
            del dot
            cand = torch.topk(score, kk, dim=1, largest=False).indices
            del score
            d = _f64_dist(q[:, None, :], rows[cand], metric)
            # stable sort by (distance, id): ids ascending first, then distance
            cand, order = cand.sort(dim=1)
            d = torch.gather(d, 1, order)
            order = torch.sort(d, dim=1, stable=True).indices[:, :k]
            out.append(torch.gather(cand, 1, order))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return torch.cat(out) if out else torch.empty(0, k, dtype=torch.int64)


def distances(rows: torch.Tensor, queries: torch.Tensor, qidx, ids,
              metric: str, block: int = 1 << 18) -> torch.Tensor:
    """float64 distances of ``queries[qidx[i]]`` to ``rows[ids[i, j]]`` for
    an (m,) ``qidx`` and an (m, k) ``ids`` (host or device tensors); ids
    outside ``[0, n)`` read as nan.  Returned on the host."""
    qidx = torch.as_tensor(qidx, dtype=torch.int64)
    ids = torch.as_tensor(ids, dtype=torch.int64)
    m, k = ids.shape
    n = rows.shape[0]
    out = torch.empty(m, k, dtype=torch.float64)
    step = max(1, block // max(k, 1))
    for s in range(0, m, step):
        i = ids[s: s + step].to(rows.device)
        ok = (i >= 0) & (i < n)
        q = queries[qidx[s: s + step].to(rows.device)]
        d = _f64_dist(q[:, None, :], rows[i.clamp(0, n - 1)], metric)
        out[s: s + step] = torch.where(ok, d, float("nan")).cpu()
    return out


def control_topk(rows: torch.Tensor, queries: torch.Tensor, k: int,
                 metric: str, block_bytes: int = BLOCK_BYTES):
    """The control: the exact search computed in bfloat16, the precision
    below the data's float32.  Returns ``(ids, dists)`` (Q, k) on the host,
    the distances as bfloat16 computes them."""
    xb = rows.to(torch.bfloat16)
    xn = (xb * xb).sum(1)
    qb = max(1, block_bytes // (2 * rows.shape[0]))
    ids, dists = [], []
    for s in range(0, queries.shape[0], qb):
        q = queries[s: s + qb].to(torch.bfloat16)
        dot = q @ xb.T
        score = -dot if metric == "ip" else (q * q).sum(1, keepdim=True) + xn - 2 * dot
        d, i = torch.topk(score.float(), k, dim=1, largest=False)
        ids.append(i.cpu())
        dists.append(d.cpu())
    return torch.cat(ids), torch.cat(dists)
