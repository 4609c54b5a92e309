"""Graph index construction (HNSW-style hierarchy over a pruned kNN base).

A CAGRA-style base layer — exact kNN graph + RNG/occlusion pruning — plus
HNSW-style sparse upper layers for entry-point routing, as in the JAX
package.  The products the JAX package leaves to numpy (the kNN score blocks
and the prune's pairwise distances) run as torch operations on ``device``:
at 1M rows one 4096-row block of kNN scores is 16 GB and the prune's per-row
loop is Python, so neither fits a host.  The RNG draws (long edges, level
subsampling) stay numpy with the same seed and call order, so on the same
vectors the levels agree with the JAX package's up to distance ties.

Matrix products are taken in full float32: the port never enables TF32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.utils import cached_npz


@dataclasses.dataclass
class GraphIndex:
    levels: list          # list of (node_ids (Nl,), adjacency (Nl, M) int32 into node_ids-local space)
    entry: int            # entry node id (global) = levels[-1].node_ids[0]
    m: int

    @property
    def base_adjacency(self) -> np.ndarray:
        return self.levels[0][1]

    @property
    def n(self) -> int:
        return self.levels[0][1].shape[0]


def _knn_adjacency(vectors: torch.Tensor, m: int, metric: str,
                   block_bytes: int = 1 << 32) -> np.ndarray:
    """Exact kNN lists (nearest first, no self loops) of the rows of a
    tensor, in row blocks whose (block, N) f32 score matrix stays under
    ``block_bytes``; scores use the JAX package's ``|x|^2 + |y|^2 - 2 x.y``."""
    n = vectors.shape[0]
    sq = (vectors ** 2).sum(1)
    block = max(1, block_bytes // (4 * n))
    out = []
    for s in range(0, n, block):
        e = min(s + block, n)
        dot = vectors[s:e] @ vectors.T
        if metric == "l2":
            scores = sq[s:e, None] + sq[None, :] - 2 * dot
        else:
            scores = -dot
        rows = torch.arange(e - s, device=vectors.device)
        scores[rows, rows + s] = float("inf")               # no self loops
        out.append(torch.topk(scores, m, dim=1, largest=False).indices)
    return torch.cat(out).to(torch.int32).cpu().numpy()


def _occlusion_prune(vectors: torch.Tensor, adj: np.ndarray, metric: str,
                     keep: int, block_bytes: int = 1 << 30) -> np.ndarray:
    """RNG-style pruning (NSG/CAGRA heuristic): drop neighbor j of p if an
    already-kept closer neighbor l occludes it, i.e. d(l, j) < d(p, j).
    Distances keep the JAX package's difference-of-squares form.  Each row
    keeps its first ``keep`` survivors in list order, backfilled with the
    nearest pruned neighbors."""
    n, m = adj.shape
    d = vectors.shape[1]
    adj_t = torch.as_tensor(adj, device=vectors.device).long()
    block = max(1, block_bytes // (4 * m * m * d))
    out = []
    for s in range(0, n, block):
        e = min(s + block, n)
        nb = vectors[adj_t[s:e]]                        # (b, M, D)
        p = vectors[s:e][:, None, :]
        if metric == "l2":
            d_pj = ((nb - p) ** 2).sum(-1)              # (b, M) sorted ascending
            d_ll = ((nb[:, :, None, :] - nb[:, None, :, :]) ** 2).sum(-1)
        else:
            d_pj = -(nb * p).sum(-1)
            d_ll = -torch.einsum("bmd,bnd->bmn", nb, nb)
        kept = torch.zeros((e - s, m), dtype=torch.bool, device=vectors.device)
        kept[:, 0] = True
        for j in range(1, m):
            # occluded if any kept l<j (closer to p) with d(l,j) < d(p,j)
            occ = (kept[:, :j] & (d_ll[:, :j, j] < d_pj[:, j: j + 1])).any(1)
            kept[:, j] = ~occ
        # kept neighbors first, then the pruned ones, each in list order
        order = torch.argsort((~kept).to(torch.int8), dim=1, stable=True)
        out.append(torch.gather(adj_t[s:e], 1, order[:, :keep]))
    return torch.cat(out).to(torch.int32).cpu().numpy()


def _add_long_edges(adj: np.ndarray, rng, n_long: int) -> np.ndarray:
    """NSW-style random long-range links: guarantees navigability on
    clustered data, where pure kNN graphs fragment into cluster islands."""
    n = adj.shape[0]
    longs = rng.integers(0, n, (n, n_long)).astype(np.int32)
    longs[longs == np.arange(n)[:, None]] = (longs[longs == np.arange(n)[:, None]] + 1) % n
    return np.concatenate([adj, longs], axis=1)


def build_graph(vectors: np.ndarray, m: int = 16, metric: str = "l2",
                prune: bool = True, upper_branch: int = 24,
                cache_key: str | None = None, seed: int = 0,
                long_edges: int | None = None, device="cuda") -> GraphIndex:
    device = resolve_device(device)
    n_long = max(2, m // 4) if long_edges is None else long_edges

    def _build():
        rng = np.random.default_rng(seed)
        x = torch.as_tensor(vectors, dtype=torch.float32, device=device)
        n = x.shape[0]
        base = _knn_adjacency(x, 2 * m if prune else m, metric)
        if prune:
            base = _occlusion_prune(x, base, metric, m)
        base = _add_long_edges(base, rng, n_long)
        out = {"adj0": base, "ids0": np.arange(n, dtype=np.int32)}
        # HNSW-style upper layers: geometric subsampling, kNN within layer
        ids = np.arange(n)
        lvl = 1
        while len(ids) > 4 * upper_branch:
            ids = np.sort(rng.choice(ids, max(len(ids) // 16, upper_branch), replace=False))
            ml = min(m, len(ids) - 1)
            adj = _knn_adjacency(x[torch.as_tensor(ids, device=x.device)], ml, metric)
            adj = _add_long_edges(adj, rng, min(n_long, len(ids) - 1))
            out[f"adj{lvl}"] = adj.astype(np.int32)
            out[f"ids{lvl}"] = ids.astype(np.int32)
            lvl += 1
        return out

    if cache_key is not None:
        data = cached_npz(f"torch/graph/{cache_key}/m{m}/{metric}/p{prune}/l{n_long}/v1",
                          _build)
    else:
        data = _build()
    levels = []
    lvl = 0
    while f"adj{lvl}" in data:
        levels.append((data[f"ids{lvl}"], data[f"adj{lvl}"]))
        lvl += 1
    entry = int(levels[-1][0][0])
    return GraphIndex(levels=levels, entry=entry, m=m)
