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

The data-aware neighbour-list mapping (``map_owners``, ``build_dam``) is the
JAX package's numpy, copied: the ndpsim backend maps vectors to DIMM
sub-channels with it.
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
    nearest pruned neighbors.  The keep decisions are sequential in the list
    position; for host tensors (one streaming insert's few dozen candidates)
    they run as numpy steps, which cost a fraction of torch's per-operation
    dispatch, and on the device beside the distances."""
    n, m = adj.shape
    d = vectors.shape[1]
    on_host = vectors.device.type == "cpu"
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
        if on_host:
            d_pj, d_ll = d_pj.numpy(), d_ll.numpy()
            kept = np.zeros((e - s, m), bool)
        else:
            kept = torch.zeros((e - s, m), dtype=torch.bool, device=vectors.device)
        kept[:, 0] = True
        for j in range(1, m):
            # occluded if any kept l<j (closer to p) with d(l,j) < d(p,j)
            occ = (kept[:, :j] & (d_ll[:, :j, j] < d_pj[:, j: j + 1])).any(1)
            kept[:, j] = ~occ
        # kept neighbors first, then the pruned ones, each in list order
        kept = torch.as_tensor(kept, device=vectors.device)
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


def upper_levels(x: torch.Tensor, m: int, metric: str, rng, n_long: int,
                 upper_branch: int = 24) -> list:
    """HNSW-style upper levels over the rows ``x``: geometric subsampling (a
    sixteenth of the level below, at least ``upper_branch`` ids) while a
    level holds more than ``4 * upper_branch`` ids, each with its exact kNN
    lists and ``rng``'s long edges.  Returns [(sorted ids, level-local
    adjacency), ...] as int32, level 1 first."""
    out = []
    ids = np.arange(x.shape[0])
    while len(ids) > 4 * upper_branch:
        ids = np.sort(rng.choice(ids, max(len(ids) // 16, upper_branch), replace=False))
        ml = min(m, len(ids) - 1)
        adj = _knn_adjacency(x[torch.as_tensor(ids, device=x.device)], ml, metric)
        adj = _add_long_edges(adj, rng, min(n_long, len(ids) - 1))
        out.append((ids.astype(np.int32), adj.astype(np.int32)))
    return out


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
        for lvl, (ids, adj) in enumerate(upper_levels(x, m, metric, rng, n_long,
                                                      upper_branch), 1):
            out[f"adj{lvl}"], out[f"ids{lvl}"] = adj, ids
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


# ---------------------------------------------------------------------------
# incremental repair (streaming mutation — repro_torch.streaming)
# ---------------------------------------------------------------------------


def prune_candidates(p_vec: np.ndarray, cand_ids: np.ndarray,
                     cand_vecs: np.ndarray, metric: str,
                     keep: int) -> np.ndarray:
    """Occlusion-prune one node's candidate neighborhood.

    ``cand_ids``/``cand_vecs`` must be sorted ascending by distance to
    ``p_vec`` (beam-search output order).  Reuses :func:`_occlusion_prune` on
    a local id remap — slot 0 is the node itself, slots 1..C the candidates —
    so incremental inserts and delete repairs apply the exact same RNG
    heuristic (including the nearest-pruned backfill) as the offline build.
    One node's prune is a few dozen rows: it runs on CPU tensors, since a
    device would pay a launch per step and a sync per row.  Returns up to
    ``keep`` global ids.
    """
    c = len(cand_ids)
    if c == 0:
        return np.empty(0, np.int32)
    local_vecs = torch.from_numpy(
        np.concatenate([p_vec[None], cand_vecs]).astype(np.float32))
    local_adj = np.arange(1, c + 1, dtype=np.int32)[None]
    kept = _occlusion_prune(local_vecs, local_adj, metric, min(keep, c))[0]
    kept = kept[kept > 0] - 1
    return np.asarray(cand_ids, np.int32)[kept]


# ---------------------------------------------------------------------------
# DaM — data-aware neighbor-list mapping (paper §V-C2, Fig. 12)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DaMPartition:
    """Per-sub-channel partitioned index.

    owner[v]            sub-channel owning vector v
    local_ids[c]        global ids owned by channel c (its vector shard order)
    local_of[v]         position of v within its owner's shard
    part_adj[c]         (N, Mc) int32: for EVERY node v, the members of v's
                        neighbor list owned by channel c, as LOCAL slots into
                        channel c's vector shard; -1 padded.  This is the
                        NLT+partitioned-list structure of Fig. 12 in dense,
                        fixed-width (shard_map-able) form.
    """
    n_channels: int
    owner: np.ndarray
    local_ids: list
    local_of: np.ndarray
    part_adj: list

    def max_part_width(self) -> int:
        return max(a.shape[1] for a in self.part_adj)


def map_owners(n: int, n_channels: int, policy: str = "shuffle", seed: int = 0,
               assign_hint: np.ndarray | None = None) -> np.ndarray:
    """Vector->sub-channel ownership.

    shuffle    round-robin over a random permutation (paper §VI-C7: datasets
               are shuffled for balance)
    contiguous block partition (the unshuffled 'Wiki' case — preserves
               insertion locality, worse balance)
    """
    if policy == "shuffle":
        rng = np.random.default_rng(seed)
        perm = rng.permutation(n)
        owner = np.empty(n, np.int32)
        owner[perm] = np.arange(n) % n_channels
        return owner
    if policy == "contiguous":
        return (np.arange(n) * n_channels // n).astype(np.int32)
    raise ValueError(policy)


def build_dam(adj: np.ndarray, owner: np.ndarray, n_channels: int,
              pad_width: int | None = None) -> DaMPartition:
    n, m = adj.shape
    local_ids = [np.where(owner == c)[0].astype(np.int32) for c in range(n_channels)]
    local_of = np.empty(n, np.int64)
    for c, ids in enumerate(local_ids):
        local_of[ids] = np.arange(len(ids))
    nb_owner = owner[adj]                                    # (N, M)
    width = pad_width or int(max(1, (nb_owner == np.arange(n_channels)[:, None, None]).sum(2).max()))
    part_adj = []
    for c in range(n_channels):
        mask = nb_owner == c
        pa = np.full((n, width), -1, np.int32)
        rows, cols = np.nonzero(mask)
        # stable position within row
        pos = np.zeros(len(rows), np.int64)
        if len(rows):
            change = np.r_[True, rows[1:] != rows[:-1]]
            idx_start = np.flatnonzero(change)
            pos = np.arange(len(rows)) - np.repeat(np.arange(len(rows))[idx_start], np.diff(np.r_[idx_start, len(rows)]))
        pa[rows, pos] = local_of[adj[rows, cols]]
        part_adj.append(pa)
    return DaMPartition(n_channels, owner.astype(np.int32), local_ids, local_of, part_adj)
