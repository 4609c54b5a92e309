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

The base level's kNN lists come from one of two builds (``knn``): the exact
scan of every row against every row (``"exact"``, O(N^2) products: 1.9e16
FLOP at ten million rows), or ``"partitioned"``, which splits the rows into
k-means lists of about :data:`LIST_ROWS` rows, puts each row in its
:data:`LIST_PROBES` nearest lists, takes exact kNN inside each list and
merges each row's candidates (:func:`_partitioned_knn`).  The prune, the
long edges and the upper levels are the same after either.

The data-aware neighbour-list mapping (``map_owners``, ``build_dam``) is the
JAX package's numpy, copied: the ndpsim backend maps vectors to DIMM
sub-channels with it.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.utils import cached_npz


@dataclasses.dataclass
class GraphIndex:
    levels: list          # list of (node_ids (Nl,), adjacency (Nl, M) int32 into node_ids-local space)
    entry: int            # entry node id (global) = levels[-1].node_ids[0]
    m: int
    # the build's seconds by phase and, for a partitioned build, the share
    # of the exact lists it found; empty for a graph read back from the
    # cache, or made elsewhere
    timings: dict = dataclasses.field(default_factory=dict)

    @property
    def base_adjacency(self) -> np.ndarray:
        return self.levels[0][1]

    @property
    def n(self) -> int:
        return self.levels[0][1].shape[0]


KNN_BUILDS = ("exact", "partitioned")
# The partitioned build: rows a list on average (C = ceil(N / LIST_ROWS)
# lists), the lists each row joins, Lloyd rounds, sampled rows a list that
# train the k-means, and the rows whose lists are checked against an exact
# scan (``knn_recall``).
LIST_ROWS = 2048
LIST_PROBES = 5
KMEANS_ROUNDS = 10
KMEANS_SAMPLE = 64
RECALL_ROWS = 10_000
# a list's padded size is a multiple of this (lists of one padded size are
# scored together)
_LIST_PAD = 64


def _knn_scores(vectors: torch.Tensor, k: int, metric: str,
                block_bytes: int = 1 << 32, rows: torch.Tensor | None = None):
    """Exact kNN of rows of a tensor against all its rows, self excluded:
    ``(scores, ids)``, each (R, k) on its device, nearest first, for the
    rows ``rows`` (an int64 id tensor; default every row in order).  Row
    blocks keep the (block, N) f32 score matrix under ``block_bytes``;
    scores are the JAX package's ``|x|^2 + |y|^2 - 2 x.y`` (ip: ``-x.y``)."""
    n = vectors.shape[0]
    n_q = n if rows is None else rows.shape[0]
    sq = (vectors ** 2).sum(1)
    block = max(1, block_bytes // (4 * n))
    vals, ids = [], []
    for s in range(0, n_q, block):
        e = min(s + block, n_q)
        if rows is None:
            own = torch.arange(s, e, device=vectors.device)
            q, sq_q = vectors[s:e], sq[s:e]
        else:
            own = rows[s:e]
            q, sq_q = vectors[own], sq[own]
        dot = q @ vectors.T
        if metric == "l2":
            scores = sq_q[:, None] + sq[None, :] - 2 * dot
        else:
            scores = -dot
        scores[torch.arange(e - s, device=vectors.device), own] = float("inf")
        v, i = torch.topk(scores, k, dim=1, largest=False)
        vals.append(v)
        ids.append(i)
    return torch.cat(vals), torch.cat(ids)


def _knn_adjacency(vectors: torch.Tensor, m: int, metric: str,
                   block_bytes: int = 1 << 32) -> np.ndarray:
    """Exact kNN lists (nearest first, no self loops) of the rows of a
    tensor (:func:`_knn_scores` over every row), as host int32."""
    return _knn_scores(vectors, m, metric, block_bytes)[1].to(torch.int32).cpu().numpy()


def _nearest_centroids(x: torch.Tensor, cent: torch.Tensor, r: int,
                       block_bytes: int = 1 << 30) -> torch.Tensor:
    """(N, r) int64: each row's ``r`` nearest centroids in L2, nearest
    first (the row's own ``|x|^2`` is left out: it ranks nothing)."""
    sq_c = (cent ** 2).sum(1)
    block = max(1, block_bytes // (4 * cent.shape[0]))
    out = []
    for s in range(0, x.shape[0], block):
        scores = sq_c[None, :] - 2 * (x[s: s + block] @ cent.T)
        out.append(torch.topk(scores, r, dim=1, largest=False).indices)
    return torch.cat(out)


def _kmeans(x: torch.Tensor, c: int, rng) -> torch.Tensor:
    """(c, D) f32 centroids of ``KMEANS_ROUNDS`` Lloyd rounds in L2 over a
    sample of ``KMEANS_SAMPLE * c`` rows drawn by ``rng``, started from
    ``c`` of them.  The assignments run on the rows' device; the means are
    float64 sums on the host in sample order, so the centroids do not
    depend on the order of a device's atomic adds.  A list that draws no
    row keeps its centroid."""
    n, d = x.shape
    sample = np.sort(rng.choice(n, min(n, KMEANS_SAMPLE * c), replace=False))
    xs = x[torch.as_tensor(sample, device=x.device)]
    xs_host = xs.double().cpu().numpy()
    cent = xs_host[np.sort(rng.choice(len(sample), c, replace=False))]
    for _ in range(KMEANS_ROUNDS):
        near = _nearest_centroids(
            xs, torch.as_tensor(cent, dtype=torch.float32, device=x.device), 1)
        a = near[:, 0].cpu().numpy()
        count = np.bincount(a, minlength=c)
        sums = np.stack([np.bincount(a, weights=xs_host[:, j], minlength=c)
                         for j in range(d)], axis=1)
        live = count > 0
        cent = cent.copy()
        cent[live] = sums[live] / count[live, None]
    return torch.as_tensor(cent, dtype=torch.float32, device=x.device)


def _list_knn(x: torch.Tensor, sq: torch.Tensor, members: torch.Tensor,
              count: torch.Tensor, k: int, metric: str):
    """Exact kNN inside a batch of lists of one padded size: ``members``
    (B, S) global row ids (anything past a list's ``count`` is padding).
    Returns ``(scores, ids)``, (B, S, k), nearest first; a slot with fewer
    than ``k`` other members reads ``inf`` and -1 past them."""
    b, size = members.shape
    slot = torch.arange(size, device=x.device)
    pad = slot[None, :] >= count[:, None]                  # (B, S)
    xb = x[members]                                        # (B, S, D)
    dot = torch.bmm(xb, xb.transpose(1, 2))
    if metric == "l2":
        sqb = sq[members]
        # (|x|^2 + |y|^2) - 2 x.y, as the exact scan computes it
        scores = sqb[:, :, None] + sqb[:, None, :]
        scores.sub_(dot.mul_(2))
    else:
        scores = dot.neg_()
    del dot
    scores.masked_fill_(pad[:, None, :], float("inf"))
    scores.diagonal(dim1=1, dim2=2).fill_(float("inf"))   # no self loops
    v, j = torch.topk(scores, min(k, size), dim=2, largest=False)
    del scores
    ids = torch.gather(members, 1, j.reshape(b, -1)).reshape(j.shape)
    ids = ids.masked_fill(torch.isinf(v), -1)
    if v.shape[2] < k:
        fill = (b, size, k - v.shape[2])
        v = torch.cat([v, v.new_full(fill, float("inf"))], 2)
        ids = torch.cat([ids, ids.new_full(fill, -1)], 2)
    return v, ids


def _merge_candidates(v: torch.Tensor, ids: torch.Tensor, k: int):
    """Each row's ``k`` nearest of its candidates ``(v, ids)`` ((R, C)
    scores and ids, -1 for none): an id found in several lists counts once
    (its first copy in list order); ties go to the lower id."""
    ids, order = torch.sort(ids, dim=1, stable=True)
    v = torch.gather(v, 1, order)
    dup = torch.zeros_like(ids, dtype=torch.bool)
    dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
    v = v.masked_fill(dup | (ids < 0), float("inf"))
    v, order = torch.sort(v, dim=1, stable=True)
    ids = torch.gather(ids, 1, order[:, :k])
    return v[:, :k], ids.masked_fill(torch.isinf(v[:, :k]), -1)


def _partitioned_knn(x: torch.Tensor, k: int, metric: str, seed: int,
                     block_bytes: int = 1 << 32) -> torch.Tensor:
    """kNN lists (nearest first, no self loops, no repeats) of the rows of
    ``x`` from a partition: (N, k) int64 on its device.

    The rows are split into C = ceil(N / LIST_ROWS) lists by seeded k-means
    (:func:`_kmeans`, L2 for either metric: it only finds candidates), and
    each row joins its r = min(LIST_PROBES, C) nearest lists.  Inside each
    list the exact kNN of every member among the members comes from batched
    products over lists of one padded size (scores as the exact scan's);
    a list too large to batch (one list's scores over ``block_bytes``)
    takes the exact scan of its rows (:func:`_knn_scores`).  Each row then
    keeps the ``k`` nearest of the candidates its lists gave it, each id
    once.  A row whose lists hold fewer than ``k`` other rows takes the
    exact scan.  With one list (N <= LIST_ROWS) this is the exact scan.

    The build is a function of the rows and ``seed``, and it does not move
    when an axis of the rows changes sign: every score, k-means assignment
    and mean is made of products ``x_a * y_a`` and sums, and flipping the
    sign of axis ``a`` in both factors leaves each product's bits, and so
    every sum and choice, as they were (a graph cached for one seed's rows
    serves another's, which differ from it by such flips)."""
    n = x.shape[0]
    dev = x.device
    c = -(-n // LIST_ROWS)
    if c == 1:
        return _knn_scores(x, k, metric, block_bytes)[1]
    r = min(LIST_PROBES, c)
    lists = _nearest_centroids(x, _kmeans(x, c, np.random.default_rng(seed)), r)
    # entries (row, probe) grouped by list, rows ascending within a list
    order = torch.sort(lists.reshape(-1), stable=True).indices
    member = order // r
    count = torch.bincount(lists.reshape(-1), minlength=c)
    start = torch.cumsum(count, 0) - count
    count_h, start_h = count.cpu().numpy(), start.cpu().numpy()
    cand_v = torch.empty((n * r, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((n * r, k), dtype=torch.int64, device=dev)
    sq = (x ** 2).sum(1)

    padded = -(-np.maximum(count_h, 1) // _LIST_PAD) * _LIST_PAD
    for size in np.unique(padded):
        group = np.flatnonzero(padded == size)
        per = max(1, block_bytes // (4 * int(size) * int(size)))
        if per == 1:
            for li in group:
                s, cnt = int(start_h[li]), int(count_h[li])
                rows = member[s: s + cnt]
                cand_v[s: s + cnt], cand_i[s: s + cnt] = float("inf"), -1
                if cnt > 1:
                    kk = min(k, cnt - 1)
                    cand_v[s: s + cnt, :kk], j = _knn_scores(x[rows], kk, metric,
                                                             block_bytes)
                    cand_i[s: s + cnt, :kk] = rows[j]
            continue
        slot = torch.arange(int(size), device=dev)
        for g in range(0, len(group), per):
            li = torch.as_tensor(group[g: g + per], device=dev)
            pos = start[li][:, None] + slot[None, :]
            live = slot[None, :] < count[li][:, None]
            pos = torch.where(live, pos, 0)
            v, i = _list_knn(x, sq, member[pos], count[li], k, metric)
            cand_v[pos[live]], cand_i[pos[live]] = v[live], i[live]

    # each row's r entries, merged
    where = torch.empty_like(order)
    where[order] = torch.arange(n * r, device=dev)
    where = where.view(n, r)
    out = torch.empty((n, k), dtype=torch.int64, device=dev)
    step = max(1, (1 << 28) // (r * k * 12))
    for s in range(0, n, step):
        p = where[s: s + step]
        v = cand_v[p].reshape(p.shape[0], -1)
        i = cand_i[p].reshape(p.shape[0], -1)
        if r > 1:
            v, i = _merge_candidates(v, i, k)
        out[s: s + step] = i
    short = torch.nonzero((out < 0).any(1)).flatten()
    if len(short):
        out[short] = _knn_scores(x, k, metric, block_bytes, rows=short)[1]
    return out


def knn_recall(x: torch.Tensor, ids: torch.Tensor, metric: str, seed: int,
               n_rows: int = RECALL_ROWS) -> float:
    """The share of the exact ``k``-NN (``k`` = ``ids.shape[1]``) that the
    lists ``ids`` ((N, k) on the rows' device) hold, over ``n_rows`` rows
    drawn by ``seed`` and checked against an exact scan of every row."""
    n, k = ids.shape
    rng = np.random.default_rng(seed)
    rows = torch.as_tensor(np.sort(rng.choice(n, min(n, n_rows), replace=False)),
                           device=x.device)
    exact = _knn_scores(x, k, metric, rows=rows)[1]
    found = (ids[rows][:, :, None] == exact[:, None, :]).any(2)
    return float(found.sum()) / exact.numel()


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
                long_edges: int | None = None, device="cuda",
                knn: str = "exact") -> GraphIndex:
    """The pruned kNN base level with its long edges and the upper levels.
    ``knn`` picks the base level's kNN build (:data:`KNN_BUILDS`).  The
    graph's ``timings`` hold each phase's seconds (``knn_s``, ``prune_s``,
    ``levels_s``) and, for the partitioned build, ``knn_recall``
    (:func:`knn_recall`), on the build that measured them: a graph read
    back from the cache has none."""
    if knn not in KNN_BUILDS:
        raise ValueError(f"knn={knn!r}; expected one of {KNN_BUILDS}")
    device = resolve_device(device)
    n_long = max(2, m // 4) if long_edges is None else long_edges

    def _build():
        rng = np.random.default_rng(seed)
        x = torch.as_tensor(vectors, dtype=torch.float32, device=device)
        n = x.shape[0]
        k = 2 * m if prune else m
        t = {}
        t0 = time.perf_counter()
        if knn == "exact":
            base = _knn_adjacency(x, k, metric)
        else:
            ids = _partitioned_knn(x, k, metric, seed)
            base = ids.to(torch.int32).cpu().numpy()
        t["knn_s"] = time.perf_counter() - t0
        if knn != "exact":
            t["knn_recall"] = knn_recall(x, ids, metric, seed)
            del ids
        t0 = time.perf_counter()
        if prune:
            base = _occlusion_prune(x, base, metric, m)
        base = _add_long_edges(base, rng, n_long)
        t["prune_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = {"adj0": base, "ids0": np.arange(n, dtype=np.int32)}
        for lvl, (ids, adj) in enumerate(upper_levels(x, m, metric, rng, n_long,
                                                      upper_branch), 1):
            out[f"adj{lvl}"], out[f"ids{lvl}"] = adj, ids
        t["levels_s"] = time.perf_counter() - t0
        timings.update(t)
        return out

    timings = {}
    if cache_key is not None:
        part = "" if knn == "exact" else f"/knn-{knn}"
        data = cached_npz(f"torch/graph/{cache_key}/m{m}/{metric}/p{prune}/l{n_long}{part}/v1",
                          _build)
    else:
        data = _build()
    levels = []
    lvl = 0
    while f"adj{lvl}" in data:
        levels.append((data[f"ids{lvl}"], data[f"adj{lvl}"]))
        lvl += 1
    entry = int(levels[-1][0][0])
    return GraphIndex(levels=levels, entry=entry, m=m, timings=timings)


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
