"""Synthetic vector databases with controlled eigen-spectra.

SIFT/GIST/GloVe/Wiki/MS_MARCO/BigANN are modeled by generators matched on
the axes that matter for NasZip: dimensionality and metric, covariance
spectrum decay (drives alpha_k / FEE effectiveness), cluster structure
(graph locality) and a near-DB query distribution (as in ANN-benchmarks).

Unlike the JAX package, the per-dataset seed offset is a stable hash of the
name (``zlib.crc32``), so the same ``seed`` gives the same data in every
process.  Ground truth is computed on ``device`` (a (10k x 1M) score matrix
does not fit a host): the card by default, the host only when the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.utils import cached_npz


@dataclasses.dataclass
class VecDB:
    name: str
    vectors: np.ndarray   # (N, D) f32
    queries: np.ndarray   # (Q, D) f32
    train_queries: np.ndarray  # (Qt, D) held-out, for offline fitting
    metric: str           # "l2" | "ip"
    gt: np.ndarray        # (Q, K) exact top-K ids

    @property
    def n(self):
        return self.vectors.shape[0]

    @property
    def dim(self):
        return self.vectors.shape[1]


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n: int
    dim: int
    metric: str
    spectrum_decay: float   # lambda_i ~ i^-decay  (higher => steeper => FEE-friendlier)
    n_clusters: int
    cluster_spread: float   # relative within-cluster scale
    n_queries: int = 256
    gt_k: int = 100


DATASETS = {
    "sift": DatasetSpec("sift", 40_000, 128, "l2", 0.9, 64, 0.5),
    "gist": DatasetSpec("gist", 12_000, 960, "l2", 1.4, 48, 0.4),
    "bigann": DatasetSpec("bigann", 60_000, 128, "l2", 0.9, 96, 0.5),
    "glove": DatasetSpec("glove", 30_000, 100, "ip", 0.6, 64, 0.7),
    "wiki": DatasetSpec("wiki", 20_000, 768, "l2", 1.2, 24, 0.35),
    "msmarco": DatasetSpec("msmarco", 30_000, 384, "l2", 1.1, 64, 0.45),
    # the shape of ann-benchmarks sift-128-euclidean (SIFT1M: 1M base vectors,
    # 10k queries, top-100 ground truth) with the "sift" spectrum and clusters
    "sift1m": DatasetSpec("sift1m", 1_000_000, 128, "l2", 0.9, 64, 0.5,
                          n_queries=10_000, gt_k=100),
    # tiny configs for tests
    "unit": DatasetSpec("unit", 2_000, 64, "l2", 1.0, 8, 0.5, n_queries=64, gt_k=32),
    "unit_ip": DatasetSpec("unit_ip", 2_000, 64, "ip", 0.8, 8, 0.6, n_queries=64, gt_k=32),
}


def _generate(spec: DatasetSpec, seed: int = 0, device="cuda") -> dict:
    device = resolve_device(device)
    rng = np.random.default_rng(seed + zlib.crc32(spec.name.encode()) % (2**31))
    d, n = spec.dim, spec.n
    lam = np.arange(1, d + 1, dtype=np.float64) ** (-spec.spectrum_decay)
    lam /= lam.sum()
    scale = np.sqrt(lam * d).astype(np.float32)
    basis = np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)

    centers = rng.standard_normal((spec.n_clusters, d)).astype(np.float32) * scale
    assign = rng.integers(0, spec.n_clusters, n)
    pts = centers[assign] + spec.cluster_spread * (
        rng.standard_normal((n, d)).astype(np.float32) * scale
    )
    vectors = pts @ basis.T  # hide the principal axes (PCA must find them)

    nq_all = spec.n_queries * 3  # eval + train pools
    qi = rng.integers(0, n, nq_all)
    queries = vectors[qi] + 0.25 * spec.cluster_spread * (
        rng.standard_normal((nq_all, d)).astype(np.float32) * scale
    ) @ basis.T
    if spec.metric == "ip":
        vectors /= np.linalg.norm(vectors, axis=1, keepdims=True) + 1e-9
        queries /= np.linalg.norm(queries, axis=1, keepdims=True) + 1e-9

    gt = exact_topk(vectors, queries[: spec.n_queries], spec.gt_k, spec.metric,
                    device=device)
    return dict(vectors=vectors, queries=queries, gt=gt.astype(np.int32))


def exact_topk(db, queries, k: int, metric: str, device="cuda",
               block_bytes: int = 1 << 30) -> np.ndarray:
    """Blocked exact kNN (the recall ground-truth oracle) on ``device``.

    ``db``/``queries`` are numpy arrays or tensors.  Query blocks are sized
    so one (block, N) f32 score matrix stays under ``block_bytes``; scores
    use the JAX package's formula ``|q|^2 + |x|^2 - 2 q.x`` (ip: ``-q.x``).
    Returns (Q, k) int64 ids, nearest first.
    """
    device = resolve_device(device)
    db = torch.as_tensor(db, device=device)
    queries = torch.as_tensor(queries, device=device)
    n = db.shape[0]
    xn = (db ** 2).sum(1)[None, :]
    qb = max(1, block_bytes // (4 * n))
    out = []
    for s in range(0, queries.shape[0], qb):
        qs = queries[s: s + qb]
        dot = qs @ db.T
        if metric == "l2":
            scores = (qs ** 2).sum(1, keepdim=True) + xn - 2 * dot
        else:
            scores = -dot
        out.append(torch.topk(scores, k, dim=1, largest=False).indices)
    return torch.cat(out).cpu().numpy()


def make_dataset(name: str | DatasetSpec, seed: int = 0, device="cuda",
                 cache: bool = True) -> VecDB:
    """The dataset ``name`` (a key of :data:`DATASETS`, or a spec), cached
    under ``.cache/`` unless ``cache=False``; its ground truth is computed on
    ``device``."""
    device = resolve_device(device)
    spec = DATASETS[name] if isinstance(name, str) else name
    build = lambda: _generate(spec, seed, device)
    data = (cached_npz(f"torch/dataset/{spec.name}/v1/{seed}/{spec}", build)
            if cache else build())
    nq = spec.n_queries
    return VecDB(
        name=spec.name,
        vectors=data["vectors"],
        queries=data["queries"][:nq],
        train_queries=data["queries"][nq:],
        metric=spec.metric,
        gt=data["gt"],
    )


def recall_at_k(found_ids: np.ndarray, gt: np.ndarray, k: int) -> float:
    """recall@k = |found ∩ gt_k| / k, averaged over queries."""
    hits = 0
    for f, g in zip(found_ids[:, :k], gt[:, :k]):
        hits += len(set(f.tolist()) & set(g.tolist()))
    return hits / (k * len(gt))
