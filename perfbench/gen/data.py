"""Synthetic vector sets with a controlled eigen-spectrum, made on the
device from the seed.

A frozen copy of the statistics of the port's generator
(``repro_torch/data/synthetic.py``): covariance eigenvalues
``lambda_i ~ i^-decay``, Gaussian clusters of relative spread ``spread``,
the principal axes hidden by a random rotation, and queries drawn near
database rows (an evaluation pool and two held-out pools for the index's
offline fitting).  For an angular metric rows and queries are unit vectors.

A deployment serves one data set, as ANN-Benchmarks' sets are fixed: the
configuration's ``base_seed`` draws it.  The run's seed then turns rows and
queries by a random rotation of its own, which keeps every distance, so
every seed gives the index and the search the same work while no number of
the inputs repeats between seeds.  The draws come from ``torch.Generator``s
on ``device`` in a few large calls, so the same seed gives the same rows on
one kind of card.
"""
from __future__ import annotations

import dataclasses
import hashlib

import torch


@dataclasses.dataclass
class Vectors:
    rows: torch.Tensor          # (n, dim) float32
    queries: torch.Tensor       # (n_queries, dim) evaluation queries
    train: torch.Tensor         # (n_train, dim) held-out queries
    metric: str                 # "l2" | "ip"


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed from the run's seed and a stream name, so
    that the data, the query order and the arrivals draw independently."""
    h = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def _rotation(d: int, seed: int, name: str, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, name))
    return torch.linalg.qr(torch.randn(d, d, generator=g, dtype=torch.float32,
                                       device=device))[0]


def make_vectors(spec: dict, seed: int, device) -> Vectors:
    """Rows and queries of the configuration's ``data`` section ``spec``:
    ``n``, ``dim``, ``metric``, ``spectrum_decay``, ``n_clusters``,
    ``cluster_spread``, ``query_noise``, ``n_queries``, ``n_train`` and
    ``base_seed``, turned by the rotation of ``seed``."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(int(spec["base_seed"]), "data/" + spec["name"]))
    n, d = int(spec["n"]), int(spec["dim"])
    f32 = dict(dtype=torch.float32, device=device)
    lam = torch.arange(1, d + 1, dtype=torch.float64, device=device) ** (
        -float(spec["spectrum_decay"]))
    scale = (lam / lam.sum() * d).sqrt().to(torch.float32)
    basis = torch.linalg.qr(torch.randn(d, d, generator=g, **f32))[0]
    centers = torch.randn(int(spec["n_clusters"]), d, generator=g, **f32) * scale
    assign = torch.randint(0, centers.shape[0], (n,), generator=g, device=device)
    spread = float(spec["cluster_spread"])
    rows = centers[assign]
    rows += spread * (torch.randn(n, d, generator=g, **f32) * scale)
    n_q, n_t = int(spec["n_queries"]), int(spec["n_train"])
    pick = torch.randint(0, n, (n_q + n_t,), generator=g, device=device)
    noise = float(spec["query_noise"]) * spread
    queries = rows[pick] + noise * (
        torch.randn(n_q + n_t, d, generator=g, **f32) * scale)
    turn = basis.T @ _rotation(d, seed, "rotation/" + spec["name"], device)
    rows = rows @ turn                  # hide the principal axes, then turn
    queries = queries @ turn
    if spec["metric"] == "ip":
        rows /= rows.norm(dim=1, keepdim=True) + 1e-9
        queries /= queries.norm(dim=1, keepdim=True) + 1e-9
    return Vectors(rows=rows, queries=queries[:n_q].contiguous(),
                   train=queries[n_q:].contiguous(), metric=spec["metric"])
