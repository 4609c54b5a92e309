"""Typed public surface of the Index API: the JAX package's names and fields.

:class:`IndexSpec` describes how an index is built, :class:`SearchParams`
how it is queried (the same fields and ``fee_backend`` strings, so a
reference ``SearchParams`` works unchanged), :class:`SearchResult` what every
search returns, and :class:`FeeFit` the host record of the alpha/beta fit.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.fee import FeeParams
from repro_torch.core.search import SearchConfig
from repro_torch.data.synthetic import recall_at_k


def _auto_seg(dim: int) -> int:
    """Largest FEE segment width <= 16 that divides ``dim`` (16 preferred)."""
    if dim % 16 == 0:
        return 16
    return max(s for s in range(1, 17) if dim % s == 0)


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """Frozen build recipe: everything ``Index.build`` needs besides the DB."""

    metric: str = "l2"                        # "l2" | "ip"
    seg: int = 16                             # FEE checkpoint granularity
    m: int = 16                               # graph degree
    p_target: float = 0.9                     # FEE Chebyshev budget (Eq. 5/6)
    dfloat_recall_target: float | None = 0.9  # None -> keep fp32
    recall_k: int = 10                        # k used by the Dfloat proxy
    ef_fit: int = 64                          # ef used by the Dfloat recall fn
    dfloat_proxy: bool = False                # exact-topk proxy vs graph search
    prune: bool = True                        # RNG/occlusion prune base layer
    seed: int = 0
    tier_split: int | None = None             # coarse-tier FEE segments for
                                              # storage="tiered": None = auto
                                              # (energy split), 0 / n_segs =
                                              # the degenerate splits
    knn: str = "exact"                        # base-level kNN build: "exact"
                                              # | "partitioned" (core/graph.py)

    @classmethod
    def for_db(cls, db, **overrides) -> "IndexSpec":
        """Spec matched to a VecDB: metric from the DB, seg dividing its dim."""
        base = dict(metric=db.metric, seg=_auto_seg(db.dim))
        base.update(overrides)
        return cls(**base)

    def to_dict(self) -> dict:
        """The fields as a dict; ``knn`` only when it is not the default
        ``"exact"``, so that an exact build's spec is the JAX package's
        (which has no ``knn``) and either package reads it."""
        d = dataclasses.asdict(self)
        if d["knn"] == "exact":
            del d["knn"]
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str) -> "IndexSpec":
        return cls(**json.loads(s))


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Query-time knobs, the JAX package's fields and defaults."""

    ef: int = 64
    k: int = 10
    use_fee: bool = True
    use_dfloat: bool = True
    trace: bool = False        # emit per-hop traces (fixed expansion budget)
    max_hops: int = 0          # 0 -> auto (4*ef expansions) when tracing
    expand: int = 4            # beam entries popped per hop (1 = classic HNSW)
    fee_backend: str = "auto"  # auto | jnp | pallas | pallas_skip_dma
    storage: str = "f32"       # dense f32 rows | packed bitstream | two tiers
    compact: float = 0.5       # frontier compaction keep fraction

    VALID_STORAGES = ("f32", "packed", "tiered")

    def __post_init__(self):
        if self.storage not in self.VALID_STORAGES:
            raise ValueError(f"storage={self.storage!r}; expected one of "
                             f"{self.VALID_STORAGES}")
        if self.storage in ("packed", "tiered") and not self.use_dfloat:
            raise ValueError(f'storage="{self.storage}" scores the Dfloat '
                             "bitstream; it requires use_dfloat=True")

    def to_config(self, metric: str, seg: int) -> SearchConfig:
        return SearchConfig(ef=self.ef, k=self.k, metric=metric, seg=seg,
                            max_hops=self.max_hops, use_fee=self.use_fee,
                            expand=self.expand, fee_backend=self.fee_backend,
                            storage=self.storage, compact=self.compact)


@dataclasses.dataclass
class SearchResult:
    """Uniform result of every search: (Q, k) numpy ``ids``/``dists``, the
    per-query counters, and the per-hop ``trace`` when traced."""

    ids: np.ndarray
    dists: np.ndarray
    hops: np.ndarray | None = None       # (Q,)
    n_eval: np.ndarray | None = None     # (Q,)
    dims: np.ndarray | None = None       # (Q,)
    n_resid: np.ndarray | None = None    # (Q,) residual-tier fetches (tiered)
    trace: dict | None = None            # per-hop arrays (node/nbrs/segs/...)
    sim: Any = None                      # NDP-simulator projection
    generation: int | None = None        # streaming snapshot generation

    @classmethod
    def from_raw(cls, out: dict) -> "SearchResult":
        """Wrap the dict of tensors produced by ``core.search``."""
        np_of = lambda v: None if v is None else (
            {k: x.cpu().numpy() for k, x in v.items()} if isinstance(v, dict)
            else v.cpu().numpy())
        return cls(ids=np_of(out["ids"]), dists=np_of(out["dists"]),
                   hops=np_of(out.get("hops")), n_eval=np_of(out.get("n_eval")),
                   dims=np_of(out.get("dims")), n_resid=np_of(out.get("n_resid")),
                   trace=np_of(out.get("trace")))

    @property
    def residual_fetch_fraction(self) -> float | None:
        """Fraction of evaluated lanes that fetched the residual tier
        (``storage="tiered"`` only; exited lanes never pay residual bytes)."""
        if self.n_resid is None or self.n_eval is None:
            return None
        return float(self.n_resid.sum()) / max(float(self.n_eval.sum()), 1.0)

    def __getitem__(self, key: str):
        """Dict-style access, as the JAX package's result offers."""
        v = getattr(self, key)
        if v is None:
            raise KeyError(f"{key!r} not populated (trace-only field?)")
        return v

    def recall(self, gt: np.ndarray, k: int | None = None) -> float:
        k = k or self.ids.shape[1]
        return recall_at_k(self.ids, gt, k)


@dataclasses.dataclass(frozen=True)
class FeeFit:
    """Host-side alpha/beta fit record (what ``pca.fit_beta`` measured)."""

    alpha: np.ndarray
    beta: np.ndarray
    margin: np.ndarray
    var_k: np.ndarray
    seg: int
    p_target: float
    metric: str

    @classmethod
    def from_dict(cls, d: dict) -> "FeeFit":
        return cls(alpha=np.asarray(d["alpha"], np.float32),
                   beta=np.asarray(d["beta"], np.float32),
                   margin=np.asarray(d["margin"], np.float32),
                   var_k=np.asarray(d["var_k"], np.float32),
                   seg=int(d["seg"]), p_target=float(d["p_target"]),
                   metric=str(d["metric"]))

    def to_dict(self) -> dict:
        return dict(alpha=self.alpha, beta=self.beta, margin=self.margin,
                    var_k=self.var_k, seg=self.seg, p_target=self.p_target,
                    metric=self.metric)

    def params(self, device="cuda") -> FeeParams:
        """Device view: the FeeParams tensors the searchers use."""
        return FeeParams.coerce(dict(alpha=self.alpha, beta=self.beta,
                                     margin=self.margin),
                                device=resolve_device(device))
