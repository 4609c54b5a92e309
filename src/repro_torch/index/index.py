"""The NasZip index: one typed build / persist / search surface.

Offline (paper Fig. 6 upper): PCA-rotate the DB -> alpha from eigenvalues ->
Var_k from sampled (query, vector) pairs -> beta from the Chebyshev budget ->
pruned kNN graph with HNSW upper levels -> Dfloat config search (Alg. 1) ->
bit-packed DB.  Online (Fig. 6 lower): hierarchy descent -> FEE-sPCA beam
search (``searcher("local")``).

The index holds host numpy arrays; each device gets its own cached copies
(``device_db``, ``device_adjacency``) that every searcher on that device
shares.  ``db_packed`` (the burst-aligned Dfloat bitstream) is the canonical
payload; the quantized f32 view ``db_q`` is derived from ``db_rot`` and the
layout (on the device, for the f32 search), bit-identical to decoding the
bitstream.

Persistence is the JAX package's format v3 (``<path>/spec.json`` +
``<path>/arrays.npz``, per-array checksums): either package loads the
other's artifacts, and formats v1 and v2 still load.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import dfloat as dfl
from repro_torch.core import graph as graph_mod
from repro_torch.core import pca as pca_mod
from repro_torch.core import search as search_mod
from repro_torch.data.synthetic import VecDB, exact_topk, recall_at_k
from repro_torch.index import backends as backends_mod
from repro_torch.index.types import FeeFit, IndexSpec, SearchParams, SearchResult
from repro_torch.resilience import CorruptArtifactError
from repro_torch.resilience import checksum as cks
from repro_torch.resilience import faults

FORMAT_VERSION = 3          # v3 persists the (coarse, residual) tier split;
                            # v2 dropped the persisted db_q copy
DELTA_FORMAT_VERSION = 3    # streaming-mutation delta segments (WAL) reuse the
                            # number, but live under <index>/delta/ with a
                            # manifest.json — an index dir always has spec.json
KNOWN_FORMATS = (1, 2, 3)


@dataclasses.dataclass
class Index:
    """A built index: spec + all offline artifacts (host arrays) + the
    device its searchers run on by default."""

    spec: IndexSpec
    spca: pca_mod.SPCA
    fee: FeeFit
    dfloat_cfg: dfl.DfloatConfig
    graph: graph_mod.GraphIndex
    db_rot: np.ndarray            # PCA-rotated DB (f32, pre-quantization)
    db_packed: np.ndarray         # real bitstream (uint32) — canonical payload
    device: torch.device = torch.device("cpu")
    timings: dict = dataclasses.field(default_factory=dict)
    # dead-row bitmap ((ceil(n/32),) uint32, bit = dead row); None = immutable
    tombstone: np.ndarray | None = None
    generation: int | None = None
    n_rows: int | None = None
    _db_q: np.ndarray | None = dataclasses.field(default=None, repr=False,
                                                 compare=False)
    # (coarse, residual) tier bitstreams carried by tier-native artifacts
    _tiers: tuple | None = dataclasses.field(default=None, repr=False,
                                             compare=False)
    _searchers: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)
    _device: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    MAX_CACHED_SEARCHERS = 16

    # -- trivia -------------------------------------------------------------
    @property
    def metric(self) -> str:
        return self.spec.metric

    @property
    def seg(self) -> int:
        return self.spec.seg

    @property
    def n(self) -> int:
        return self.db_rot.shape[0]

    @property
    def n_alive(self) -> int:
        """Rows that can appear in results (``n`` minus tombstoned/tail)."""
        if self.tombstone is None:
            return self.n
        # popcount over the bitmap words (O(n/32)), masking bits >= n
        words = self.tombstone[: -(-self.n // 32)].astype(np.uint32)
        tail_bits = self.n & 31
        if tail_bits:
            words[-1] &= np.uint32((1 << tail_bits) - 1)
        return self.n - int(np.unpackbits(words.view(np.uint8)).sum())

    @property
    def dim(self) -> int:
        return self.db_rot.shape[1]

    def transform_queries(self, q: np.ndarray) -> np.ndarray:
        return self.spca.transform(q)

    @property
    def db_q(self) -> np.ndarray:
        """Derived host f32 view of the quantized DB (emulated on the host,
        cached)."""
        if self._db_q is None:
            self._db_q = dfl.emulate_db(self.db_rot, self.dfloat_cfg)
        return self._db_q

    @property
    def tier_split(self) -> int:
        """Resolved coarse-tier size in FEE segments for ``storage="tiered"``:
        ``spec.tier_split`` when set, else the energy-based auto split."""
        n_segs = self.dim // self.seg
        if self.spec.tier_split is not None:
            ts = self.spec.tier_split
            if not 0 <= ts <= n_segs:
                raise ValueError(
                    f"spec.tier_split={ts} outside [0, {n_segs}] for "
                    f"dim={self.dim}, seg={self.seg}")
            return ts
        return pca_mod.suggest_tier_split(self.spca.eigvals, self.seg)

    def tier_cfgs(self) -> tuple[dfl.DfloatConfig, dfl.DfloatConfig]:
        """(coarse, residual) Dfloat layouts at the resolved tier split."""
        return dfl.split_config(self.dfloat_cfg, self.tier_split * self.seg)

    def tier_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(coarse, residual) packed tier bitstreams at the resolved split —
        field for field the bits of ``db_packed`` re-grouped at the tier
        boundary.  Derived from ``db_rot`` and cached when the artifact did
        not persist them."""
        if self._tiers is None:
            self._tiers = dfl.pack_tiers(self.db_rot, self.dfloat_cfg,
                                         self.tier_split * self.seg)
        return self._tiers

    def emulated_rows(self, ids: np.ndarray) -> np.ndarray:
        """Quantized f32 rows for ``ids`` on the host without materializing
        the full ``db_q`` (bit-identical to ``emulate_db`` of a tensor of the
        same rows on any device)."""
        if self._db_q is not None:
            return self._db_q[ids]
        return dfl.emulate_db(self.db_rot[ids], self.dfloat_cfg)

    # -- device copies --------------------------------------------------------
    def device_db(self, use_dfloat: bool, storage: str,
                  device) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
        """The DB in ``storage``'s representation on ``device``, shared by
        every searcher there: the (N, W) packed words as int32 (a bit view of
        the uint32 bitstream), the (coarse, residual) pair of tier words as
        int32, or the (N, D) f32 rows (``db_q`` emulated on the device, or
        ``db_rot``)."""
        key = ("db", storage, bool(use_dfloat), str(device))
        if key not in self._device:
            if storage == "tiered":
                arr = tuple(torch.from_numpy(t.view(np.int32)).to(device)
                            for t in self.tier_arrays())
            elif storage == "packed":
                arr = torch.from_numpy(self.db_packed.view(np.int32)).to(device)
            elif self._db_q is not None and use_dfloat:
                arr = torch.from_numpy(self._db_q).to(device)
            else:
                arr = torch.from_numpy(self.db_rot).to(device)
                if use_dfloat:
                    arr = dfl.emulate_db(arr, self.dfloat_cfg)
            self._device[key] = arr
        return self._device[key]

    def device_adjacency(self, device) -> torch.Tensor:
        key = ("adj", str(device))
        if key not in self._device:
            self._device[key] = torch.from_numpy(
                np.ascontiguousarray(self.graph.base_adjacency, np.int32)).to(device)
        return self._device[key]

    def device_tombstone(self, device) -> torch.Tensor | None:
        if self.tombstone is None:
            return None
        key = ("tombstone", str(device))
        if key not in self._device:
            words = np.ascontiguousarray(self.tombstone, np.uint32).view(np.int32)
            self._device[key] = torch.from_numpy(words).to(device)
        return self._device[key]

    def seed_device(self, key, arr) -> None:
        """Pre-populate the device-tensor cache under the keys ``device_db``,
        ``device_adjacency`` and ``device_tombstone`` read
        (``("db", storage, use_dfloat, str(device))``, ``("adj",
        str(device))``, ``("tombstone", str(device))``).  The serving tier's
        :class:`repro_torch.index.device.DeviceCache` seeds each snapshot
        with the tensors it spliced, so a generation swap never re-ships the
        full payload; ``searcher()`` picks them up unchanged."""
        self._device[key] = arr

    def drop_device(self) -> None:
        """Release this index's device tensors and its searchers (a retired
        serving generation, whose tensors the next generation's splice may
        have overwritten in place)."""
        self._device.clear()
        self._searchers.clear()

    # -- build --------------------------------------------------------------
    @classmethod
    def build(cls, db: VecDB, spec: IndexSpec | None = None, *,
              device="cuda", cache_key: str | None = None,
              **overrides) -> "Index":
        """Run the full offline pipeline for ``db`` under ``spec``.

        The graph build, the ground truth and the Dfloat config search run on
        ``device``; ``cache_key`` caches the graph under ``.cache/``.
        ``overrides`` are IndexSpec field overrides applied on top of ``spec``
        (or of ``IndexSpec.for_db(db)`` when no spec is given).
        """
        dev = resolve_device(device)
        if spec is None:
            spec = IndexSpec.for_db(db, **overrides)
        elif overrides:
            spec = dataclasses.replace(spec, **overrides)
        if spec.metric != db.metric:
            raise ValueError(f"spec.metric={spec.metric!r} but db is {db.metric!r}")
        x = db.vectors
        d = x.shape[1]
        if d % spec.seg:
            raise ValueError(f"seg={spec.seg} must divide dim={d}")
        t = {}

        t0 = time.perf_counter()
        spca = pca_mod.fit_spca(x, spec.metric)
        db_rot = spca.transform(x)
        tq_rot = spca.transform(db.train_queries)
        t["pca_offline_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        fee = FeeFit.from_dict(pca_mod.fit_beta(
            db_rot, tq_rot, spca.eigvals, spec.seg, metric=spec.metric,
            p_target=spec.p_target, seed=spec.seed))
        t["beta_fit_s"] = time.perf_counter() - t0

        # graph built on the rotated DB (distances identical to original space)
        t0 = time.perf_counter()
        graph = graph_mod.build_graph(db_rot, m=spec.m, metric=spec.metric,
                                      prune=spec.prune, cache_key=cache_key,
                                      seed=spec.seed, device=dev)
        t["graph_build_s"] = time.perf_counter() - t0

        # Dfloat search (Alg. 1) with a recall proxy on sampled train queries
        t0 = time.perf_counter()
        if spec.dfloat_recall_target is not None:
            rot = torch.from_numpy(db_rot).to(dev)
            sample_q = tq_rot[: min(64, len(tq_rot))]
            gt = exact_topk(rot, sample_q, spec.recall_k, spec.metric, device=dev)

            if spec.dfloat_proxy:
                # top-k ordering agreement under exact quantized distances
                def recall_fn(db_emul):
                    found = exact_topk(db_emul, sample_q, spec.recall_k,
                                       spec.metric, device=dev)
                    return recall_at_k(found, gt, spec.recall_k)
            else:
                def recall_fn(db_emul):
                    cfg = search_mod.SearchConfig(
                        ef=spec.ef_fit, k=spec.recall_k, metric=spec.metric,
                        seg=spec.seg, use_fee=True)
                    out = search_mod.search_graph(db_emul, graph, sample_q, cfg,
                                                  fee=fee.params(dev))
                    return recall_at_k(out["ids"], gt, spec.recall_k)

            dfloat_cfg, _log = dfl.search_config(rot, recall_fn,
                                                 spec.dfloat_recall_target)
        else:
            dfloat_cfg = dfl.fp32_config(d)
        db_packed = dfl.pack_db(db_rot, dfloat_cfg)
        t["dfloat_search_s"] = time.perf_counter() - t0

        return cls(spec=spec, spca=spca, fee=fee, dfloat_cfg=dfloat_cfg,
                   graph=graph, db_rot=db_rot, db_packed=db_packed, device=dev,
                   timings=t)

    # -- persistence --------------------------------------------------------
    def save(self, path: str | Path) -> Path:
        """Write ``<path>/spec.json`` + ``<path>/arrays.npz`` (format v3)."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        meta = dict(
            format_version=FORMAT_VERSION,
            spec=dataclasses.asdict(self.spec),
            fee=dict(seg=self.fee.seg, p_target=self.fee.p_target,
                     metric=self.fee.metric),
            dfloat=dict(
                burst_bits=self.dfloat_cfg.burst_bits,
                devices_per_subchannel=self.dfloat_cfg.devices_per_subchannel,
                segments=[dataclasses.asdict(s) for s in self.dfloat_cfg.segments],
            ),
            graph=dict(m=self.graph.m, entry=self.graph.entry,
                       n_levels=len(self.graph.levels)),
            timings=self.timings,
        )
        if self.generation is not None:
            meta["generation"] = self.generation
        if self.n_rows is not None:
            meta["n_rows"] = self.n_rows
        arrays = dict(
            spca_mean=self.spca.mean, spca_components=self.spca.components,
            spca_eigvals=self.spca.eigvals,
            fee_alpha=self.fee.alpha, fee_beta=self.fee.beta,
            fee_margin=self.fee.margin, fee_var_k=self.fee.var_k,
            db_rot=self.db_rot, db_packed=self.db_packed,
        )
        if self.tombstone is not None:
            arrays["tombstone"] = self.tombstone
        if self.spec.tier_split is not None:
            arrays["db_coarse"], arrays["db_resid"] = self.tier_arrays()
            meta["tier_split"] = self.spec.tier_split
        for i, (ids, adj) in enumerate(self.graph.levels):
            arrays[f"g_ids{i}"] = ids
            arrays[f"g_adj{i}"] = adj
        meta["checksums"] = cks.manifest_checksums(arrays)
        (path / "spec.json").write_text(json.dumps(meta, indent=1))
        np.savez_compressed(path / "arrays.npz", **arrays)
        return path

    @classmethod
    def load(cls, path: str | Path, *, device="cuda") -> "Index":
        """Read an index directory written by either package (formats v1-v3),
        verifying every array against the manifest's checksums."""
        from repro_torch.index.convert import from_arrays

        dev = resolve_device(device)
        path = Path(path)
        if not (path / "spec.json").exists():
            hint = (" (found manifest.json — this looks like a checkpoint or "
                    "streaming delta segment, not an index directory; delta "
                    "segments are replayed via repro_torch.streaming"
                    ".MutableIndex.load on the *base* index directory)"
                    if (path / "manifest.json").exists() else "")
            raise ValueError(f"{path} is not a naszip index directory: "
                             f"no spec.json{hint}")
        meta = json.loads((path / "spec.json").read_text())
        version = meta.get("format_version")
        if version not in KNOWN_FORMATS:
            raise ValueError(
                f"unsupported index format v{version} at {path}: this build "
                f"reads formats {KNOWN_FORMATS} — written by a newer naszip; "
                "upgrade this package to read it.  (Streaming delta segments "
                "also stamp a format_version, but they live under "
                "<index>/delta/ with a manifest.json, never a spec.json — "
                "replay them via repro_torch.streaming.MutableIndex.load on "
                "the base index directory.)")
        try:
            with np.load(path / "arrays.npz", allow_pickle=False) as z:
                arrays = {k: faults.corrupt("index.read_arrays", z[k])
                          for k in z.files}
        except Exception as e:   # truncated/torn zip containers raise variously
            raise CorruptArtifactError(
                f"{path}: unreadable arrays.npz ({e}) — torn write or "
                "truncated artifact") from e
        cks.verify_arrays(arrays, meta.get("checksums"), path)
        return from_arrays(meta, arrays, dev)

    # -- search -------------------------------------------------------------
    def searcher(self, backend: str = "local",
                 params: SearchParams | None = None, *, device=None, **opts):
        """Return ``run(queries) -> SearchResult`` for the chosen backend on
        ``device`` (default: the device the index was built or loaded for).

        Searchers without backend-specific options are cached on the index.
        """
        params = params or SearchParams()
        dev = self.device if device is None else resolve_device(device)
        key = (backend, params, str(dev)) if not opts else None
        if key is not None and key in self._searchers:
            return self._searchers[key]
        fn = backends_mod.make(self, backend, params, device=dev, **opts)
        if key is not None:
            while len(self._searchers) >= self.MAX_CACHED_SEARCHERS:
                self._searchers.pop(next(iter(self._searchers)))
            self._searchers[key] = fn
        return fn

    @staticmethod
    def _params(params: SearchParams | None, kw: dict) -> SearchParams:
        if params is not None and kw:
            raise TypeError(f"pass either params= or field overrides, not both: {kw}")
        return params or SearchParams(**kw)

    def search(self, queries: np.ndarray, params: SearchParams | None = None,
               *, device=None, **kw) -> SearchResult:
        """Local-backend convenience: ``search(q, ef=64, k=10, trace=True)``."""
        return self.searcher("local", self._params(params, kw),
                             device=device)(queries)

    def evaluate(self, db: VecDB, params: SearchParams | None = None, *,
                 device=None, **kw) -> dict:
        """Recall (and, when tracing, hop/eval/dims statistics) on db.queries."""
        params = self._params(params, kw)
        res = self.search(db.queries, params, device=device)
        out = dict(recall=recall_at_k(res.ids, db.gt, params.k),
                   ef=params.ef, k=params.k)
        if params.trace:
            out.update(
                hops=float(np.mean(res.hops)),
                dist_evals=float(np.mean(res.n_eval)),
                dims_per_eval=float(res.dims.sum() / max(1, res.n_eval.sum())),
                dims_total=float(np.mean(res.dims)),
            )
        return out
