"""Execution backends behind ``Index.searcher(backend=...)``.

``local`` runs the batched beam search of ``core.search`` on one device.
Queries are raw (un-rotated) vectors; the searcher applies the index's sPCA
transform and the hierarchy descent itself.  The ``sharded`` and ``ndpsim``
backends of the JAX package are not ported yet (ROADMAP queue A, items 9
and 6) and raise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import search as search_mod
from repro_torch.index.types import SearchParams, SearchResult
from repro_torch.kernels import ops as kops

BACKENDS = ("local", "sharded", "ndpsim")
_LATER = {"sharded": "queue A, item 9", "ndpsim": "queue A, item 6"}


def make(index, backend: str, params: SearchParams, *, device, **opts):
    if backend == "local":
        return local_searcher(index, params, device=device, **opts)
    if backend in _LATER:
        raise NotImplementedError(f"the {backend!r} backend is not ported yet: "
                                  f"see ROADMAP.md {_LATER[backend]}")
    raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")


def _descent_rows(index, params: SearchParams, vectors: torch.Tensor):
    """f32 row provider for the upper-layer greedy descent.

    Descent touches only the small upper-level subsets.  Dense storage
    gathers them from the device DB; packed storage decodes their packed
    words (bit-identical to the emulated rows) once per level and keeps them
    (the level ids are fixed, so repeated ``run()`` calls reuse them)."""
    dev = vectors.device
    if params.storage != "packed":
        return lambda ids: vectors[torch.as_tensor(ids, device=dev).long()]
    cache = {}

    def rows(ids):
        key = id(ids)
        if key not in cache:
            words = vectors[torch.as_tensor(ids, device=dev).long()]
            cache[key] = kops.dfloat_unpack_rows(words, index.dfloat_cfg,
                                                 backend=params.fee_backend)
        return cache[key]

    return rows


def local_searcher(index, params: SearchParams, *, device, fee=None):
    """Single-device searcher; the DB/adjacency device tensors come from the
    index-level cache, so searchers for different params share one copy.
    Paths not ported yet (tiered storage, the skip-DMA kernels) raise in
    ``core.search.make_searcher``."""
    cfg = params.to_config(index.metric, index.seg)
    vectors = index.device_db(params.use_dfloat, params.storage, device)
    fee_params = None
    if params.use_fee:
        fee_params = fee if fee is not None else index.fee.params(device)
    searcher = search_mod.make_searcher(
        vectors, index.device_adjacency(device), cfg, fee=fee_params,
        trace=params.trace,
        dfloat_cfg=index.dfloat_cfg if params.storage == "packed" else None,
        tombstone=index.device_tombstone(device))
    rows = _descent_rows(index, params, vectors)

    def run(queries) -> SearchResult:
        qr = torch.from_numpy(index.transform_queries(np.asarray(queries))).to(device)
        entries = search_mod.descend_entry(rows, index.graph, qr, index.metric)
        res = SearchResult.from_raw(searcher(qr, entries))
        res.generation = index.generation
        return res

    return run
