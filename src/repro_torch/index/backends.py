"""Execution backends behind ``Index.searcher(backend=...)``.

``local`` runs the batched beam search of ``core.search`` on one device.
``sharded`` runs the query-owner sharded search of
``distributed.retrieval`` (the paper's DaM, Fig. 12): C shards stacked on
one device, or one shard per rank of a ``torch.distributed`` group.
``ndpsim`` runs the local search with tracing on, on the same device, and
replays its per-hop trace on the host through the DIMM-NDP performance model
(``repro_torch.ndpsim``), whose projection rides on ``SearchResult.sim``.
Queries are raw (un-rotated) vectors; the searcher applies the index's sPCA
transform and the hierarchy descent itself.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import dfloat as dfl
from repro_torch.core import graph as graph_mod
from repro_torch.core import search as search_mod
from repro_torch.index.types import SearchParams, SearchResult
from repro_torch.ndpsim import SimFlags, account_writes, simulate_ndp
from repro_torch.ndpsim.timing import NASZIP_2CH
from repro_torch.obs import default_registry, tracer


def _record_search(res: SearchResult, dim: int) -> None:
    """Feed one batch's :class:`SearchResult` counters (host arrays) into the
    process-wide telemetry registry (``repro_torch.obs.default_registry``),
    under the JAX package's names: queries served, hops, lanes evaluated,
    feature dims touched vs touchable (the FEE exit fraction is
    ``1 - dims_touched/dims_possible``) and residual-tier fetches."""
    reg = default_registry()
    reg.counter("search.queries").inc(len(res.ids))
    if res.hops is not None:
        reg.counter("search.hops").inc(float(np.sum(res.hops)))
    if res.n_eval is not None:
        reg.counter("search.lanes_evaluated").inc(float(np.sum(res.n_eval)))
    if res.dims is not None:
        reg.counter("search.dims_touched").inc(float(np.sum(res.dims)))
        if res.n_eval is not None:
            reg.counter("search.dims_possible").inc(
                float(np.sum(res.n_eval)) * dim)
    if res.n_resid is not None:
        reg.counter("search.residual_fetches").inc(float(np.sum(res.n_resid)))


BACKENDS = ("local", "sharded", "ndpsim")


def make(index, backend: str, params: SearchParams, *, device, **opts):
    if backend == "local":
        return local_searcher(index, params, device=device, **opts)
    if backend == "sharded":
        return sharded_searcher(index, params, device=device, **opts)
    if backend == "ndpsim":
        return ndpsim_searcher(index, params, device=device, **opts)
    raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")


def _dfloat_cfg(index, params: SearchParams):
    """The layout of the storage's rows: the tier pair's, the packed rows',
    or None for f32 rows."""
    if params.storage == "tiered":
        return index.tier_cfgs()
    return index.dfloat_cfg if params.storage == "packed" else None


def _fee_params(index, params: SearchParams, fee, device):
    """The FEE parameters a search scores with: ``fee`` or the index's fit,
    on ``device``; None without FEE."""
    if not params.use_fee:
        return None
    return fee if fee is not None else index.fee.params(device)


def local_searcher(index, params: SearchParams, *, device, fee=None):
    """Single-device searcher; the DB/adjacency device tensors come from the
    index-level cache, so searchers for different params share one copy.
    ``storage="tiered"`` searches the (coarse, residual) tier pair at the
    index's resolved ``tier_split``."""
    cfg = params.to_config(index.metric, index.seg)
    vectors = index.device_db(params.use_dfloat, params.storage, device)
    dfloat_cfg = _dfloat_cfg(index, params)
    searcher = search_mod.make_searcher(
        vectors, index.device_adjacency(device), cfg,
        fee=_fee_params(index, params, fee, device),
        trace=params.trace, dfloat_cfg=dfloat_cfg,
        tombstone=index.device_tombstone(device))
    levels = index.device_levels(device)

    def run(queries) -> SearchResult:
        with tracer.span("search.call", q=len(queries), storage=params.storage,
                         ef=params.ef):
            with tracer.span("search.transform"):
                qr = torch.from_numpy(
                    index.transform_queries(np.asarray(queries))).to(device)
            entries = search_mod.descend_entry(levels, vectors, params.storage,
                                               dfloat_cfg, qr, index.metric)
            raw = searcher(qr, entries)
            with tracer.span("search.readback"):
                res = SearchResult.from_raw(raw)
            res.generation = index.generation
            _record_search(res, index.dim)
        return res

    return run


def sharded_searcher(index, params: SearchParams, *, device, mesh=None,
                     n_shards: int | None = None, group=None,
                     owner_policy: str = "shuffle", seed: int = 0,
                     n_bits_log2: int = 23, fee=None, owner=None,
                     overlap: bool = False):
    """Query-owner sharded DaM retrieval (paper Fig. 12): rows sharded by
    owner, neighbour lists pre-partitioned by owner, each query's beam on
    one shard.  ``n_shards`` shards stacked on ``device``
    (``distributed.comm.LocalShards``, default 1), or with ``group=`` a
    ``torch.distributed`` process group (``torch.distributed.group.WORLD``
    for the default one) one shard per rank (``GroupShards``; every rank
    calls ``run`` with the same queries and gets every result).

    ``owner`` overrides the row->shard map (a streaming index passes its
    stable capacity-wide map); ``overlap=True`` selects the double-buffered
    stale-threshold pipeline; ``n_bits_log2`` is accepted and ignored, as in
    the reference.  The returned ``run`` carries the per-hop collective
    payload model as ``run.payload``
    (``distributed.retrieval.collective_payload``)."""
    from repro_torch.distributed import GroupShards, LocalShards
    from repro_torch.distributed import retrieval as rt

    if mesh is not None:
        raise TypeError("a JAX mesh has no counterpart in the port: pass "
                        "n_shards= (shards stacked on one device) or group= "
                        "(one shard per rank of a torch.distributed group)")
    if params.trace:
        raise ValueError("sharded backend does not emit traces; use "
                         "backend='local' (trace=True) or 'ndpsim'")
    comm = GroupShards(group) if group is not None else LocalShards(n_shards or 1)
    if n_shards is not None and n_shards != comm.n_shards:
        raise ValueError(f"n_shards={n_shards} but the process group has "
                         f"{comm.n_shards} ranks")
    if owner is None:
        owner = graph_mod.map_owners(index.n, comm.n_shards, owner_policy,
                                     seed=seed)
    dam = graph_mod.build_dam(index.graph.base_adjacency, owner, comm.n_shards)
    cfg = params.to_config(index.metric, index.seg)
    vectors = index.device_db(params.use_dfloat, params.storage, device)
    dfloat_cfg = _dfloat_cfg(index, params)
    sdb = rt.build_sharded_db(vectors, dam, tombstone=index.tombstone,
                              shards=comm.shards, device=device)
    searcher = rt.make_sharded_searcher(
        comm, cfg, index.n, fee=_fee_params(index, params, fee, device),
        n_bits_log2=n_bits_log2,
        dfloat_cfg=dfloat_cfg, tombstone=index.tombstone is not None,
        overlap=overlap)
    levels = index.device_levels(device)

    def run(queries) -> SearchResult:
        qr = torch.from_numpy(index.transform_queries(np.asarray(queries))).to(device)
        entries = search_mod.descend_entry(levels, vectors, params.storage,
                                           dfloat_cfg, qr, index.metric)
        ids, dists, hops = searcher(sdb, qr, entries)
        return SearchResult(ids=ids.cpu().numpy(), dists=dists.cpu().numpy(),
                            hops=hops.cpu().numpy(), generation=index.generation)

    run.payload = rt.collective_payload(cfg, dam.max_part_width(), comm.n_shards)
    return run


def ndpsim_searcher(index, params: SearchParams, *, device, hw=None, flags=None,
                    owner_policy: str = "shuffle", seed: int = 0, fee=None):
    """Trace-driven DIMM-NDP projection: the local search with tracing forced
    on (on ``device``), replayed on the host through
    ``ndpsim.simulate_ndp``; the SimResult rides on ``SearchResult.sim``.
    ``hw`` (default ``NASZIP_2CH``), ``flags``, ``owner_policy`` and
    ``seed`` (the vector->sub-channel map) are the JAX package's options."""
    hw = hw or NASZIP_2CH
    flags = flags or SimFlags()
    traced = dataclasses.replace(params, trace=True)
    # no custom fee -> the index's cached traced local searcher
    local = (index.searcher("local", traced, device=device) if fee is None
             else local_searcher(index, traced, device=device, fee=fee))
    owner = graph_mod.map_owners(index.n, hw.n_subchannels, owner_policy, seed=seed)
    dfloat_cfg = (index.dfloat_cfg if params.use_dfloat
                  else dfl.fp32_config(index.dim))
    tier_cfgs = index.tier_cfgs() if params.storage == "tiered" else None

    def run(queries) -> SearchResult:
        res = local(queries)
        res.sim = simulate_ndp(res, owner, index.graph.base_adjacency, hw,
                               flags, dfloat_cfg, index.seg,
                               tier_cfgs=tier_cfgs)
        mut = (index.timings or {}).get("mutation")
        if mut:
            # streaming snapshot: append/repair traffic rides along as
            # write-burst accounting next to the read-side projection
            res.sim.writes = account_writes(
                mut, index.dfloat_cfg, hw, index.graph.base_adjacency.shape[1])
        return res

    return run
