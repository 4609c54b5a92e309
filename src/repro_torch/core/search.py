"""GANNS beam search (HNSW §II-A3) as one batched PyTorch loop.

The JAX package runs each query in its own ``lax.while_loop`` under ``vmap``;
here the whole query batch moves together: every hop pops each query's
frontier, gathers all neighbor lists in one fused gather, and scores the
batch's frontier lanes in ONE kernel launch through the ``kernels.ops``
dispatcher.  A query whose beam has no unexpanded entry is done; a hop is a
no-op for it (it pops nothing, scores nothing and keeps its beam), so the
loop runs until no query is active and gives the same results as the
per-query loops.

Semantics follow the JAX package exactly: a size-``ef`` sorted beam; each hop
pops the ``expand`` nearest unexpanded entries, dedups the gathered ids
against the visited bitmap and across the batch (:func:`first_occurrence_mask`,
both arms), keeps a fresh-first stable compaction of L = max(M,
expand*M*compact) lanes, scores them with FEE against the current threshold
(the farthest beam entry) and merges survivors with one stable sort over
``ef + L`` candidates.  ``lax.top_k`` breaks ties toward the lower index, so
every top-k here is a stable sort: the beam wins ties in :func:`merge_beam`
and the compaction is a stable partition.

Only the lanes that are fresh and not tombstoned are handed to the kernel as
alive: the others never enter the beam in the JAX package either, and the
kernel then moves no bytes for them (with ``storage="tiered"``, no residual
words either).  Tiered search also counts ``n_resid`` per query: the scored
lanes whose FEE sequence ran past the coarse tier.

The visited bitmap is (Q, ceil(N/32)) int32 words; the visited update adds
each fresh id's bit, which is an OR only because fresh ids are deduped first.

The frontier step of a hop (the neighbour gather, the visited test, the
dedup, the compaction and the visited update) runs through
``kops.frontier``: on a CUDA device, under any backend but ``"jnp"`` and
traced or not, the one ``frontier`` kernel (``kernels/csrc/frontier.cu``);
on the CPU and under ``"jnp"``, its plain version ``ref.frontier_ref``.

Trace layout (``trace=True``, ``cfg.hops()`` hops), per query: ``node`` is
(H, E) — the up-to-``expand`` nodes popped per hop (-1 pad) — and
``nbrs``/``segs``/``cand_d``/``src`` are (H, L), the frontier batch after the
compaction in pop order; ``src[j]`` is the pop slot whose neighbor list slot
``j`` came from.  Results carry a leading query axis, as the JAX ``vmap``
output does.

The untraced loop runs its hop as an in-place step (:func:`_step`) on the
chunk's state tensors, which also writes the termination test into a
one-element flag.  On a CUDA device with the port's kernels, a searcher
captures that step as a CUDA graph once per query chunk, after the descent
and on the chunk's own state, and replays it until the flag reads False
(:class:`HopGraph`): the host issues one graph launch and one flag read a
hop.  Everywhere else (the CPU, the plain ``"jnp"`` backend, the traced
loop) the same step runs eagerly (:func:`_eager_loop`), so both run the one
hop.

The descent to each query's entry (:func:`descend_entry`) runs on the
device over the graph's upper levels (:class:`DeviceLevels`, held once per
index by ``Index.device_levels`` in one flat layout): on a CUDA device as
one ``descend`` kernel (``kernels/csrc/descend.cu``) that walks every level
and reads and decodes the storage's rows itself, on the CPU as its plain
version (``ref.descend_ref``), which reads rows through :func:`row_reader`,
the storage's one row rule; the beam's first row and its exact (no-FEE)
scoring read through that rule too.

With the process tracer on (``repro_torch.obs``), a chunk's loop records a
``search.beam`` span (attributes ``visited_bytes``: the chunk's bitmap,
``hops``: the loop's iterations,
``graph_hops``: those that were graph replays, and ``frontier_hops``: those
whose frontier step ran the ``frontier`` kernel) and marks each termination
readback ``search.sync``, each hop ``search.hop`` and a capture
``search.capture`` (profiler ranges, no spans); the descent records
``search.descend`` (``levels``, ``steps``, ``kernel_levels``).
"""
from __future__ import annotations

import dataclasses
import gc
import threading

import numpy as np
import torch

from repro_torch.core import fee as fee_mod
from repro_torch.core.fee import BIG, FeeParams
from repro_torch.kernels import ops as kops
from repro_torch.obs import tracer

FEE_BACKENDS = kops.BACKENDS
STORAGES = ("f32", "packed", "tiered")
INT32_MAX = 2**31 - 1
# visited-bitmap budget of one query chunk (Q x ceil(N/32) int32 words)
_VISITED_BYTES = 4 << 30


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    ef: int = 64
    k: int = 10
    metric: str = "l2"
    seg: int = 16               # FEE checkpoint granularity (features / access)
    max_hops: int = 0           # 0 -> auto (4*ef expansions / expand per hop)
    use_fee: bool = False
    expand: int = 4             # beam entries popped per hop (frontier batch)
    fee_backend: str = "auto"   # kernels.ops dispatch: auto | jnp | pallas[...]
    storage: str = "f32"        # base vectors: dense f32 | packed Dfloat words
    # fraction of the expand*M frontier batch retained by the fresh-first
    # compaction (lane budget L = max(M, expand*M*compact)); 1.0 keeps every
    # fresh lane (a pure reorder)
    compact: float = 0.5

    def __post_init__(self):
        if self.expand < 1:
            raise ValueError(f"expand must be >= 1, got {self.expand}")
        if not 0.0 < self.compact <= 1.0:
            raise ValueError(f"compact must be in (0, 1], got {self.compact}")
        if self.fee_backend not in FEE_BACKENDS:
            raise ValueError(f"fee_backend={self.fee_backend!r}; expected one "
                             f"of {FEE_BACKENDS}")
        if self.storage not in STORAGES:
            raise ValueError(f"storage={self.storage!r}; expected one of "
                             f"{STORAGES}")

    def hops(self):
        """Hop budget for the traced (fixed-length) path: the 4*ef expansion
        budget spread over ``expand``-wide hops."""
        return self.max_hops or max(-(-4 * self.ef // self.expand), 8)


# Below this frontier width the pairwise compare is used, above it the sort
# (the JAX package's split: the (n, n) compare is quadratic in n)
_DEDUP_SORT_MIN = 256


def first_occurrence_mask(ids, valid):
    """True for the first *valid* occurrence of each id along the last axis.

    Invalid lanes never shadow a real id.  Pairwise compare for narrow
    frontiers, a stable sort-based first-occurrence pass for wide ones.
    """
    n = ids.shape[-1]
    if n < _DEDUP_SORT_MIN:
        key = torch.where(valid, ids.to(torch.int32), -1)
        eq = (key[..., :, None] == key[..., None, :]) & valid[..., None, :]
        earlier = torch.tril(eq, diagonal=-1).any(-1)
        return ~earlier & valid
    key = torch.where(valid, ids.to(torch.int32), INT32_MAX)
    order = torch.argsort(key, dim=-1, stable=True)     # ties keep pop order
    sk = torch.gather(key, -1, order)
    firsts = torch.ones_like(valid)
    firsts[..., 1:] = sk[..., 1:] != sk[..., :-1]
    return torch.zeros_like(valid).scatter(-1, order, firsts) & valid


def compact_width(m: int, e: int, compact: float = 0.5) -> int:
    """Lane budget after the fresh-first frontier compaction of one hop
    (``expand == 1`` hops skip compaction: L = M)."""
    return m if e <= 1 else max(m, int(e * m * compact))


def local_topk_reduce(cand_ids, cand_d, r: int):
    """Shard-local top-``r`` of the candidate lanes by distance, before the
    owner's merge: ``(ids, dists)`` along the last axis, ties to the lower
    lane (a stable sort, as ``lax.top_k``).  With ``r >= min(ef, lanes)``
    the truncation cannot change the merged beam: a lane outside its own
    shard's top-ef already has ef better lanes on that shard alone."""
    order = torch.argsort(cand_d, dim=-1, stable=True)[..., :r]
    return torch.gather(cand_ids, -1, order), torch.gather(cand_d, -1, order)


def pop_frontier(beam_ids, beam_d, expanded, e: int):
    """Pop each query's ``e`` nearest unexpanded beam entries.

    Returns (nodes (Q, e), sel (Q, e), expanded'): ``nodes`` is -1 where fewer
    than ``e`` entries are active; inactive picks are already expanded or
    empty (d >= BIG), so setting ``expanded`` on them is a no-op.
    """
    active = ~expanded & (beam_d < BIG)
    done = ~active.any(-1, keepdim=True)
    idxs = torch.argsort(torch.where(active, beam_d, BIG), dim=-1,
                         stable=True)[..., :e]
    sel = torch.gather(active, -1, idxs) & ~done
    nodes = torch.where(sel, torch.gather(beam_ids, -1, idxs), -1)
    return nodes, sel, expanded.scatter(-1, idxs, True)


def merge_beam(beam_ids, beam_d, expanded, cand_ids, cand_d):
    """One stable top-ef merge of the beam with the hop's scored candidates:
    on equal distances beam entries win (they come first)."""
    ef = beam_ids.shape[-1]
    all_ids = torch.cat([beam_ids, cand_ids], dim=-1)
    all_d = torch.cat([beam_d, cand_d], dim=-1)
    all_exp = torch.cat([expanded, torch.zeros_like(cand_d, dtype=torch.bool)],
                        dim=-1)
    order = torch.argsort(all_d, dim=-1, stable=True)[..., :ef]
    beam_d = torch.gather(all_d, -1, order)
    return (torch.gather(all_ids, -1, order), beam_d,
            torch.gather(all_exp, -1, order) | (beam_d >= BIG))


def _bits(ids):
    """The int32 bit of each id within its visited/tombstone word."""
    return torch.ones_like(ids, dtype=torch.int32) << (ids & 31).to(torch.int32)


def tombstone_lookup(tombstone, ids):
    """Dead-bit gather: True where ``ids`` (clamped to >= 0) is tombstoned."""
    safe = ids.clamp(min=0)
    return (tombstone[(safe >> 5).long()] & _bits(safe)) != 0


def exclude_dead(beam_ids, beam_d, tombstone):
    """Final re-rank of the beam with tombstoned entries pushed out: dead
    lanes get dist BIG and id -1, so a dead id never reaches the output."""
    dead = tombstone_lookup(tombstone, beam_ids) & (beam_ids >= 0)
    d = torch.where(dead, BIG, beam_d)
    order = torch.argsort(d, dim=-1, stable=True)
    return (torch.where(torch.gather(dead, -1, order), -1,
                        torch.gather(beam_ids, -1, order)),
            torch.gather(d, -1, order))


def _score(vectors, ids, q, threshold, fee: FeeParams | None, cfg: SearchConfig,
           dfl_cfg, alive):
    """FEE/exact distances of the (Q, L) lanes ``ids``, routed through the
    kernel dispatcher.  ``vectors`` is the (N, D) f32 DB, for
    ``storage="packed"`` the (N, W) packed words with ``dfl_cfg`` their
    layout, and for ``storage="tiered"`` the (coarse, residual) pair of tier
    words with ``dfl_cfg`` the matching pair of layouts — the coarse tier
    makes the exit decisions and residual words move only for lanes that
    survive it.  ``alive`` (Q, L) marks the lanes to score — the others report
    rejected with ``segs_used == 0`` (for tiered: no residual fetch either)."""
    if cfg.use_fee:
        common = dict(seg=cfg.seg, metric=cfg.metric, backend=cfg.fee_backend,
                      lane_mask=alive)
        fp = (fee.alpha, fee.beta, fee.margin)
        if cfg.storage == "tiered":
            return kops.fee_distance_tiered(vectors[0], vectors[1], ids, q,
                                            threshold, *fp,
                                            coarse_cfg=dfl_cfg[0],
                                            resid_cfg=dfl_cfg[1], **common)
        if cfg.storage == "packed":
            return kops.fee_distance_packed(vectors, ids, q, threshold, *fp,
                                            dfloat_cfg=dfl_cfg, **common)
        return kops.fee_distance(vectors, ids, q, threshold, *fp, **common)
    rows = row_reader(vectors, cfg.storage, dfl_cfg, cfg.fee_backend)(ids)
    score = fee_mod.exact_distance(q, rows, metric=cfg.metric)
    n_segs = rows.shape[-1] // cfg.seg
    return (score, ~alive,
            torch.where(alive, n_segs, 0).to(torch.int32))


def _hop_body(state, vectors, adj, q, fee: FeeParams | None, cfg: SearchConfig,
              dfl_cfg=None, tombstone=None, trace: bool = False):
    """One hop of the beam loop -> (new state, counters): the (Q, C) int64
    counters of :func:`counter_names`, then 1 for each query that popped a
    node.  With ``trace=True`` the second value is the hop's trace dict
    instead (``node``, ``nbrs``, ``segs``, ``cand_d``, ``src`` and the named
    counters as int32)."""
    beam_ids, beam_d, expanded, visited = state
    n_q, ef = beam_ids.shape
    e, m = min(cfg.expand, ef), adj.shape[1]
    nodes, sel, expanded = pop_frontier(beam_ids, beam_d, expanded, e)

    # ---- the frontier step: gather all E neighbor lists, dedup against the
    # visited bitmap and across the hop, keep a fresh-first stable partition
    # of L lanes (overflowing fresh candidates are dropped unmarked: still
    # discoverable through other parents on later hops) and mark the kept
    # fresh ids visited, in place
    nbrs, safe, fresh, src = kops.frontier(nodes, sel, adj, visited,
                                           compact_width(m, e, cfg.compact),
                                           backend=cfg.fee_backend)

    # tombstoned lanes stay visited-marked but are never scored or inserted
    live = fresh if tombstone is None else fresh & ~tombstone_lookup(tombstone, safe)
    threshold = beam_d[:, -1].contiguous()
    score, rejected, segs_used = _score(vectors, safe, q, threshold, fee, cfg,
                                        dfl_cfg, live)

    # ---- single stable top-ef beam merge over (ef + L) candidates
    cand_d = torch.where(fresh & ~rejected, score, BIG)
    beam_ids, beam_d, expanded = merge_beam(beam_ids, beam_d, expanded, safe,
                                            cand_d)
    segs = torch.where(live, segs_used, 0)
    cols = [live.sum(1), segs.sum(1) * cfg.seg]
    if cfg.storage == "tiered":
        # a lane crossed into the residual tier iff it survived every coarse
        # checkpoint — exited lanes are never charged residual bytes
        cols.append((segs > dfl_cfg[0].dim // cfg.seg).sum(1))
    state = (beam_ids, beam_d, expanded, visited)
    if not trace:
        return state, torch.stack(cols + [(nodes >= 0).any(1)], dim=1)
    return state, dict(
        node=nodes.to(torch.int32),
        nbrs=torch.where(live, nbrs, -1).to(torch.int32),
        segs=segs.to(torch.int32),
        cand_d=cand_d,                                   # BIG unless accepted
        src=torch.where(live, src, -1).to(torch.int32),  # parent of slot j
        **{k: c.to(torch.int32) for k, c in zip(counter_names(cfg), cols)})


def counter_names(cfg: SearchConfig) -> tuple[str, ...]:
    """The per-query counters a search returns beside ``hops``, in the order
    of a hop's counter columns: lanes scored, dims touched and, for tiered
    storage, lanes that read the residual tier."""
    return (("n_eval", "dims", "n_resid") if cfg.storage == "tiered"
            else ("n_eval", "dims"))


def _lead(vectors) -> torch.Tensor:
    """The DB tensor of any storage that gives its rows and device (for
    tiered storage the coarse tier's)."""
    return vectors[0] if isinstance(vectors, tuple) else vectors


def _init_state(q, entries, vectors, cfg: SearchConfig, n_words, dfl_cfg=None):
    n_q, ef = q.shape[0], cfg.ef
    row = row_reader(vectors, cfg.storage, dfl_cfg, cfg.fee_backend)(entries)
    d0 = fee_mod.exact_distance(q, row[:, None, :], metric=cfg.metric)[:, 0]
    dev = q.device
    beam_ids = torch.full((n_q, ef), -1, dtype=torch.int32, device=dev)
    beam_ids[:, 0] = entries
    beam_d = torch.full((n_q, ef), BIG, dtype=torch.float32, device=dev)
    beam_d[:, 0] = d0
    expanded = torch.ones((n_q, ef), dtype=torch.bool, device=dev)
    expanded[:, 0] = False
    visited = torch.zeros((n_q, n_words), dtype=torch.int32, device=dev)
    visited.scatter_(1, (entries >> 5).long()[:, None], _bits(entries)[:, None])
    return beam_ids, beam_d, expanded, visited


def _active(beam_d, expanded):
    """The loop's termination test, a 0-d bool tensor: True while some query
    of the chunk has an unexpanded beam entry."""
    return ((~expanded) & (beam_d < BIG)).any()


def _step(state, counters, flag, hop):
    """One hop of the untraced loop, in place: the beam, its distances and
    its expanded mask take the hop's (the hop updates the visited bitmap in
    place itself), ``counters`` add the hop's counters, and ``flag`` takes
    the termination test of the new beam.  It writes no tensor but these,
    so a CUDA graph captured from it replays on the same state."""
    new, cnt = hop(state)
    for old, upd in zip(state[:3], new[:3]):
        old.copy_(upd)
    counters += cnt
    flag.copy_(_active(state[1], state[2]))


def _eager_loop(step, flag) -> tuple[int, int]:
    """Runs ``step`` until ``flag`` reads False, each hop's ops launched one
    by one.  Returns (hops, graph replays), the latter 0."""
    n = 0
    while True:
        # the host waits here for the device: the hop's one sync
        with tracer.mark("search.sync"):
            if not flag.item():
                return n, 0
        with tracer.mark("search.hop"):
            step()
        n += 1


class _CollectorPause:
    """Pauses Python's automatic garbage collection while any capture is
    under way (the collector is process-wide, so the count is too): a
    collection in a capturing thread could free an unreachable searcher's
    CUDA graph, and destroying a graph there fails the capture."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0
        self._was_enabled = False

    def __enter__(self):
        with self._lock:
            if self._n == 0:
                self._was_enabled = gc.isenabled()
                gc.disable()
            self._n += 1

    def __exit__(self, *exc):
        with self._lock:
            self._n -= 1
            if self._n == 0 and self._was_enabled:
                gc.enable()
        return False


_collector_paused = _CollectorPause()


class HopGraph:
    """A searcher's CUDA-graph replay of the untraced loop's hop.

    :meth:`loop` captures the step once per query chunk, on the chunk's own
    state, and replays it until the flag reads False.  The side stream the
    capture is recorded on and the memory pool that the captured hop's
    temporaries come from live as long as the searcher, so the pool's blocks
    stay cached from one call's capture to the next.  The graph holds no
    tensor: the state is freed at the chunk's end, as in the eager loop, and
    the graph is only kept until the next capture replaces it, since torch's
    allocator does not capture into a pool that no live graph holds.  Calls
    from several threads (a serving batcher restarted by its watchdog) take
    turns on the searcher's stream and pool; the capture is thread-local, so
    other threads go on launching their own work meanwhile."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self._graph = None
        self._lock = threading.Lock()

    def _capture(self, step):
        """The graph of one ``step`` (which does not run) and each kernel's
        launches in it (``kops.launch_counts`` order)."""
        before = kops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream), _collector_paused:
            graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                step()
            finally:
                # ends the capture on an error too, so this thread may go on
                graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        return graph, [a - b for a, b in zip(kops.launch_counts(), before)]

    def loop(self, step, flag) -> tuple[int, int]:
        """Replays ``step`` until ``flag`` reads False; a chunk with nothing
        active captures nothing.  Returns (hops, graph replays), equal."""
        with tracer.mark("search.sync"):
            if not flag.item():
                return 0, 0
        with self._lock:
            with tracer.mark("search.capture"):
                graph, per_hop = self._capture(step)
            self._graph = graph     # holds the pool until the next capture
            n = 0
            while True:
                with tracer.mark("search.hop"):
                    graph.replay()
                n += 1
                with tracer.mark("search.sync"):
                    if not flag.item():
                        break
        # the capture counted each kernel's launches once, the replays ran n
        kops.add_launches(per_hop, n - 1)
        return n, n


def _captures(device: torch.device, cfg: SearchConfig, trace: bool) -> bool:
    """Whether a searcher replays its hop as a CUDA graph: on a CUDA device,
    on the untraced path (the traced loop keeps every hop's trace), and with
    the port's kernels (the plain ``"jnp"`` versions are the comparison run
    and are not held to capture's rules)."""
    return device.type == "cuda" and not trace and cfg.fee_backend != "jnp"


def _search_batch(vectors, adj, fee, tombstone, queries, entries, *,
                  cfg: SearchConfig, trace: bool, loop, dfl_cfg=None) -> dict:
    """Beam search of one query batch; dict of (Q, ...) tensors.  ``loop``
    runs the untraced path's hops: :func:`_eager_loop` or a
    :meth:`HopGraph.loop`."""
    n_words = -(-_lead(vectors).shape[0] // 32)
    names = counter_names(cfg)
    with tracer.span("search.beam", q=queries.shape[0],
                     visited_bytes=4 * n_words * queries.shape[0]) as beam:
        state = _init_state(queries, entries, vectors, cfg, n_words, dfl_cfg)
        hop = lambda s, **kw: _hop_body(s, vectors, adj, queries, fee, cfg,
                                        dfl_cfg, tombstone, **kw)
        if trace:
            hops = []
            for _ in range(cfg.hops()):
                with tracer.mark("search.hop"):
                    state, t = hop(state, trace=True)
                hops.append(t)
            n_hops, n_graph = len(hops), 0
            traces = {k: torch.stack([t[k] for t in hops], dim=1) for k in hops[0]}
        else:
            # the named counters, then the hops that popped a node
            counters = torch.zeros((queries.shape[0], len(names) + 1),
                                   dtype=torch.int64, device=queries.device)
            flag = _active(state[1], state[2])
            n_hops, n_graph = loop(
                lambda: _step(state, counters, flag, hop), flag)
        beam_ids, beam_d = state[0], state[1]
        if tombstone is not None:
            beam_ids, beam_d = exclude_dead(beam_ids, beam_d, tombstone)
        beam.set(hops=n_hops, graph_hops=n_graph,
                 frontier_hops=n_hops if kops.frontier_on_card(
                     queries.device, cfg.fee_backend) else 0)
    out = dict(ids=beam_ids[:, : cfg.k], dists=beam_d[:, : cfg.k])
    if trace:
        out["trace"] = traces
        out["hops"] = (traces["node"] >= 0).any(-1).sum(-1).to(torch.int32)
        for k in names:
            out[k] = traces[k].sum(-1).to(torch.int32)
    else:
        *cnt, out["hops"] = counters.to(torch.int32).unbind(1)
        out.update(zip(names, cnt))
    return out


def make_searcher(vectors, adj, cfg: SearchConfig,
                  fee: FeeParams | dict | None = None, trace: bool = False, *,
                  dfloat_cfg=None, tombstone=None):
    """Returns search(queries (Q, D), entries (Q,)) -> dict of tensors.  The
    beam runs in query chunks, one after another, each a ``search.beam``
    span: a chunk's visited bitmap (``chunk x ceil(N/32)`` int32 words)
    stays under ``_VISITED_BYTES``.

    ``vectors``/``adj`` are tensors on the device the search runs on: the
    (N, D) f32 DB; for ``cfg.storage == "packed"`` the (N, W) int32 word view
    of the Dfloat bitstream with ``dfloat_cfg`` its layout; for
    ``cfg.storage == "tiered"`` the (coarse, residual) pair of tier word
    views with ``dfloat_cfg`` the matching pair of layouts from
    ``dfloat.split_config``.  ``tombstone`` ((ceil(N/32),) int32 words,
    bit = dead row) masks deleted rows out of scoring and results.
    """
    packed = cfg.storage == "packed"
    tiered = cfg.storage == "tiered"
    if packed and dfloat_cfg is None:
        raise ValueError('cfg.storage="packed" requires dfloat_cfg=DfloatConfig')
    if tiered and not (isinstance(dfloat_cfg, tuple) and len(dfloat_cfg) == 2
                       and isinstance(vectors, tuple) and len(vectors) == 2):
        raise ValueError('cfg.storage="tiered" requires vectors=(coarse, '
                         "residual) and dfloat_cfg=(coarse_cfg, residual_cfg)")
    dev = _lead(vectors).device
    fp = FeeParams.coerce(fee, device=dev)
    if cfg.use_fee and fp is None:
        raise ValueError("cfg.use_fee=True requires fee=FeeParams(...) "
                         "(use FeeParams.identity(n_seg) for plain d_part exit)")
    n_rows = _lead(vectors).shape[0]
    if tombstone is not None and tuple(tombstone.shape) != (-(-n_rows // 32),):
        raise ValueError(f"tombstone shape {tuple(tombstone.shape)} does not "
                         f"cover {n_rows} rows")
    dfl_cfg = dfloat_cfg if packed or tiered else None
    chunk = max(1, _VISITED_BYTES // (4 * -(-n_rows // 32)))
    graph = HopGraph(dev) if _captures(dev, cfg, trace) else None
    loop = _eager_loop if graph is None else graph.loop

    def search(queries, entries):
        queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
        entries = torch.as_tensor(entries, dtype=torch.int32, device=dev)
        if graph is not None and cfg.use_fee:
            # built outside the capture, which may not wait for their copy
            kops.fee_tables(dfl_cfg, cfg.seg, dev)
        # an empty batch is one chunk of no queries: (0, k) results
        outs = [_search_batch(vectors, adj, fp, tombstone,
                              queries[s: s + chunk].contiguous(),
                              entries[s: s + chunk], cfg=cfg, trace=trace,
                              dfl_cfg=dfl_cfg, loop=loop)
                for s in range(0, max(queries.shape[0], 1), chunk)]
        if len(outs) == 1:
            return outs[0]
        cat = lambda vs: (torch.cat(vs) if isinstance(vs[0], torch.Tensor)
                          else {k: torch.cat([v[k] for v in vs]) for k in vs[0]})
        return {k: cat([o[k] for o in outs]) for k in outs[0]}

    return search


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceLevels:
    """A graph's upper levels (1 and up, bottom first) on one device, for the
    descent, in one flat layout: ``ids``, every level's sorted global ids
    end to end; ``adj``, every level's (Nl, Ml) level-local adjacency
    row-major, end to end (int32 vectors); ``table``, an (L, 4) int64 tensor
    of each level's (ids offset, Nl, adjacency offset, Ml), and ``spans``,
    the same rows as host ints; and the entry node's global id.  They hold
    no rows: the descent reads those from the storage."""

    entry: int
    ids: torch.Tensor
    adj: torch.Tensor
    table: torch.Tensor
    spans: tuple            # ((ids offset, Nl, adjacency offset, Ml), ...)

    @classmethod
    def of(cls, graph, device) -> "DeviceLevels":
        """The upper levels of ``graph`` (a ``GraphIndex``) on ``device``."""
        ups = graph.levels[1:]
        spans, i0, a0 = [], 0, 0
        for ids, adj in ups:
            n, m = np.shape(adj)
            spans.append((i0, n, a0, m))
            i0, a0 = i0 + n, a0 + n * m
        flat = lambda arrays: torch.from_numpy(np.concatenate(
            [np.asarray(a, np.int32).ravel() for a in arrays] or [np.zeros(0, np.int32)])
        ).to(device)
        return cls(graph.entry, flat([ids for ids, _ in ups]),
                   flat([adj for _, adj in ups]),
                   torch.tensor(spans, dtype=torch.int64).reshape(-1, 4).to(device),
                   tuple(spans))

    @property
    def levels(self) -> tuple:
        """((ids (Nl,), adj (Nl, Ml)), ...), bottom first: views of the flat
        tensors."""
        return tuple((self.ids[i0:i0 + n], self.adj[a0:a0 + n * m].view(n, m))
                     for i0, n, a0, m in self.spans)


def row_reader(vectors, storage: str, dfloat_cfg=None, backend: str = "auto"):
    """The storage's one row rule: ``ids`` (an integer tensor of any shape)
    -> their f32 rows, ``ids.shape + (D,)``.  f32 rows are gathered from the
    DB; packed and tiered rows are decoded from their words by the fused
    gather decode (:func:`decode_rows`, one launch), which is exact: a row
    reads the same f32 either way it is read."""
    if storage == "f32":
        return lambda ids: vectors[ids.long()]
    return lambda ids: decode_rows(vectors, ids.reshape(-1).long(), dfloat_cfg,
                                   backend=backend).unflatten(0, ids.shape)


def descend_entry(levels: DeviceLevels, vectors, storage: str, dfloat_cfg,
                  queries, metric: str) -> torch.Tensor:
    """Greedy top-down routing through the graph's upper levels -> the base
    level's entry ids, a (Q,) int32 tensor on the queries' device.

    ``levels`` are the upper levels on that device; ``vectors`` the rows in
    ``storage`` with ``dfloat_cfg`` their layout, as :func:`make_searcher`
    takes them.  On a CUDA device one ``descend`` kernel walks every level
    (``kernels/descend.py``), and the host waits for nothing; on the CPU the
    plain version (``ref.descend_ref``) steps every query together.  The
    ``search.descend`` span carries ``levels``, ``steps`` (the plain loop's
    step count: a level takes one more step than the most moves any query
    made there; read back from the kernel's counter only while the tracer
    is on) and ``kernel_levels`` (the levels the kernel walked, as its
    wrapper reports them)."""
    n = len(levels.spans)
    with tracer.span("search.descend") as sp:
        entries, moves, walked = kops.descend(levels, vectors, storage, dfloat_cfg,
                                              queries.contiguous(), metric)
        if tracer.enabled:
            sp.set(levels=n, steps=n + int(moves.sum()), kernel_levels=walked)
    return entries


def search_graph(vectors, graph, queries, cfg: SearchConfig,
                 fee: FeeParams | dict | None = None, trace: bool = False,
                 dfloat_cfg=None, tombstone=None) -> dict:
    """Descend to base entries, run base-layer search; numpy result dict.

    ``vectors`` is a tensor on the search device (the tier pair for
    ``storage="tiered"``, as in :func:`make_searcher`); the descent reads
    the upper levels' rows from it.
    """
    dev = _lead(vectors).device
    q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    entries = descend_entry(DeviceLevels.of(graph, dev), vectors, cfg.storage,
                            dfloat_cfg, q, cfg.metric)
    out = make_searcher(vectors, torch.as_tensor(graph.base_adjacency,
                                                 device=dev),
                        cfg, fee=fee, trace=trace, dfloat_cfg=dfloat_cfg,
                        tombstone=tombstone)(q, entries)
    to_np = lambda v: ({k: x.cpu().numpy() for k, x in v.items()}
                       if isinstance(v, dict) else v.cpu().numpy())
    return {k: to_np(v) for k, v in out.items()}


def decode_rows(vectors, ids, dfloat_cfg, *, backend: str = "auto"):
    """f32 rows ``ids`` ((C,) int64) of a packed DB (``vectors`` the word
    view, ``dfloat_cfg`` its layout) or of a tiered one (both as pairs); the
    decode gathers the rows itself."""
    if isinstance(vectors, tuple):
        return kops.dfloat_unpack_tiered_rows(*vectors, *dfloat_cfg, ids=ids,
                                              backend=backend)
    return kops.dfloat_unpack_rows(vectors, dfloat_cfg, ids=ids, backend=backend)
