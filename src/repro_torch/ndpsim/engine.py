"""Trace-driven DIMM-NDP performance model (the role UniNDP plays in §VI-A).

The JAX package's numpy engine, copied unchanged onto the port's
``DfloatConfig``; it runs on the host.  Its outputs are a projection of the
paper's DIMM-NDP hardware, not times of the device that ran the search.

Input: per-hop traces from the port's traced beam search
(``core/search.py``, ``SearchParams(trace=True)``: expanded node, fresh
candidates, FEE segments touched, accepted distances), a vector->sub-channel
ownership map, and a Dfloat config.  The engine replays the search
hop-synchronized per query batch (paper §V-E) against a model of:

  * per-sub-channel DRAM streaming (burst-granular, FEE/Dfloat-aware),
  * the VPE consume rate,
  * DaM vs naive neighbor-list placement (cross-channel traffic, CPU lookup),
  * LNC-T / LNC-D caches (LRU, line-granular),
  * next-hop neighbor-list prefetch from the per-sub-channel local queues
    overlapped with the host merge,
  * host control/merge costs.

Outputs: QPS, per-query latency, the three-way latency breakdown of Fig. 18,
cache/prefetch hit rates (Fig. 21), balance (Fig. 23), DRAM traffic (Fig. 20)
and energy (Fig. 17).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.dfloat import DfloatConfig
from repro_torch.ndpsim.cache import SetAssocCache
from repro_torch.ndpsim.timing import NDPConfig, PlatformConfig

BIG = 1.0e38


def _as_trace(traces) -> dict:
    """Accept a raw per-hop trace dict, a full search-result dict with a
    ``trace`` entry, or a typed ``repro_torch.index.SearchResult``."""
    t = getattr(traces, "trace", traces)
    if isinstance(t, dict) and "node" not in t and "trace" in t:
        t = t["trace"]
    if t is None or "node" not in t:
        raise ValueError("no per-hop trace — search with SearchParams(trace=True)")
    return t


def _norm_node(node: np.ndarray) -> np.ndarray:
    """Normalize the expanded-node trace to (Q, H, E).

    The multi-expansion searcher emits (Q, H, E) — up to E nodes popped per
    hop, -1 pad; legacy single-expansion traces are (Q, H).  ``expand=1``
    traces replay identically through either shape.
    """
    node = np.asarray(node)
    return node[:, :, None] if node.ndim == 2 else node


@dataclasses.dataclass
class SimFlags:
    dam: bool = True          # data-aware neighbor-list mapping (§V-C2)
    lnc: bool = True          # local neighbor cache (§V-D)
    prefetch: bool = True     # next-hop list prefetch (§V-E)
    batch: int = 16
    # neighbor-list storage: "varint" = the paper's sorted delta + varint
    # codes (what closes Fig. 20's list-traffic gap vs dense 4B ids);
    # "dense" = plain 4B ids (the pre-compression accounting, kept for A/B)
    list_compression: str = "varint"
    # per-link lane budget of the hierarchical partial-result merge: each
    # sender truncates to its top-``merge_width`` candidates before shipping
    # (the per-channel top-r reduce of the sharded searcher; 8B = id + dist)
    merge_width: int = 64


@dataclasses.dataclass
class SimResult:
    name: str
    qps: float
    avg_latency_us: float
    t_neighbor_us: float      # neighbor-list retrieval
    t_distance_us: float      # distance computation (incl. vector streaming)
    t_partial_us: float       # partial-result processing / host comm
    lnc_t_hit: float
    lnc_d_hit: float
    prefetch_hit: float
    prefetch_hit_by_hop: np.ndarray
    idle_frac: float          # earliest-finishing sub-channel idle share
    dram_bytes_per_query: float
    energy_uj_per_query: float
    writes: "WriteStats | None" = None  # mutation write traffic (streaming)
    # inter-channel partial-result traffic under the two merge topologies:
    # flat = every channel ships all accepted candidates to the host merger;
    # tree = log2(C) pairwise partial merges, each link truncated to
    # ``SimFlags.merge_width`` lanes, root -> host (the sharded searcher's
    # reduce-before-collective, Cosmos-style).  Bytes per query.
    merge_flat_bytes_per_query: float = 0.0
    merge_tree_bytes_per_query: float = 0.0
    # varint neighbor-list decoder occupancy: decoder-busy share of the
    # neighbor-retrieval phase (serial cycles per decoded id vs the dense
    # 4B-id-per-cycle baseline) — what keeps list_compression timing honest
    list_decode_occupancy: float = 0.0
    # tiered storage (far-memory residual channel); None when not tiered
    survivor_fetch_fraction: float | None = None   # lanes that fetched residual
    far_bytes_per_query: float = 0.0               # residual bytes over the far link
    residual_fetches_per_query: float = 0.0

    def breakdown(self):
        tot = self.t_neighbor_us + self.t_distance_us + self.t_partial_us
        return dict(neighbor=self.t_neighbor_us / tot, distance=self.t_distance_us / tot,
                    partial=self.t_partial_us / tot)


def _list_bytes(n_entries: int) -> int:
    return 4 * max(n_entries, 1)  # 4B per neighbor id (Fig. 12b)


# ---------------------------------------------------------------------------
# delta/varint neighbor-list compression (paper's list coding; Fig. 20)
# ---------------------------------------------------------------------------


def varint_bytes(vals) -> np.ndarray:
    """LEB128 bytes per value (7 payload bits/byte, minimum 1)."""
    v = np.maximum(np.asarray(vals, np.int64), 0)
    nbits = np.ones_like(v)
    nz = v > 0
    nbits[nz] = np.floor(np.log2(v[nz])).astype(np.int64) + 1
    return np.maximum(1, -(-nbits // 7))


def _delta_coded_bytes(rows: np.ndarray, vals: np.ndarray, n_rows: int,
                       empty_bytes: int = 1) -> np.ndarray:
    """Bytes of each row's sorted-delta + varint coded list.

    ``rows``/``vals`` are the (row, id) pairs of every list member; per row
    the ids are sorted, the first is varint-coded absolute and the rest as
    deltas, plus one count byte — the coding the NasZip list streamer decodes
    burst-by-burst.  Fully vectorized (one lexsort over all members).
    """
    out = np.full(n_rows, empty_bytes, np.int64)
    if len(rows) == 0:
        return out
    order = np.lexsort((vals, rows))
    r, v = rows[order], vals[order]
    first = np.r_[True, r[1:] != r[:-1]]
    coded = np.where(first, v, v - np.r_[0, v[:-1]])
    np.add.at(out, r, varint_bytes(coded))
    return out


def compressed_list_bytes(adj: np.ndarray) -> np.ndarray:
    """Per-node delta/varint bytes of the full (unpartitioned) neighbor list
    — shared by the non-DaM engine path and the Fig. 20 traffic benchmark."""
    rows, cols = np.nonzero(adj >= 0)
    return _delta_coded_bytes(rows, adj[rows, cols].astype(np.int64),
                              adj.shape[0])


def tree_merge_bytes(counts, width: int, lane_bytes: int = 8) -> float:
    """Inter-channel bytes of one hop's hierarchical partial-result merge.

    ``counts[c]`` is channel ``c``'s accepted-candidate count this hop.  The
    channels pair-merge in log2(C) levels: at each level the odd partner
    ships its top-``width`` lanes (truncation is exact for any final top-k
    <= width — a lane outside a sender's local top-``width`` cannot be in
    the merged top-``width``), the receiver keeps the top-``width`` of the
    union, and the root finally ships its merged result to the host.  The
    flat counterpart ships ``lane_bytes * sum(counts)`` straight to the
    host; the tree trades relay hops for per-link truncation, which wins
    whenever per-channel accepts exceed ``width`` and bounds every link —
    host ingress included — at ``width`` lanes.
    """
    counts = [int(c) for c in counts]
    total = 0
    while len(counts) > 1:
        if len(counts) % 2:
            counts.append(0)
        nxt = []
        for a, b in zip(counts[::2], counts[1::2]):
            ship = min(b, width)
            total += lane_bytes * ship
            nxt.append(min(a + ship, width))
        counts = nxt
    return float(total + lane_bytes * min(counts[0], width))


def simulate_ndp(traces, owner: np.ndarray, adj: np.ndarray,
                 hw: NDPConfig, flags: SimFlags, dfloat_cfg: DfloatConfig,
                 seg: int, name: str = "naszip",
                 tier_cfgs: tuple | None = None) -> SimResult:
    traces = _as_trace(traces)
    node = _norm_node(traces["node"])          # (Q, H, E)
    nbrs = np.asarray(traces["nbrs"])          # (Q, H, L)
    segs = np.asarray(traces["segs"])          # (Q, H, L)
    cand_d = np.asarray(traces["cand_d"])      # (Q, H, L)
    # parent pop slot of every candidate: explicit ``src`` for compacted
    # multi-expansion traces, fixed M-wide blocks for legacy layouts
    src = np.asarray(traces["src"]) if "src" in traces else None
    q_total, hmax, n_expand = node.shape
    m_width = nbrs.shape[2] // n_expand        # neighbor slots per popped node
    n_sub = hw.n_subchannels
    n_nodes = adj.shape[0]

    # per-channel partition sizes of every node's list (DaM, Fig. 12)
    nb_owner = owner[np.where(adj < 0, 0, adj)]
    part_size = np.zeros((n_sub, n_nodes), np.int32)
    for c in range(n_sub):
        part_size[c] = ((nb_owner == c) & (adj >= 0)).sum(1)
    full_size = (adj >= 0).sum(1)

    # per-(channel, node) stored list bytes: the paper's sorted delta +
    # varint coding of the partition's *local slot* ids (small, dense id
    # space -> 1-2B deltas), or plain 4B ids for the pre-compression A/B
    varint = flags.list_compression == "varint"
    if flags.list_compression not in ("varint", "dense"):
        raise ValueError(f"list_compression={flags.list_compression!r}")
    if varint:
        local_of = np.zeros(n_nodes, np.int64)
        for c in range(n_sub):
            ids_c = np.nonzero(owner == c)[0]
            local_of[ids_c] = np.arange(len(ids_c))
        part_lb = np.empty((n_sub, n_nodes), np.int64)
        for c in range(n_sub):
            rows, cols = np.nonzero((nb_owner == c) & (adj >= 0))
            part_lb[c] = _delta_coded_bytes(rows, local_of[adj[rows, cols]],
                                            n_nodes)
        full_lb = compressed_list_bytes(adj)
    else:
        part_lb = np.maximum(4 * part_size, 4).astype(np.int64)
        full_lb = np.array([_list_bytes(s) for s in full_size], np.int64)

    # address maps: per-channel NLT (4B/node) + list heap; vectors separate
    list_base = 16 * n_nodes  # leave NLT region [0, 4*N) distinct per channel
    part_addr = np.zeros((n_sub, n_nodes), np.int64)
    for c in range(n_sub):
        part_addr[c] = list_base + np.concatenate(
            [[0], np.cumsum(part_lb[c][:-1])])
    full_addr = list_base + np.concatenate([[0], np.cumsum(full_lb[:-1])])

    lnc_t = [SetAssocCache(hw.lnc_t_bytes, hw.line_bytes) for _ in range(n_sub)]
    lnc_d = [SetAssocCache(hw.lnc_d_bytes, hw.line_bytes, hw.lnc_ways_d) for _ in range(n_sub)]

    t_burst, t_feat = hw.t_burst_ns, hw.t_feature_ns
    feats_per_seg = seg

    # Per-segment sub-channel burst accounting from the real packed layout:
    # ``bursts_for_prefix`` counts per-device 128-bit bursts under the
    # burst-aligned Dfloat layout; the 4 devices of a sub-channel stream in
    # lockstep (layout rule 4), so a prefix of k features occupies
    # ceil(device_bursts / devices) 64B sub-channel burst groups — a partial
    # group still holds a burst slot.  Precomputing the table replaces the
    # per-candidate Python walk over segments and makes the EE savings in the
    # timing/energy/traffic model reflect the actual bitstream, not an
    # idealized features-times-bytes count.
    dev = max(1, dfloat_cfg.devices_per_subchannel)
    s_hi = max(dfloat_cfg.dim // max(seg, 1), int(segs.max(initial=0)))
    burst_groups = np.array(
        [-(-dfloat_cfg.bursts_for_prefix(s * feats_per_seg) // dev)
         for s in range(s_hi + 1)], np.int64)

    # Tiered storage: the coarse tier streams from near DRAM exactly like a
    # (shorter) packed row; the residual tier rides the far-memory channel —
    # a lane pays it only when it survives past the last coarse segment
    # (s_used > n_coarse_seg), so the far link's latency/bandwidth price
    # multiplies the *survivor* population, not every eval.
    tiered = tier_cfgs is not None
    if tiered:
        ccfg, rcfg = tier_cfgs
        n_coarse_seg = ccfg.dim // max(seg, 1)
        coarse_groups = np.array(
            [-(-ccfg.bursts_for_prefix(min(s, n_coarse_seg) * feats_per_seg)
               // dev) for s in range(s_hi + 1)], np.int64)
        resid_groups = np.array(
            [-(-rcfg.bursts_for_prefix(max(0, s - n_coarse_seg)
                                       * feats_per_seg) // dev)
             for s in range(s_hi + 1)], np.int64)
        far_eff_lat = hw.far_latency_ns / max(1, hw.far_prefetch_depth)

    tot_time_ns = 0.0
    t_nb = t_dist = t_part = 0.0
    dram_bytes = 0.0
    merge_flat_bytes = merge_tree_bytes = 0.0
    decode_ns_total = 0.0
    far_bytes = 0.0
    n_eval_lanes = n_resid_fetch = 0
    energy_pj = 0.0
    pf_attempts = np.zeros(hmax)
    pf_hits = np.zeros(hmax)
    idle_num = idle_den = 0.0
    lat_sum_ns = 0.0

    order = np.arange(q_total)
    for b0 in range(0, q_total, flags.batch):
        batch = order[b0 : b0 + flags.batch]
        batch_time = 0.0
        # per-(query,channel) local candidate pools: {cand: dist}
        pools = [[dict() for _ in range(n_sub)] for _ in batch]
        # per-(query,channel) predicted next-hop nodes: up to n_expand per
        # channel, matching the frontier width the searcher pops per hop
        # (one-element sets for legacy expand=1 traces)
        predictions = [[set() for _ in range(n_sub)] for _ in batch]

        for h in range(hmax):
            act = [i for i, q in enumerate(batch) if (node[q, h] >= 0).any()]
            if not act:
                break
            ch_busy = np.zeros(n_sub)
            # one broadcast command packet per hop + small per-query payload
            host_ns = hw.host_cmd_ns + 20.0 * len(act)
            n_accept_total = 0

            for i in act:
                q = batch[i]
                acc_ch = np.zeros(n_sub, np.int64)   # this hop's accepts/chan
                vs = [int(v) for v in node[q, h] if v >= 0]  # this hop's frontier
                # ---- phase 1: neighbor-list retrieval --------------------
                if flags.dam:
                    for v in vs:
                        for c in range(n_sub):
                            psz = int(part_size[c, v])
                            if psz == 0:
                                continue
                            lbytes = int(part_lb[c, v])
                            if flags.prefetch:
                                # a "hit" = the next-hop list is on-chip when the
                                # hop starts: either predicted exactly, or still
                                # resident from an earlier (pre)fetch (§V-E: failed
                                # prefetches are retained in the LNC and reused)
                                pf_attempts[h] += 1
                                if v in predictions[i][c] or (
                                    flags.lnc and lnc_d[c].contains(int(part_addr[c, v]), lbytes)
                                ):
                                    pf_hits[h] += 1
                            nlt_miss = lnc_t[c].access(4 * v, 4) if flags.lnc else 1
                            d_miss = (lnc_d[c].access(int(part_addr[c, v]), lbytes)
                                      if flags.lnc else -(-lbytes // hw.line_bytes))
                            t = hw.cache_hit_ns * 2
                            if nlt_miss:
                                t += hw.t_row_open_ns + t_burst
                                dram_bytes += hw.line_bytes
                            if d_miss:
                                t += hw.t_row_open_ns + d_miss * t_burst
                                dram_bytes += d_miss * hw.line_bytes
                            # id-decoder occupancy: varint pays a serial
                            # per-id decode (the compression's honest cost);
                            # dense consumes one 4B id per cycle.  The
                            # decoder overlaps the line stream — only the
                            # excess beyond the DRAM time lands on the
                            # critical path (hits decode from the LNC, so
                            # the full decode time is exposed).
                            cyc = (hw.varint_decode_cycles_per_id if varint
                                   else 1.0)
                            dec_ns = psz * cyc / hw.vpe_freq_ghz
                            decode_ns_total += dec_ns
                            t += max(0.0, dec_ns - d_miss * t_burst)
                            ch_busy[c] += t
                            t_nb += t
                            energy_pj += (nlt_miss + d_miss) * hw.line_bytes * 8 * hw.e_dram_pj_per_bit
                            energy_pj += lbytes * 8 * hw.e_cache_pj_per_bit
                else:
                    # host walks the NLT + list at the owner channel (Fig. 4a
                    # "index lookup" — on the critical path, not parallel)
                    for v in vs:
                        c = int(owner[v])
                        lbytes = int(full_lb[v])
                        lines = -(-lbytes // hw.line_bytes)
                        t = hw.host_nlt_lookup_ns + hw.t_row_open_ns + lines * t_burst
                        host_ns += t
                        t_nb += t
                        dram_bytes += lines * hw.line_bytes
                        energy_pj += lines * hw.line_bytes * 8 * hw.e_dram_pj_per_bit

                # ---- phase 2: distance computation -----------------------
                cand = nbrs[q, h]
                mask = cand >= 0
                for j in np.nonzero(mask)[0]:
                    cid = int(cand[j])
                    s_used = int(segs[q, h, j])
                    if s_used == 0:
                        # tombstoned lane: the sub-channel's resident bitmap
                        # vetoes the stream before the first burst
                        continue
                    n_eval_lanes += 1
                    if tiered:
                        c_grp = int(coarse_groups[s_used])
                        r_grp = int(resid_groups[s_used])
                        n_grp = c_grp + r_grp
                        stream = hw.t_row_open_ns + c_grp * t_burst
                        if s_used > n_coarse_seg:
                            # survivor: the residual words ride the far link
                            fb = r_grp * hw.burst_bytes
                            stream += far_eff_lat + fb / hw.far_bw_gbps
                            far_bytes += fb
                            n_resid_fetch += 1
                    else:
                        n_grp = int(burst_groups[s_used])  # 64B burst groups
                        stream = hw.t_row_open_ns + n_grp * t_burst
                    compute = s_used * feats_per_seg * t_feat
                    tc = max(stream, compute)
                    cc = int(owner[cid])
                    if flags.dam:
                        ch_busy[cc] += tc
                    else:
                        # whole list processed at owner(v); remote vectors
                        # cross sub-channels through the host (Fig. 4b) —
                        # v is the frontier node whose list candidate j is on
                        e_slot = (int(src[q, h, j]) if src is not None
                                  else j // m_width)
                        cv = int(owner[int(node[q, h, e_slot])])
                        ch_busy[cv] += tc
                        if cc != cv:
                            vec_bytes = n_grp * hw.burst_bytes
                            xl = -(-vec_bytes // hw.line_bytes)
                            pen = xl * hw.cross_channel_ns_per_line
                            ch_busy[cv] += pen
                            t_part += pen
                    t_dist += tc
                    dram_bytes += n_grp * hw.burst_bytes
                    energy_pj += n_grp * hw.burst_bytes * 8 * hw.e_dram_pj_per_bit
                    energy_pj += s_used * feats_per_seg * hw.e_fpu_pj_per_feature
                    d = float(cand_d[q, h, j])
                    if d < BIG / 2:
                        n_accept_total += 1
                        pools[i][int(owner[cid])][cid] = d
                        acc_ch[int(owner[cid])] += 1

                # expanded nodes leave every local pool
                for v in vs:
                    for c in range(n_sub):
                        pools[i][c].pop(v, None)

                # partial-result fabric traffic this hop, both topologies
                merge_flat_bytes += 8.0 * acc_ch.sum()
                merge_tree_bytes += tree_merge_bytes(acc_ch, flags.merge_width)

            # ---- phase 3: host merge + prefetch overlap ------------------
            merge_ns = hw.host_merge_base_ns + hw.host_merge_per_cand_ns * n_accept_total
            energy_pj += hw.e_host_nj_per_hop * 1e3 * len(act)
            pf_ns = 0.0
            if flags.prefetch and flags.dam:
                for i in act:
                    for c in range(n_sub):
                        # predict the next frontier: the n_expand nearest
                        # pool candidates per channel (1 for legacy traces)
                        near = sorted(pools[i][c], key=pools[i][c].get)
                        predictions[i][c] = set(near[:n_expand])
                        for p in predictions[i][c]:
                            if flags.lnc:
                                lnc_t[c].fill(4 * p, 4)
                                lnc_d[c].fill(int(part_addr[c, p]),
                                              int(part_lb[c, p]))
                # prefetch DRAM streams overlap the merge window
                pf_ns = 0.0

            compute_ns = ch_busy.max()
            if len(act) and ch_busy.max() > 0:
                idle_num += (ch_busy.max() - ch_busy.min())
                idle_den += ch_busy.max()
            hop_ns = compute_ns + merge_ns + host_ns + pf_ns
            t_part += merge_ns + host_ns
            batch_time += hop_ns

        tot_time_ns += batch_time
        lat_sum_ns += batch_time * len(batch)

    n_q = q_total
    qps = n_q / (tot_time_ns * 1e-9) if tot_time_ns else 0.0
    scale = 1e-3 / n_q  # ns total -> us per query
    return SimResult(
        name=name,
        qps=qps,
        avg_latency_us=lat_sum_ns / n_q * 1e-3,
        t_neighbor_us=t_nb * scale,
        t_distance_us=t_dist * scale,
        t_partial_us=t_part * scale,
        lnc_t_hit=float(np.mean([c.hit_rate for c in lnc_t])),
        lnc_d_hit=float(np.mean([c.hit_rate for c in lnc_d])),
        prefetch_hit=float(pf_hits.sum() / max(pf_attempts.sum(), 1)),
        prefetch_hit_by_hop=np.divide(pf_hits, np.maximum(pf_attempts, 1)),
        idle_frac=float(idle_num / max(idle_den, 1e-9)),
        dram_bytes_per_query=dram_bytes / n_q,
        energy_uj_per_query=energy_pj * 1e-6 / n_q,
        merge_flat_bytes_per_query=merge_flat_bytes / n_q,
        merge_tree_bytes_per_query=merge_tree_bytes / n_q,
        list_decode_occupancy=decode_ns_total / max(t_nb, 1e-9),
        survivor_fetch_fraction=(n_resid_fetch / max(n_eval_lanes, 1)
                                 if tiered else None),
        far_bytes_per_query=far_bytes / n_q,
        residual_fetches_per_query=n_resid_fetch / n_q,
    )


# ---------------------------------------------------------------------------
# streaming mutation — append/repair traffic as DRAM write bursts
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WriteStats:
    """DRAM write-side accounting of a streaming mutation workload."""

    rows_appended: int
    rows_deleted: int
    edge_writes: int            # adjacency rows rewritten (insert + repair)
    vector_write_bytes: float   # packed-row appends (burst-aligned groups)
    list_write_bytes: float     # adjacency read-modify-writes
    tombstone_write_bytes: float
    dram_bytes: float
    write_burst_groups: int
    t_write_us: float
    energy_uj: float

    def per_append_us(self) -> float:
        return self.t_write_us / max(self.rows_appended, 1)


def account_writes(stats, dfloat_cfg: DfloatConfig, hw: NDPConfig,
                   m_width: int, list_bytes_per_row: float | None = None
                   ) -> WriteStats:
    """Model append/repair traffic as sub-channel write bursts.

    * an append streams one burst-aligned packed row into the reserved tail:
      ``row_burst_groups()`` 64B groups, the sub-channel's devices in
      lockstep (layout rule 4) — the write-side mirror of the read path;
    * an adjacency rewrite is a read-modify-write of one stored list,
      rounded to 64B lines — pass ``list_bytes_per_row`` (e.g. the measured
      delta/varint average) to model compressed stored lists, else dense
      ``4 * m_width`` ids are assumed;
    * a tombstone flip dirties one line (an upper bound — the counters don't
      retain the id stream needed to dedup lines).

    ``stats`` is duck-typed: an object with ``rows_appended``,
    ``rows_deleted`` and ``edge_writes`` (the streaming mutation's stats), or
    the dict snapshot a frozen Index carries in ``timings["mutation"]``.
    """
    if isinstance(stats, dict):
        appended, deleted, edges = (stats.get("rows_appended", 0),
                                    stats.get("rows_deleted", 0),
                                    stats.get("edge_writes", 0))
    else:
        appended, deleted, edges = (stats.rows_appended, stats.rows_deleted,
                                    stats.edge_writes)
    vec_groups = appended * dfloat_cfg.row_burst_groups()
    vec_bytes = float(vec_groups * hw.burst_bytes)
    lb = 4 * m_width if list_bytes_per_row is None else list_bytes_per_row
    list_lines = edges * -(-int(lb) // hw.line_bytes)
    list_bytes = float(list_lines * hw.line_bytes)
    tomb_bytes = float(deleted * hw.line_bytes)
    total = vec_bytes + list_bytes + tomb_bytes
    groups = int(vec_groups + -(-int(list_bytes + tomb_bytes)
                                // hw.burst_bytes))
    t_ns = ((appended + edges + deleted) * hw.t_row_open_ns
            + groups * hw.t_burst_ns)
    return WriteStats(
        rows_appended=int(appended), rows_deleted=int(deleted),
        edge_writes=int(edges), vector_write_bytes=vec_bytes,
        list_write_bytes=list_bytes, tombstone_write_bytes=tomb_bytes,
        dram_bytes=total, write_burst_groups=groups,
        t_write_us=t_ns * 1e-3,
        energy_uj=total * 8 * hw.e_dram_pj_per_bit * 1e-6)


def simulate_platform(traces, dim: int, hw: PlatformConfig,
                      bytes_per_feature: float = 4.0, name: str | None = None,
                      extra_hop_ns: float = 0.0) -> SimResult:
    """Roofline model of the same trace on CPU/GPU/ASIC platforms (Fig. 15/16).

    Platforms compute full-dimension distances (no FEE) unless the trace's
    ``segs`` says otherwise; SCANN-style quantization is expressed through
    ``bytes_per_feature``.
    """
    traces = _as_trace(traces)
    node = _norm_node(traces["node"])
    nbrs = np.asarray(traces["nbrs"])
    q_total = node.shape[0]
    n_eval = (nbrs >= 0).sum(axis=(1, 2))           # per query
    hops = (node >= 0).any(axis=2).sum(axis=1)

    w_bytes = n_eval * dim * bytes_per_feature
    w_flops = n_eval * dim * 3.0                    # sub, mul, add
    t_mem = w_bytes / hw.mem_bw_gbps                # ns (GB/s == B/ns)
    t_cmp = w_flops / hw.flops_gflops
    t_trav = hops * (hw.traversal_ns_per_hop + extra_hop_ns)
    lat = np.maximum(t_mem, t_cmp) + t_trav
    # steady state: batch_parallel queries in flight, capped by the memory
    # roofline (aggregate bandwidth / bytes per query)
    qps = hw.batch_parallel * 1e9 / max(lat.mean(), 1e-9)
    qps = min(qps, 1e9 * hw.mem_bw_gbps / max(w_bytes.mean(), 1.0))
    energy = (w_bytes.mean() * 8 * hw.e_mem_pj_per_bit
              + n_eval.mean() * dim * hw.e_fpu_pj_per_feature
              + hw.e_static_w * lat.mean() / max(hw.batch_parallel, 1))
    return SimResult(
        name=name or hw.name, qps=qps, avg_latency_us=lat.mean() * 1e-3,
        t_neighbor_us=t_trav.mean() * 1e-3 * 0.6,
        t_distance_us=np.maximum(t_mem, t_cmp).mean() * 1e-3,
        t_partial_us=t_trav.mean() * 1e-3 * 0.4,
        lnc_t_hit=0.0, lnc_d_hit=0.0, prefetch_hit=0.0,
        prefetch_hit_by_hop=np.zeros(1), idle_frac=0.0,
        dram_bytes_per_query=float(w_bytes.mean()),
        energy_uj_per_query=float(energy * 1e-6),
    )
