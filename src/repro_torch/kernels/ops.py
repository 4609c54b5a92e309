"""Kernel dispatcher: the names the search loop calls.

``backend`` takes the JAX package's ``fee_backend`` strings, so a reference
``SearchParams`` works unchanged:

  * ``auto`` / ``pallas`` — the CUDA kernels for CUDA tensors, the plain
    versions for CPU tensors (each wrapper decides from the tensor's device);
  * ``pallas_skip_dma`` — the same, with the f32 and packed FEE scores taken
    by the skip-DMA kernels (``fee_distance_skipdma``,
    ``fee_distance_packed_skipdma``: warp-gated ``cp.async`` copies, the
    counterparts of the TPU's manual-DMA kernels).  The tiered kernel gates
    its residual reads itself under every backend, and ``dfloat_unpack_rows``
    launches the ``dfloat_unpack`` kernel here too: the reference takes its
    jnp decoder there, but the port runs no plain version on the card and
    the bits are the same;
  * ``jnp`` — the plain PyTorch versions on either device (the comparison
    run of ``chip_smoke.py``).

The beam search hop's frontier step (:func:`frontier`) follows the same
rule: the ``frontier`` kernel for CUDA tensors under any backend but
``jnp``, traced or not; its plain version on the CPU and under ``jnp``.
The descent (:func:`descend`) takes no backend: the ``descend`` kernel for
CUDA tensors, its plain version on the CPU.

A default call never takes the plain version on a CUDA tensor.  The
tombstone fold (the reference's ``_fold_lane_mask``) is ``ref.fold_lane_mask``
on the plain path and happens inside the kernels on the card.  One contract
difference from the reference, in an output nothing reads: a dead lane's
``dist`` is 0 here (the partial score of the zero segments it streams),
where the reference leaves whatever its backend computed.  Matching that
would mean reading the bytes of every lane the search masks out, non-fresh
lanes included; the search sets every rejected lane's candidate distance to
BIG either way.
"""
from __future__ import annotations

import torch

from repro_torch.core import dfloat as dfl
from repro_torch.kernels import descend as descend_kernel
from repro_torch.kernels import dfloat_unpack as unpack_kernel
from repro_torch.kernels import fee_distance as fee_kernel
from repro_torch.kernels import frontier as frontier_kernel
from repro_torch.kernels import ref

BACKENDS = ("auto", "jnp", "pallas", "pallas_skip_dma")


def _plain(backend: str) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}; expected one of {BACKENDS}")
    return backend == "jnp"


def fee_distance(db, ids, q, threshold, alpha, beta, margin, *, seg: int,
                 metric: str = "l2", backend: str = "auto", lane_mask=None):
    """Early-exit scores of rows ``db[ids]`` vs queries ``q`` (batched).

    Returns (dist, rejected, segs_used), each (Q, L); dist is partial for
    rejected lanes.  ``lane_mask`` ((Q, L) bool, False = dead lane) joins the
    exit mask before any segment is charged.
    """
    if _plain(backend):
        fn = ref.fee_distance_gather_ref
    elif backend == "pallas_skip_dma":
        fn = fee_kernel.fee_distance_skipdma
    else:
        fn = fee_kernel.fee_distance
    return fn(db, ids, q, threshold, alpha, beta, margin, seg=seg,
              metric=metric, lane_mask=lane_mask)


def fee_distance_packed(xp, ids, q, threshold, alpha, beta, margin, *,
                        dfloat_cfg: dfl.DfloatConfig, seg: int,
                        metric: str = "l2", backend: str = "auto",
                        lane_mask=None):
    """Fused Dfloat decode + early-exit scores straight from the packed
    bitstream rows ``xp[ids]`` — bit-compatible with :func:`fee_distance`
    over ``dfloat.emulate_db`` data."""
    if _plain(backend):
        fn = ref.fee_distance_packed_gather_ref
    elif backend == "pallas_skip_dma":
        fn = fee_kernel.fee_distance_packed_skipdma
    else:
        fn = fee_kernel.fee_distance_packed
    return fn(xp, ids, q, threshold, alpha, beta, margin, dfloat_cfg=dfloat_cfg,
              seg=seg, metric=metric, lane_mask=lane_mask)


def fee_distance_tiered(xc, xr, ids, q, threshold, alpha, beta, margin, *,
                        coarse_cfg: dfl.DfloatConfig,
                        resid_cfg: dfl.DfloatConfig, seg: int,
                        metric: str = "l2", backend: str = "auto",
                        lane_mask=None):
    """Tiered fused decode + early-exit scores: the coarse-tier rows
    ``xc[ids]`` make the exit decisions, residual-tier rows ``xr[ids]`` are
    read only by lanes that survive them.  Bit-identical to
    :func:`fee_distance_packed` over the parent layout's rows at any split;
    a lane fetched the residual tier iff ``segs_used > coarse_cfg.dim //
    seg``."""
    fn = (ref.fee_distance_tiered_gather_ref if _plain(backend)
          else fee_kernel.fee_distance_tiered)
    return fn(xc, xr, ids, q, threshold, alpha, beta, margin,
              coarse_cfg=coarse_cfg, resid_cfg=resid_cfg, seg=seg,
              metric=metric, lane_mask=lane_mask)


def fee_distance_stale(db, ids, q, exit_threshold, admit_threshold, alpha,
                       beta, margin, *, seg: int, metric: str = "l2",
                       backend: str = "auto", lane_mask=None,
                       dfloat_cfg=None):
    """Threshold-carrying FEE for the sharded and double-buffered hop.

    Lanes exit against ``exit_threshold`` ((Q,); in the overlap pipeline the
    previous hop's beam bound, never below the current one, so it can only
    admit extra lanes: the exit test is monotone in the threshold), and the
    survivors are filtered by ``admit_threshold`` ((Q,)) on their full
    distances.  Returns ``(dist, admit, segs_used)``: ``admit`` is True for
    lanes that survived both, the *opposite* sense of ``rejected``.

    ``dfloat_cfg`` picks the storage: None scores f32 rows ``db[ids]``
    (:func:`fee_distance`), one layout packed rows
    (:func:`fee_distance_packed`), a (coarse, residual) pair of layouts the
    tier pair ``db`` = (coarse rows, residual rows)
    (:func:`fee_distance_tiered`)."""
    common = dict(seg=seg, metric=metric, backend=backend, lane_mask=lane_mask)
    if dfloat_cfg is None:
        out = fee_distance(db, ids, q, exit_threshold, alpha, beta, margin,
                           **common)
    elif isinstance(dfloat_cfg, tuple):
        out = fee_distance_tiered(db[0], db[1], ids, q, exit_threshold, alpha,
                                  beta, margin, coarse_cfg=dfloat_cfg[0],
                                  resid_cfg=dfloat_cfg[1], **common)
    else:
        out = fee_distance_packed(db, ids, q, exit_threshold, alpha, beta,
                                  margin, dfloat_cfg=dfloat_cfg, **common)
    dist, rejected, segs_used = out
    admit_thr = torch.as_tensor(admit_threshold, dtype=dist.dtype, device=dist.device)
    return dist, ~rejected & (dist < admit_thr.reshape(-1, 1)), segs_used


def dfloat_unpack_rows(packed, cfg: dfl.DfloatConfig, *, ids=None,
                       backend: str = "auto"):
    """Packed-row decode: rows ``ids`` ((C,) int64, gathered inside the
    kernel) of the (N, W) words, or all N, -> (C, D) f32, bit-exact."""
    if _plain(backend):
        return ref.dfloat_unpack_ref(packed, cfg, ids)
    return unpack_kernel.dfloat_unpack(packed, cfg, ids=ids)


def dfloat_unpack_tiered_rows(xc, xr, coarse_cfg: dfl.DfloatConfig,
                              resid_cfg: dfl.DfloatConfig, *, ids=None,
                              backend: str = "auto"):
    """Decode a (coarse, residual) tier-row pair (rows ``ids`` of it) back
    to (C, D) f32 — bit-exact vs :func:`dfloat_unpack_rows` on the parent
    layout's rows.  Each tier's launch writes its own columns of one output
    matrix; an empty tier decodes nothing."""
    if _plain(backend):
        return ref.dfloat_unpack_tiered_ref(xc, xr, coarse_cfg, resid_cfg, ids)
    n = xc.shape[0] if ids is None else ids.shape[0]
    out = torch.empty((n, coarse_cfg.dim + resid_cfg.dim), dtype=torch.float32,
                      device=xc.device)
    if coarse_cfg.dim:
        unpack_kernel.dfloat_unpack(xc, coarse_cfg, ids=ids, out=out)
    if resid_cfg.dim:
        unpack_kernel.dfloat_unpack(xr, resid_cfg, ids=ids, out=out,
                                    col=coarse_cfg.dim)
    return out


# the Dfloat process module over a whole packed DB is the same decode
dfloat_unpack = dfloat_unpack_rows


def frontier_on_card(device: torch.device, backend: str) -> bool:
    """Whether :func:`frontier` launches the ``frontier`` kernel for a hop
    on ``device``: off the CPU, under any backend but ``jnp``."""
    return not _plain(backend) and device.type != "cpu"


def frontier(nodes, sel, adj, visited, width: int, *, backend: str = "auto"):
    """One hop's frontier step (``kernels/frontier.py``): the neighbour ids
    of the popped ``nodes`` (Q, E) deduped against ``visited`` and across
    the hop, compacted fresh-first to ``width`` lanes -> (nbrs, safe, fresh,
    src), each (Q, width); the kept fresh ids are marked in ``visited`` in
    place.  Bit-identical on either route."""
    fn = (frontier_kernel.frontier if frontier_on_card(visited.device, backend)
          else ref.frontier_ref)
    return fn(nodes, sel, adj, visited, width)


# the descent through the upper levels (``kernels/descend.py``) -> (entries
# (Q,) int32, moves (L,) int32, the levels the kernel walked): the wrapper
# takes the plain version ``ref.descend_ref`` for CPU tensors itself
descend = descend_kernel.descend


# the wrappers whose ``.launches`` count their kernel's launches
COUNTED = (fee_kernel.fee_distance, fee_kernel.fee_distance_packed,
           fee_kernel.fee_distance_skipdma, fee_kernel.fee_distance_packed_skipdma,
           fee_kernel.fee_distance_tiered, unpack_kernel.dfloat_unpack,
           frontier_kernel.frontier, descend_kernel.descend)


def launch_counts() -> list[int]:
    """Each kernel's launches so far, in :data:`COUNTED` order."""
    return [f.launches for f in COUNTED]


def add_launches(counts, times: int) -> None:
    """Add ``times`` x ``counts`` (:func:`launch_counts` order) to the
    kernels' launch counts: a CUDA graph's replay launches its captured
    kernels without passing through their wrappers."""
    for f, n in zip(COUNTED, counts):
        f.launches += n * times


def fee_tables(dfloat_cfg, seg: int, device) -> None:
    """Build, where not cached yet, the device tables that the packed and
    tiered FEE kernels read for rows of ``dfloat_cfg`` (a layout, a
    (coarse, residual) pair of layouts, or None for f32 rows, which need
    none).  Building one waits for its copy to the device, which a CUDA
    graph capture may not do, so a search that captures builds them first."""
    if isinstance(dfloat_cfg, tuple):
        fee_kernel._tier_tables(*dfloat_cfg, seg, device)
    elif dfloat_cfg is not None:
        fee_kernel._burst_tables(dfloat_cfg, seg, device)
