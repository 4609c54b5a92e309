"""CUDA kernels: FEE-sPCA early-exit distance over f32 rows, packed Dfloat
rows or a (coarse, residual) pair of tier rows, batched over queries with the
row gather fused by id.

  ``fee_distance``          replaces ``repro/kernels/fee_distance.py::
                            fee_distance_pallas`` (``_kernel``);
  ``fee_distance_packed``   ``fee_distance_packed_pallas``, ``skip_dma=False``
                            (``_packed_kernel``, ``_decode_block``);
                            source ``csrc/fee_distance.cu``;
  ``fee_distance_skipdma``  ``fee_distance_skipdma_pallas``
                            (``_skipdma_kernel``);
  ``fee_distance_packed_skipdma``  ``fee_distance_packed_pallas``,
                            ``skip_dma=True`` (``_packed_skipdma_kernel``);
                            source ``csrc/fee_skipdma.cu``;
  ``fee_distance_tiered``   ``fee_distance_tiered_pallas`` (``_tiered_kernel``);
                            source ``csrc/fee_tiered.cu``.

The JAX kernels score one query against pre-gathered rows under ``vmap``;
these take the resident DB, (Q, L) row ids, an optional (Q, L) alive mask,
the (Q, D) queries and per-query thresholds (Q,), and launch once for every
lane of the batch.  ``fee_distance``, ``fee_distance_packed`` and
``fee_distance_tiered`` score one lane per thread: a loop over segments
inside the thread replaces the TPU's sequential grid axis, and a lane reads
segment ``s`` of its row only while it is alive — exited and dead lanes stop
moving bytes (for tiered rows: never touch the residual tier unless they pass
the coarse one).  The skip-DMA kernels copy each live lane's segment into
shared memory with ``cp.async`` while its warp's tile has a live lane, the
counterpart of the TPU's gated ``make_async_copy``: one warp loop for both,
two 32-lane tiles per warp so that one tile's copy overlaps the other's
scoring, each lane's copy in a slot of odd stride so that the warp's shared
loads are free of bank conflicts (:func:`skipdma_f32_slot`).

The three packed kernels read a FEE block through its covering bursts
(:func:`block_bursts`): the 16 B units of the row, 4-word aligned, that hold
the block's fields and carry words.  ``fee_distance_packed`` and
``fee_distance_tiered`` (per tier, from the tier's own layout:
:func:`_tier_tables`) load them with 16 B loads into registers,
``fee_distance_packed_skipdma`` copies them with 16 B ``cp.async`` into its
slots.  All three decode from the staged words in registers: a block whose
fields share one format and start a burst (:func:`block_formats`; every
block of a 16-bit run at seg = 16) with shifts fixed at compile time for its
width, any other block from a burst table whose word index is relative to
the block's first burst.  Where the rows are not 16 B aligned (row base,
pitch, or W not a multiple of 4 words) they read the same words 4 B at a
time.  Packed and tier rows may be a row view of a wider matrix
(``stride(1) == 1``, ``stride(0) >= W``): the kernels take ``stride(0)`` as
the row pitch.  All five kernels share one accumulate/exit step, so packed,
tiered and skip-DMA scores are bit-identical to f32 scores over the
emulated rows.

Bound on this card: bytes.  A live segment is a 64 B (f32) or ~32 B
(packed) gather for ~3 flops per feature; the designs read each live
segment's bytes once and no exited lane's.

Outputs are (dist, rejected, segs_used), each (Q, L): ``dist`` is the full
score for survivors, the partial score for rejected lanes, and 0 for dead
lanes (``segs_used == 0``).  The plain versions in ``ref.py`` give the same
outputs over the gathered rows ``db[ids]``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import dfloat as dfl
from repro_torch.kernels import _build, ref
from repro_torch.kernels.dfloat_unpack import check_packed, widen_constants

_LIB, _SKIP_LIB, _TIER_LIB = "fee_distance", "fee_skipdma", "fee_tiered"
P, I, LL = _build.P, _build.I, _build.LL
_F32_ARGS = (P, LL, I, P, P, P, P, P, P, P, LL, I, I, I, P, P, P, P)
_PACKED_ARGS = (P, LL, I, LL, I, P, P, I, P, P, P, P, P, P, P, LL, I, I, I,
                P, P, P, P)
_SKIP_F32_ARGS = (P, LL, I, P, P, P, P, P, P, P, LL, I, I, I, I, I, P, P, P, P)
_SKIP_PACKED_ARGS = (P, LL, I, LL, I, P, P, I, P, P, P, P, P, P, P, LL, I, I, I,
                     I, P, P, P, P)
_TIERED_ARGS = (P, P, LL, I, LL, I, LL, I, I, P, P, I, P, P, P, P, P, P, P,
                LL, I, I, I, P, P, P, P)
METRICS = {"l2": 0, "ip": 1}
SMEM_BLOCK_MAX = 232_448     # shared memory one block can use on Hopper
SKIP_WARPS = 8               # warps per block of the skip-DMA kernels
BURST_WORDS = 4              # a burst: the 16 B unit the packed kernels read
STAGE_BURSTS = (2, 4, 8, 16)  # bursts a block, as the packed kernels are built


def skip_warps(bytes_per_warp: int, fixed: int = 0) -> int:
    """Warps per block of a skip-DMA kernel: up to :data:`SKIP_WARPS`, as
    many as fit their landing buffers (``bytes_per_warp`` each, after
    ``fixed`` bytes of tables) in a block's shared memory; raises when not
    even one fits."""
    warps = min(SKIP_WARPS, (SMEM_BLOCK_MAX - fixed) // bytes_per_warp)
    if warps < 1:
        raise ValueError(f"a warp's landing buffer of {bytes_per_warp} B (after "
                         f"{fixed} B of tables) exceeds the {SMEM_BLOCK_MAX} B "
                         "of shared memory a block can use")
    return warps


def block_spans(cfg: dfl.DfloatConfig, seg: int) -> list[tuple[int, int]]:
    """The word span ``[w0, w1)`` of each FEE block of ``seg`` features in
    ``cfg``'s packed row, the carry word of a field that spans two words
    included (the reference's ``_block_positions``)."""
    pos, _ = dfl.feature_positions(cfg)
    spans = []
    for k in range(cfg.dim // seg):
        p = pos[k * seg:(k + 1) * seg]
        spans.append((min(wi for wi, _, _ in p),
                      max(wi + (ofs + sg.width > 32) for wi, ofs, sg in p) + 1))
    return spans


def block_bursts(cfg: dfl.DfloatConfig, seg: int):
    """The host layout of the packed kernels' staged decode (it has no
    counterpart in the JAX package, whose blocks decode from the word span).

    Returns ``(bursts, table)``: ``bursts[k] = (b0, b1)`` are FEE block k's
    covering bursts, the 16 B units ``[w0 // 4, ceil(w1 / 4))`` of the row
    around its word span ``[w0, w1)`` (:func:`block_spans`); ``table`` is
    the (D, 4) int32 burst table, one row per feature: bit offset | word
    index relative to word ``4 * b0`` of its block << 5, the field mask
    ``(1 << width) - 1``, and its format's mul and ebias
    (:func:`widen_constants`)."""
    bursts = [(w0 // BURST_WORDS, -(-w1 // BURST_WORDS))
              for w0, w1 in block_spans(cfg, seg)]
    pos, _ = dfl.feature_positions(cfg)
    table = np.array([(ofs | (wi - BURST_WORDS * bursts[f // seg][0]) << 5,
                       (1 << sg.width) - 1, *widen_constants(sg))
                      for f, (wi, ofs, sg) in enumerate(pos)], np.uint32)
    return bursts, table.reshape(-1, 4).view(np.int32)


def block_formats(cfg: dfl.DfloatConfig, seg: int) -> list[tuple[int, int, int]]:
    """Per FEE block, ``(width, mul, ebias)`` when its ``seg`` fields share
    one format and the first starts a 128-bit burst (its fields then lie at
    positions fixed by the width, which the kernels decode with compile-time
    shifts), else ``(0, 0, 0)`` (the kernels decode it from the burst
    table)."""
    pos, _ = dfl.feature_positions(cfg)
    out = []
    for k in range(cfg.dim // seg):
        block = pos[k * seg:(k + 1) * seg]
        sg = block[0][2]
        static = (cfg.burst_bits == 128 and all(p[2] is sg for p in block)
                  and (k * seg - sg.start) % (128 // sg.width) == 0)
        out.append((sg.width, *widen_constants(sg)) if static
                   else (0, 0, 0))
    return out


def stage_bursts(bursts) -> int:
    """The staging size of the packed kernels for these blocks: the least of
    :data:`STAGE_BURSTS` that holds every block's bursts; raises beyond."""
    most = max(b1 - b0 for b0, b1 in bursts)
    for nb in STAGE_BURSTS:
        if most <= nb:
            return nb
    raise ValueError(f"a FEE block spans {most} bursts of 16 B; the packed "
                     f"kernels stage at most {STAGE_BURSTS[-1]}: use a smaller "
                     "seg")


def block_descriptors(cfg: dfl.DfloatConfig, seg: int):
    """``(table, blocks, bursts)``: the (D, 4) burst table and covering
    bursts of :func:`block_bursts`, and the (S, 4) int32 block descriptors
    ``(b0, (b1 - b0) | width << 8, mul, ebias)`` the packed kernels read
    (width, mul and ebias from :func:`block_formats`).  A 0-feature layout
    (an empty tier) gives (0, 4) arrays and no bursts."""
    bursts, table = block_bursts(cfg, seg)
    blocks = np.array([(b0, (b1 - b0) | w << 8, mul, ebias)
                       for (b0, b1), (w, mul, ebias)
                       in zip(bursts, block_formats(cfg, seg))], np.uint32)
    return table, blocks.reshape(-1, 4).view(np.int32), bursts


@functools.lru_cache(maxsize=64)
def _burst_tables(cfg: dfl.DfloatConfig, seg: int, device: torch.device):
    """The packed kernels' (D, 4) burst table, their (S, 4) block
    descriptors and their staging size, on ``device``."""
    table, blocks, bursts = block_descriptors(cfg, seg)
    return (torch.from_numpy(table).to(device),
            torch.from_numpy(blocks).to(device), stage_bursts(bursts))


@functools.lru_cache(maxsize=64)
def _tier_tables(coarse_cfg: dfl.DfloatConfig, resid_cfg: dfl.DfloatConfig,
                 seg: int, device: torch.device):
    """The tiered kernel's tables on ``device``: the (D, 4) burst table and
    (S, 4) block descriptors of the coarse tier's Sc = Dc / seg blocks, then
    the residual tier's, each from :func:`block_descriptors` of the tier's
    own layout (word indices and b0 relative to that tier's row), and the
    staging size over both tiers' blocks.  Raises unless the split lies on
    a segment boundary (``coarse_cfg.dim % seg == 0``), as the index's
    splits at ``tier_split * seg`` do."""
    if coarse_cfg.dim % seg:
        raise ValueError(f"the tiered kernel splits on a segment boundary: "
                         f"{coarse_cfg.dim} coarse features are not a "
                         f"multiple of seg={seg}")
    (ct, cb, c_bursts), (rt, rb, r_bursts) = (
        block_descriptors(cfg, seg) for cfg in (coarse_cfg, resid_cfg))
    return (torch.from_numpy(np.concatenate([ct, rt])).to(device),
            torch.from_numpy(np.concatenate([cb, rb])).to(device),
            stage_bursts(c_bursts + r_bursts))


def skipdma_f32_slot(seg: int, vec: bool) -> int:
    """Words of a lane's slot in the f32 skip-DMA kernel: on the 16 B path
    (``vec``) the least odd count of 16 B chunks that holds ``seg`` floats
    (seg + 4 floats at seg % 8 == 0), on the 4 B path the least odd count
    of words.  An odd stride puts the 16 B (or 4 B) shared loads of eight
    (or 32) neighbouring lanes on distinct banks."""
    if vec:
        return 4 * (seg // 4 | 1)
    return seg | 1


def _check_lanes(ids, q, threshold, alpha, beta, margin, lane_mask, dim, seg,
                 metric):
    """Raise on any input the kernels do not take; returns (Q, L)."""
    dev = ids.device
    if metric not in METRICS:
        raise ValueError(f"metric={metric!r}; expected one of {tuple(METRICS)}")
    if seg <= 0 or dim % seg:
        raise ValueError(f"seg={seg} must divide dim={dim}")
    if ids.dim() != 2 or ids.dtype != torch.int32:
        raise TypeError(f"ids must be (Q, L) int32, got {ids.dtype} "
                        f"{tuple(ids.shape)}")
    n_q, lanes = ids.shape
    want = {"q": (q, torch.float32, (n_q, dim)),
            "threshold": (threshold, torch.float32, (n_q,)),
            "alpha": (alpha, torch.float32, (dim // seg,)),
            "beta": (beta, torch.float32, (dim // seg,)),
            "margin": (margin, torch.float32, (dim // seg,))}
    if lane_mask is not None:
        want["lane_mask"] = (lane_mask, torch.bool, (n_q, lanes))
    for name, (t, dtype, shape) in want.items():
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not ids.is_contiguous():
        raise ValueError("ids must be contiguous")
    return n_q, lanes


def _outputs(n_q, lanes, device):
    return (torch.empty((n_q, lanes), dtype=torch.float32, device=device),
            torch.empty((n_q, lanes), dtype=torch.bool, device=device),
            torch.empty((n_q, lanes), dtype=torch.int32, device=device))


def fee_distance(db, ids, q, threshold, alpha, beta, margin, *, seg: int,
                 metric: str = "l2", lane_mask=None):
    """Early-exit scores of rows ``db[ids]`` ((N, D) f32, (Q, L) int32 ids)
    against ``q`` (Q, D) with per-query ``threshold`` (Q,).  CPU tensors take
    the plain version."""
    if db.device.type == "cpu":
        return ref.fee_distance_gather_ref(db, ids, q, threshold, alpha, beta,
                                           margin, seg=seg, metric=metric,
                                           lane_mask=lane_mask)
    if db.dtype != torch.float32 or db.dim() != 2 or not db.is_contiguous():
        raise ValueError(f"db must be a contiguous (N, D) float32 tensor, got "
                         f"{db.dtype} {tuple(db.shape)}")
    n_q, lanes = _check_lanes(ids, q, threshold, alpha, beta, margin,
                              lane_mask, db.shape[1], seg, metric)
    dist, rej, segs = _outputs(n_q, lanes, db.device)
    fn = _build.function(_LIB, "naszip_fee_distance_f32", _F32_ARGS)
    code = fn(db.data_ptr(), db.shape[0], db.shape[1], ids.data_ptr(),
              _build.ptr(lane_mask), q.data_ptr(), threshold.data_ptr(),
              alpha.data_ptr(), beta.data_ptr(), margin.data_ptr(), n_q, lanes,
              seg, METRICS[metric], dist.data_ptr(), rej.data_ptr(),
              segs.data_ptr(), _build.stream_ptr(db))
    _build.check(_LIB, "fee_distance", code)
    fee_distance.launches += 1
    return dist, rej, segs


def fee_distance_packed(xp, ids, q, threshold, alpha, beta, margin, *,
                        dfloat_cfg: dfl.DfloatConfig, seg: int,
                        metric: str = "l2", lane_mask=None):
    """Fused Dfloat decode + early-exit scores of packed rows ``xp[ids]``
    ((N, W) int32/uint32 words of ``dfloat_cfg``'s layout, rows at any pitch
    >= W).  Bit-identical to :func:`fee_distance` over the emulated rows.
    CPU tensors take the plain version."""
    if xp.device.type == "cpu":
        return ref.fee_distance_packed_gather_ref(
            xp, ids, q, threshold, alpha, beta, margin, dfloat_cfg=dfloat_cfg,
            seg=seg, metric=metric, lane_mask=lane_mask)
    pitch = check_packed(xp, dfloat_cfg)
    dim = dfloat_cfg.dim
    n_q, lanes = _check_lanes(ids, q, threshold, alpha, beta, margin,
                              lane_mask, dim, seg, metric)
    table, blocks, nb = _burst_tables(dfloat_cfg, seg, xp.device)
    dist, rej, segs = _outputs(n_q, lanes, xp.device)
    fn = _build.function(_LIB, "naszip_fee_distance_packed", _PACKED_ARGS)
    code = fn(xp.data_ptr(), xp.shape[0], xp.shape[1], pitch, dim,
              table.data_ptr(), blocks.data_ptr(), nb, ids.data_ptr(),
              _build.ptr(lane_mask), q.data_ptr(), threshold.data_ptr(),
              alpha.data_ptr(), beta.data_ptr(), margin.data_ptr(), n_q, lanes,
              seg, METRICS[metric], dist.data_ptr(), rej.data_ptr(),
              segs.data_ptr(), _build.stream_ptr(xp))
    _build.check(_LIB, "fee_distance_packed", code)
    fee_distance_packed.launches += 1
    return dist, rej, segs


def fee_distance_skipdma(db, ids, q, threshold, alpha, beta, margin, *,
                         seg: int, metric: str = "l2", lane_mask=None):
    """:func:`fee_distance`'s contract through warp-gated ``cp.async`` copies
    of each live lane's segment; bit-identical to :func:`fee_distance`.  CPU
    tensors take the plain version."""
    if db.device.type == "cpu":
        return ref.fee_distance_gather_ref(db, ids, q, threshold, alpha, beta,
                                           margin, seg=seg, metric=metric,
                                           lane_mask=lane_mask)
    if db.dtype != torch.float32 or db.dim() != 2 or not db.is_contiguous():
        raise ValueError(f"db must be a contiguous (N, D) float32 tensor, got "
                         f"{db.dtype} {tuple(db.shape)}")
    dim = db.shape[1]
    n_q, lanes = _check_lanes(ids, q, threshold, alpha, beta, margin,
                              lane_mask, dim, seg, metric)
    # 16 B copies need seg % 4 == 0 and 16 B aligned rows; the slot's stride
    # tells the kernel which path it takes
    slot = skipdma_f32_slot(seg, seg % 4 == 0 and dim % 4 == 0
                            and db.data_ptr() % 16 == 0)
    warps = skip_warps(2 * 32 * slot * 4)        # two tiles of 32 slots a warp
    dist, rej, segs = _outputs(n_q, lanes, db.device)
    fn = _build.function(_SKIP_LIB, "naszip_fee_skipdma_f32", _SKIP_F32_ARGS)
    code = fn(db.data_ptr(), db.shape[0], dim, ids.data_ptr(),
              _build.ptr(lane_mask), q.data_ptr(), threshold.data_ptr(),
              alpha.data_ptr(), beta.data_ptr(), margin.data_ptr(), n_q, lanes,
              seg, METRICS[metric], slot, warps, dist.data_ptr(),
              rej.data_ptr(), segs.data_ptr(), _build.stream_ptr(db))
    _build.check(_SKIP_LIB, "fee_distance_skipdma", code)
    fee_distance_skipdma.launches += 1
    return dist, rej, segs


def fee_distance_packed_skipdma(xp, ids, q, threshold, alpha, beta, margin, *,
                                dfloat_cfg: dfl.DfloatConfig, seg: int,
                                metric: str = "l2", lane_mask=None):
    """:func:`fee_distance_packed`'s contract through warp-gated ``cp.async``
    copies of each live lane's covering bursts; bit-identical to
    :func:`fee_distance_packed`.  CPU tensors take the plain version."""
    if xp.device.type == "cpu":
        return ref.fee_distance_packed_gather_ref(
            xp, ids, q, threshold, alpha, beta, margin, dfloat_cfg=dfloat_cfg,
            seg=seg, metric=metric, lane_mask=lane_mask)
    pitch = check_packed(xp, dfloat_cfg)
    dim = dfloat_cfg.dim
    n_q, lanes = _check_lanes(ids, q, threshold, alpha, beta, margin,
                              lane_mask, dim, seg, metric)
    table, blocks, nb = _burst_tables(dfloat_cfg, seg, xp.device)
    # two tiles of 32 lane slots of nb + 1 bursts per warp
    warps = skip_warps(2 * 32 * (nb + 1) * 16, fixed=(dim + dim // seg) * 16)
    dist, rej, segs = _outputs(n_q, lanes, xp.device)
    fn = _build.function(_SKIP_LIB, "naszip_fee_skipdma_packed",
                         _SKIP_PACKED_ARGS)
    code = fn(xp.data_ptr(), xp.shape[0], xp.shape[1], pitch, dim,
              table.data_ptr(), blocks.data_ptr(), nb, ids.data_ptr(),
              _build.ptr(lane_mask), q.data_ptr(), threshold.data_ptr(),
              alpha.data_ptr(), beta.data_ptr(), margin.data_ptr(), n_q, lanes,
              seg, METRICS[metric], warps, dist.data_ptr(), rej.data_ptr(),
              segs.data_ptr(), _build.stream_ptr(xp))
    _build.check(_SKIP_LIB, "fee_distance_packed_skipdma", code)
    fee_distance_packed_skipdma.launches += 1
    return dist, rej, segs


def fee_distance_tiered(xc, xr, ids, q, threshold, alpha, beta, margin, *,
                        coarse_cfg: dfl.DfloatConfig,
                        resid_cfg: dfl.DfloatConfig, seg: int,
                        metric: str = "l2", lane_mask=None):
    """Fused two-tier decode + early-exit scores of the tier rows ``xc[ids]``
    ((N, Wc) words of ``coarse_cfg``) and ``xr[ids]`` ((N, Wr) words of
    ``resid_cfg``), each at any pitch >= its W: a lane reads residual words
    only for the segments it reaches past the coarse tier.  Bit-identical to
    :func:`fee_distance_packed` over the parent layout's rows at any split
    on a segment boundary, 0 and S included (the kernel raises on any other
    split; the plain version takes it).  CPU tensors take the plain
    version."""
    if xc.device.type == "cpu":
        return ref.fee_distance_tiered_gather_ref(
            xc, xr, ids, q, threshold, alpha, beta, margin,
            coarse_cfg=coarse_cfg, resid_cfg=resid_cfg, seg=seg,
            metric=metric, lane_mask=lane_mask)
    pitch_c = check_packed(xc, coarse_cfg)
    pitch_r = check_packed(xr, resid_cfg)
    if xr.device != xc.device or xr.shape[0] != xc.shape[0]:
        raise ValueError(f"tier rows disagree: coarse {tuple(xc.shape)} on "
                         f"{xc.device}, residual {tuple(xr.shape)} on {xr.device}")
    dc, dim = coarse_cfg.dim, coarse_cfg.dim + resid_cfg.dim
    n_q, lanes = _check_lanes(ids, q, threshold, alpha, beta, margin,
                              lane_mask, dim, seg, metric)
    table, blocks, nb = _tier_tables(coarse_cfg, resid_cfg, seg, xc.device)
    dist, rej, segs = _outputs(n_q, lanes, xc.device)
    fn = _build.function(_TIER_LIB, "naszip_fee_tiered", _TIERED_ARGS)
    code = fn(xc.data_ptr(), xr.data_ptr(), xc.shape[0], xc.shape[1], pitch_c,
              xr.shape[1], pitch_r, dc, dim, table.data_ptr(),
              blocks.data_ptr(), nb, ids.data_ptr(), _build.ptr(lane_mask),
              q.data_ptr(), threshold.data_ptr(), alpha.data_ptr(),
              beta.data_ptr(), margin.data_ptr(), n_q, lanes, seg,
              METRICS[metric], dist.data_ptr(), rej.data_ptr(),
              segs.data_ptr(), _build.stream_ptr(xc))
    _build.check(_TIER_LIB, "fee_distance_tiered", code)
    fee_distance_tiered.launches += 1
    return dist, rej, segs


fee_distance.launches = 0
fee_distance_packed.launches = 0
fee_distance_skipdma.launches = 0
fee_distance_packed_skipdma.launches = 0
fee_distance_tiered.launches = 0
