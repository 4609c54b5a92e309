"""Kernel dispatcher: the names the search loop calls.

``backend`` takes the JAX package's ``fee_backend`` strings, so a reference
``SearchParams`` works unchanged:

  * ``auto`` / ``pallas`` — the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (the wrapper decides from the tensor's device);
  * ``jnp`` — the plain PyTorch version on either device (the comparison run
    of ``chip_smoke.py``);
  * ``pallas_skip_dma`` — the manual-DMA TPU kernels (``fee_distance.py::
    fee_distance_skipdma_pallas``, ``fee_distance_packed_pallas(skip_dma=
    True)``), not ported yet: ROADMAP queue B, item 4.

A default call never takes the plain version on a CUDA tensor.  The
tombstone fold (the reference's ``_fold_lane_mask``) is ``ref.fold_lane_mask``
on the plain path and happens inside the kernels on the card.
"""
from __future__ import annotations

from repro_torch.core import dfloat as dfl
from repro_torch.kernels import dfloat_unpack as unpack_kernel
from repro_torch.kernels import fee_distance as fee_kernel
from repro_torch.kernels import ref

BACKENDS = ("auto", "jnp", "pallas", "pallas_skip_dma")


def _plain(backend: str) -> bool:
    if backend == "pallas_skip_dma":
        raise NotImplementedError(
            'fee_backend="pallas_skip_dma" (the manual-DMA TPU kernels) is not '
            "ported to CUDA yet: see ROADMAP.md queue B, item 4")
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
    fn = ref.fee_distance_gather_ref if _plain(backend) else fee_kernel.fee_distance
    return fn(db, ids, q, threshold, alpha, beta, margin, seg=seg,
              metric=metric, lane_mask=lane_mask)


def fee_distance_packed(xp, ids, q, threshold, alpha, beta, margin, *,
                        dfloat_cfg: dfl.DfloatConfig, seg: int,
                        metric: str = "l2", backend: str = "auto",
                        lane_mask=None):
    """Fused Dfloat decode + early-exit scores straight from the packed
    bitstream rows ``xp[ids]`` — bit-compatible with :func:`fee_distance`
    over ``dfloat.emulate_db`` data."""
    fn = (ref.fee_distance_packed_gather_ref if _plain(backend)
          else fee_kernel.fee_distance_packed)
    return fn(xp, ids, q, threshold, alpha, beta, margin, dfloat_cfg=dfloat_cfg,
              seg=seg, metric=metric, lane_mask=lane_mask)


def dfloat_unpack_rows(packed, cfg: dfl.DfloatConfig, *, backend: str = "auto"):
    """Packed-row decode: (C, W) words -> (C, D) f32, bit-exact."""
    if _plain(backend):
        return ref.dfloat_unpack_ref(packed, cfg)
    return unpack_kernel.dfloat_unpack(packed, cfg)


# the Dfloat process module over a whole packed DB is the same decode
dfloat_unpack = dfloat_unpack_rows
