"""Int8 gradient compression with error feedback (distributed-optimization
trick for scale-out: 4x less gradient all-reduce traffic).

The JAX package's ``training/compress.py`` on the port.  Two entry points:
  * ``compress_decompress`` — quantize->dequantize with an error-feedback
    residual carried in TrainState (used inside the train step; models the
    numerics of a compressed all-reduce).  Each leaf's scale is the global
    leaf's largest |g|: on a mesh every rank's block's largest, all-reduced
    (one ``all_reduce(MAX)`` for every leaf).
  * ``compressed_psum`` — int8-quantize locally against a scale shared by
    every member (an ``all_reduce(MAX)``), sum the integer payload (an
    ``all_reduce(SUM)`` in int32: the actual 4x wire saving), dequantize
    and divide by the member count; the error feedback is the local
    residual.  It runs over a ``torch.distributed`` process group where the
    reference names a ``shard_map`` axis; with no group it is the identity
    over one member.

A ``Stacked`` leaf (per-layer tensors the reference holds as one array) is
quantized as the reference's one array: one scale over the stack.  ``round``
is half to even, as ``jnp.round``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives as coll

from repro_torch.training.tree import leaves, like, rebuild, stack, stacked_zeros


@dataclasses.dataclass(frozen=True)
class GradCompressor:
    bits: int = 8

    @property
    def levels(self) -> float:
        return float(2 ** (self.bits - 1) - 1)

    def init_error(self, params):
        return rebuild(params, [stacked_zeros(p) for p in leaves(params)])

    def _quant(self, g):
        scale = g.abs().max() / self.levels + 1e-30
        q = torch.clamp(torch.round(g / scale), -self.levels, self.levels)
        return q.to(torch.int8), scale

    @torch.no_grad()
    def compress_decompress(self, grads, error_fb, mesh=None):
        """Quantize each leaf against its largest |g| (on ``mesh``, a live
        ``launch.mesh.Mesh``, the global leaf's: every rank's largest
        all-reduced), dequantize, and carry the residual."""
        pairs = list(zip(leaves(grads), leaves(error_fb)))
        if not pairs:
            return grads, error_fb
        # a leaf at a time (no float32 copy of every gradient at once)
        gmax = torch.stack([(stack(g, torch.float32) + e).abs().max() for g, e in pairs])
        if mesh is not None:
            gmax = coll.all_reduce(gmax, mesh.world_group, op="max")
        deq, err = [], []
        for (g, e), m in zip(pairs, gmax):
            g32 = stack(g, torch.float32) + e
            scale = m / self.levels + 1e-30
            q = torch.clamp(torch.round(g32 / scale), -self.levels, self.levels)
            d = q.to(torch.int8).to(torch.float32) * scale
            deq.append(like(g, d))
            err.append(g32 - d)
        return rebuild(grads, deq), rebuild(grads, err)

    @torch.no_grad()
    def compressed_psum(self, grads, error_fb, group=None):
        """int8 wire format over ``group`` (a ``torch.distributed`` process
        group; None: this process alone), f32 recovery + error feedback."""
        n = 1 if group is None else dist.get_world_size(group)
        deq, err = [], []
        for g, e in zip(leaves(grads), leaves(error_fb)):
            g32 = stack(g, torch.float32) + e
            _, smax = self._quant(g32)
            # one scale for every member (the largest), then the integer
            # payloads summed in int32
            if group is not None:
                dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
            q = torch.round(g32 / smax).to(torch.int32)
            total = q.clone()
            if group is not None:
                dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
            deq.append(like(g, total.to(torch.float32) * smax / n))
            err.append(g32 - q.to(torch.float32) * smax)
        return rebuild(grads, deq), rebuild(grads, err)
