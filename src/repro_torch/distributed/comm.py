"""The collectives of the sharded search, for shards in one process or one
shard per rank of a ``torch.distributed`` process group.

The JAX package runs its shard body under ``shard_map`` and lets XLA place
the collectives.  Here the body (``distributed.retrieval``) is written once
over a leading axis of the S shards this process holds, and a
communicator stands in for the three collectives it uses (on int32 and
f32 tensors):

  ``all_gather(x)``  (S, ...) -> (C, ...): every shard's rows, in shard
                     order (the frontier broadcast and the final results);
  ``all_to_all(x)``  (S, C, ...) -> (S, C, ...): input [s, j] is what held
                     shard s sends to shard j, output [s, j] what shard j
                     sent to held shard s (the owner-targeted delivery);
                     it issues the exchange and returns a zero-argument
                     function that waits for it and returns the output, so
                     the overlap pipeline can merge while it is in flight;
  ``sum(x)``         (S, ...) -> (...): the sum over all C shards (the
                     entry-row seed, the dead-entry flag, the go flag).

:class:`LocalShards` holds all C shards on one device, stacked on axis 0:
the all-gather is the stacked tensor itself, the all-to-all a transpose of
the (source, destination) axes and the sum one reduction over axis 0.  This
is how one card runs the backend (the counterpart of the reference's
fake-device mesh).  :class:`GroupShards` holds the shard of this rank of a
process group (``all_gather_into_tensor``, ``all_to_all_single``,
``all_reduce``); every rank calls the search with the same queries.  Gloo
runs it on CPU tensors, NCCL on CUDA tensors (one card a rank).
"""
from __future__ import annotations

import torch


class LocalShards:
    """All ``n_shards`` shards in this process, stacked on axis 0."""

    def __init__(self, n_shards: int):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = n_shards
        self.shards = tuple(range(n_shards))

    def all_gather(self, x):
        return x

    def all_to_all(self, x):
        out = x.transpose(0, 1)
        return lambda: out

    def sum(self, x):
        return x.sum(0, dtype=x.dtype)


class GroupShards:
    """One shard per rank of a ``torch.distributed`` process group (the
    default group when ``group`` is None): shard ``rank`` lives here, on
    the device the group's backend takes (the CPU for gloo, this rank's
    card for NCCL)."""

    def __init__(self, group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("GroupShards needs an initialised process group "
                               "(torch.distributed.init_process_group)")
        self._dist, self.group = dist, group
        self.n_shards = dist.get_world_size(group)
        self.shards = (dist.get_rank(group),)
        # the same collective under its newer name, where torch has it
        self._gather = (getattr(dist, "all_gather_single", None)
                        or dist.all_gather_into_tensor)

    def all_gather(self, x):
        out = x.new_empty((self.n_shards, *x.shape[1:]))
        self._gather(out, x.contiguous(), group=self.group)
        return out

    def all_to_all(self, x):
        src = x[0].contiguous()
        out = torch.empty_like(src)
        work = self._dist.all_to_all_single(out, src, group=self.group,
                                            async_op=True)

        def finish():
            work.wait()
            return out[None]

        return finish

    def sum(self, x):
        out = x[0].clone()
        self._dist.all_reduce(out, group=self.group)
        return out
