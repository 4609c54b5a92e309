"""Streaming mutation: live serving shards that take writes.

``MutableIndex`` layers row-granular mutation on the immutable
``repro_torch.index.Index``, as the JAX package's ``repro.streaming`` does:

  * in-place packed appends — burst-aligned Dfloat rows written straight into
    a pre-reserved ``db_packed`` capacity tail (doubling growth),
  * tombstone deletes — O(1) bitmap flips, masked out of scoring through the
    FEE kernels' lane mask, in-edges patched lazily,
  * incremental graph repair — greedy descent + the offline build's own
    occlusion prune over the candidate neighborhood (the candidate search
    runs on the device, over mirrors of the capacity arrays),
  * generation counter + copy-on-write ``freeze()`` snapshots, so searchers
    serve one immutable generation race-free while writes land in the next,
  * a WAL-style delta log (``save_delta`` / ``replay``): format-v3 segments
    persisted via ``repro_torch.ft.checkpoint`` beside the base artifact.

``ShardedMutableIndex`` serves a MutableIndex through the query-owner
sharded backend: slot-stable row->shard ownership (appends route to the
owning shard's capacity tail) and per-shard tombstone words folded into each
shard's FEE lane mask.
"""
from repro_torch.streaming.delta import read_segments  # noqa: F401
from repro_torch.streaming.mutable import MutableIndex, MutationStats  # noqa: F401
from repro_torch.streaming.sharded import ShardedMutableIndex  # noqa: F401
