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

The JAX package's ``ShardedMutableIndex`` (serving a MutableIndex through
the sharded backend) is not here: it waits for the port's sharded search
(ROADMAP queue A, item 9).
"""
from repro_torch.streaming.delta import read_segments  # noqa: F401
from repro_torch.streaming.mutable import MutableIndex, MutationStats  # noqa: F401
