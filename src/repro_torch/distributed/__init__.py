"""The JAX package's ``repro.distributed`` on the port: the query-owner
sharded search (``retrieval``, its shard body and device layout; ``comm``,
the collectives it runs on: shards stacked in one process,
``LocalShards``, or one shard per rank of a ``torch.distributed`` group,
``GroupShards``), and training on a (data, model) mesh of ranks
(``sharding``, the path-keyed rules; ``axes``, the ambient mesh and the
weight use sites; ``collectives``, what they run on).  The reference's
``compat`` (a JAX-version bridge) has no counterpart."""
from repro_torch.distributed.comm import GroupShards, LocalShards  # noqa: F401
