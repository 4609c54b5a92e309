"""Query-owner sharded search (the JAX package's ``repro.distributed``
retrieval; its LM-stack modules ``sharding`` and ``axes`` wait for the
port of the LM stack).  ``retrieval`` holds the shard body and its device
layout, ``comm`` the collectives it runs on: shards stacked in one process
(``LocalShards``) or one shard per rank of a ``torch.distributed`` group
(``GroupShards``)."""
from repro_torch.distributed.comm import GroupShards, LocalShards  # noqa: F401
