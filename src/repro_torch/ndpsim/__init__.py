"""Trace-driven DIMM-NDP performance model (UniNDP stand-in, §VI-A).

Host-side numpy, as in the JAX package; it replays the traces of the port's
search.  What it reports is a projection of the paper's hardware.
"""
from repro_torch.ndpsim.cache import SetAssocCache  # noqa: F401
from repro_torch.ndpsim.engine import (  # noqa: F401
    SimFlags, SimResult, WriteStats, account_writes, compressed_list_bytes,
    simulate_ndp, simulate_platform, tree_merge_bytes)
from repro_torch.ndpsim import timing  # noqa: F401
