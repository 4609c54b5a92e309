"""Carry an index across: the JAX package's artifact (its ``spec.json`` dict
and numpy arrays) -> a port :class:`~repro_torch.index.index.Index`.

The two packages share the on-disk format, so this is also how
``Index.load`` reads either package's artifacts.
"""
from __future__ import annotations

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import dfloat as dfl
from repro_torch.core import graph as graph_mod
from repro_torch.core import pca as pca_mod
from repro_torch.index.types import FeeFit, IndexSpec


def from_arrays(meta: dict, arrays: dict[str, np.ndarray], device):
    """Build an Index from a ``spec.json`` dict and its ``arrays.npz``
    contents (checksums are the caller's to verify)."""
    from repro_torch.index.index import Index

    spec = IndexSpec(**meta["spec"])
    a = arrays
    spca = pca_mod.SPCA(mean=a["spca_mean"], components=a["spca_components"],
                        eigvals=a["spca_eigvals"], metric=spec.metric)
    fee = FeeFit(alpha=a["fee_alpha"], beta=a["fee_beta"],
                 margin=a["fee_margin"], var_k=a["fee_var_k"],
                 seg=int(meta["fee"]["seg"]),
                 p_target=float(meta["fee"]["p_target"]),
                 metric=str(meta["fee"]["metric"]))
    dmeta = meta["dfloat"]
    dfloat_cfg = dfl.DfloatConfig(
        segments=tuple(dfl.DfloatSegment(**s) for s in dmeta["segments"]),
        burst_bits=int(dmeta["burst_bits"]),
        devices_per_subchannel=int(dmeta["devices_per_subchannel"]))
    levels = [(a[f"g_ids{i}"], a[f"g_adj{i}"])
              for i in range(int(meta["graph"]["n_levels"]))]
    graph = graph_mod.GraphIndex(levels=levels, entry=int(meta["graph"]["entry"]),
                                 m=int(meta["graph"]["m"]))
    return Index(spec=spec, spca=spca, fee=fee, dfloat_cfg=dfloat_cfg,
                 graph=graph, db_rot=a["db_rot"], db_packed=a["db_packed"],
                 device=resolve_device(device),
                 timings=meta.get("timings", {}),
                 tombstone=a.get("tombstone"),
                 generation=meta.get("generation"),
                 n_rows=meta.get("n_rows"),
                 # v1 artifacts carried the derived copy; seed the cache
                 _db_q=a.get("db_q"),
                 _tiers=((a["db_coarse"], a["db_resid"])
                         if "db_coarse" in a else None))
