"""The least bytes and float32 operations of a window's FEE scoring work,
from the search's own counters (lanes scored, dims touched).

For each scored lane: the dims it touched at the storage's bytes a dim (4 B
for f32 rows, a Dfloat layout's bits / 8 for packed rows), its 4 B id, and
its outputs written once (a 4 B distance, a 1 B exit flag, a 4 B segment
count); for each query of a call its row read once (4 B a dim).  A row that
two lanes score counts twice: the counters do not say which rows repeat.
Operations: a difference, a product and a sum a touched dim for L2, a
product and a sum for inner product.
"""
from __future__ import annotations

LANE_BYTES = 4 + 4 + 1 + 4     # id in; distance, exit flag, segments out


def bytes_per_dim(storage: str, layout_bits: int | None, dim: int) -> float:
    """Bytes a touched dim of one row moves: 4 for f32 rows, else the Dfloat
    layout's ``layout_bits`` (a row's field bits) over ``dim``."""
    if storage == "f32":
        return 4.0
    if not layout_bits:
        raise ValueError(f"storage {storage!r} needs the layout's bits a row")
    return layout_bits / 8.0 / dim


def fee_work(lanes: float, dims: float, queries: float, dim: int,
             bpd: float, metric: str) -> tuple[float, float]:
    """``(bytes, flops)`` of scoring ``lanes`` lanes that touched ``dims``
    dims in all, for ``queries`` query rows of width ``dim``."""
    n_bytes = dims * bpd + lanes * LANE_BYTES + queries * dim * 4.0
    n_flops = dims * (3.0 if metric == "l2" else 2.0)
    return n_bytes, n_flops
