"""CUDA kernel: the beam search hop's frontier step, from the popped nodes to
the compacted lanes the FEE kernel scores.

Replaces no TPU kernel: the JAX package leaves this step to XLA
(``repro/core/search.py::_hop_body``), and the port ran it as ~20 torch ops
(the adjacency gather, the visited gather and bit test,
``first_occurrence_mask``'s (Q, E*M, E*M) pairwise compare, an argsort of
the fresh mask and three gathers, the visited ``scatter_add_``).  Source:
``csrc/frontier.cu``; plain version: ``ref.frontier_ref``.  One warp a query
gathers its E*M neighbour ids into shared memory, tests their visited bits,
marks the first fresh occurrence of each id by comparing against the
earlier slots, writes the stable fresh-first partition cut to ``width``
lanes from ballot prefix counts and sets the kept fresh ids' visited bits
with ``atomicOr``.  Integer work only: the outputs and the visited words are
the plain version's bit for bit.

Bound on this card: bytes (the ids, one random visited word a slot, the
outputs), and the latency of the dependent id and visited-word loads.  The
launch allocates nothing but its outputs and does not synchronise, so a
hop captured as a CUDA graph replays it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

_LIB = "frontier"
_ARGS = (_build.P, _build.P, _build.P, _build.P, _build.LL, _build.LL, _build.I,
         _build.I, _build.I, _build.P, _build.P, _build.P, _build.P, _build.P)
MAX_SLOTS = 1024    # E*M a launch takes (csrc/frontier.cu's kMaxSlots)


def _check(nodes, sel, adj, visited, width) -> None:
    """Raise unless the inputs are what the kernel reads: contiguous int32
    ``nodes`` (Q, E), bool ``sel`` (Q, E), int32 ``adj`` (N, M) and int32
    ``visited`` (Q, W) on one CUDA device, E*M within :data:`MAX_SLOTS` and
    ``width`` within 1..E*M (M when E == 1)."""
    if visited.device.type != "cuda":
        raise ValueError(f"frontier: the kernel takes CUDA tensors, got {visited.device}")
    named = dict(nodes=nodes, sel=sel, adj=adj, visited=visited)
    for name, t in named.items():
        want = torch.bool if name == "sel" else torch.int32
        if t.dtype != want or t.dim() != 2 or not t.is_contiguous():
            raise TypeError(f"frontier: {name} must be a contiguous {want} matrix, got "
                            f"{t.dtype} {tuple(t.shape)} strides {t.stride()}")
        if t.device != visited.device:
            raise ValueError(f"frontier: {name} on {t.device}, visited on {visited.device}")
    n_q, e = nodes.shape
    m = adj.shape[1]
    if tuple(sel.shape) != (n_q, e) or visited.shape[0] != n_q:
        raise ValueError(f"frontier: nodes {tuple(nodes.shape)}, sel {tuple(sel.shape)} "
                         f"and visited {tuple(visited.shape)} disagree on the queries")
    if not 1 <= e * m <= MAX_SLOTS:
        raise ValueError(f"frontier: E*M = {e}*{m} = {e * m} slots; the kernel takes "
                         f"1..{MAX_SLOTS}")
    if not 1 <= width <= e * m or (e == 1 and width != m):
        raise ValueError(f"frontier: width {width} for E={e}, M={m}; expected 1..E*M "
                         "(M when E == 1)")


def frontier(nodes: torch.Tensor, sel: torch.Tensor, adj: torch.Tensor,
             visited: torch.Tensor, width: int):
    """One hop's frontier step for each query: the E*M neighbour ids of the
    popped ``nodes`` (Q, E) (``sel`` marks the real pops), deduped against
    the ``visited`` bitmap (Q, ceil(N/32)) int32 words and across the hop,
    compacted fresh-first to ``width`` lanes (slot order kept when E == 1).
    Returns (nbrs, safe, fresh, src), each (Q, width): the raw ids, the ids
    clamped to >= 0, the fresh lanes and each lane's pop slot; sets the
    kept fresh ids' bits of ``visited`` in place.  CPU tensors take the
    plain version."""
    if visited.device.type == "cpu":
        return ref.frontier_ref(nodes, sel, adj, visited, width)
    _check(nodes, sel, adj, visited, width)
    n_q = nodes.shape[0]
    out = lambda dt: torch.empty((n_q, width), dtype=dt, device=visited.device)
    nbrs, safe, fresh, src = out(torch.int32), out(torch.int32), out(torch.bool), out(torch.int32)
    fn = _build.function(_LIB, "naszip_frontier", _ARGS)
    code = fn(nodes.data_ptr(), sel.data_ptr(), adj.data_ptr(), visited.data_ptr(),
              visited.shape[1], n_q, nodes.shape[1], adj.shape[1], width, nbrs.data_ptr(),
              safe.data_ptr(), fresh.data_ptr(), src.data_ptr(), _build.stream_ptr(visited))
    _build.check(_LIB, "frontier", code)
    frontier.launches += 1
    return nbrs, safe, fresh, src


frontier.launches = 0
