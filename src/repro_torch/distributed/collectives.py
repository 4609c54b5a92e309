"""The collectives of training on a mesh: all-gather, reduce-scatter and
all-reduce along one dimension over one process group of a
``launch.mesh.Mesh`` (its data axes, its model axis, or every rank).

A group of one rank is the identity, with no call.  NCCL runs the
collectives natively; on gloo the all-gather is one broadcast a rank and
the reduce-scatter an exchange or one reduce a block, which gloo moves
faster over loopback than its own all-gather and reduce-scatter (the
results are the same): llama3.2-1b's full-width step at (2, 1) on two
gloo ranks sharing an NVIDIA H100 80GB HBM3 (700 W) takes 12.4-15.7 s
with them against 24.1-24.8 s with gloo's own, which would add about a
minute to ``chip_smoke.py``'s phase 13 (``PERF.md`` §6).  gloo does not take CUDA tensors
in every collective, so on a gloo group whose tensors are on the card the
buffers move through the host, in the open: the first such call logs a
line on standard error.  That is the transport of the backend the caller
chose (``--backend gloo``, ranks that share a card), never a fallback:
an NCCL group is never swapped for gloo.

``STATS`` counts the calls, the bytes handed in and the seconds spent in
the collectives while it is on (``reset_stats``), in all and by kind, axis
and size (``STATS["by"]``: calls, bytes, seconds); off, it costs a flag
test a call.

A :class:`ShapeGroup` is a group of ranks with no processes behind it
(``launch.mesh.ShapeMesh``, the dry run's one rank of a production mesh):
a collective over it gives an output on the meta device of the shape it
would have, and is counted like any other.
"""
from __future__ import annotations

import contextlib
import sys
import time

import torch
import torch.distributed as dist

_SAID = {"host": False}
# the same collectives under their newer names, where torch has them
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
# the time and traffic of the collectives, counted while ``STATS["on"]``
# (each call then waits for the card before and after: a measurement mode)
STATS = {"on": False, "calls": 0, "bytes": 0, "s": 0.0, "by": {}}
# the axis each group runs over, for the counts (``launch.mesh.Mesh`` names
# its groups)
_AXIS = {}


def name_group(group, axis: str):
    _AXIS[id(group)] = axis


class ShapeGroup:
    """``size`` ranks along ``axis`` with no processes: collectives over it
    give meta outputs of the right shape (the module docstring)."""

    def __init__(self, size: int, axis: str):
        self.size = size
        name_group(self, axis)


def reset_stats(on: bool = True):
    STATS.update(on=on, calls=0, bytes=0, s=0.0, by={})


@contextlib.contextmanager
def _span(x, kind: str, group):
    """Count one collective of ``kind`` on ``x`` over ``group`` (by kind,
    by the group's axis and by size of ``x``: under 1 MB, under 16 MB,
    above)."""
    if not STATS["on"]:
        yield
        return
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    yield
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    dt, nbytes = time.perf_counter() - t0, x.numel() * x.element_size()
    STATS["s"] += dt
    STATS["calls"] += 1
    STATS["bytes"] += nbytes
    size = "<1MB" if nbytes < 1 << 20 else "<16MB" if nbytes < 16 << 20 else ">=16MB"
    axis = _AXIS.get(id(group), "group")
    row = STATS["by"].setdefault(f"{kind} {axis} {size}", [0, 0, 0.0])
    row[0] += 1
    row[1] += nbytes
    row[2] += dt


def _size(group) -> int:
    return group.size if isinstance(group, ShapeGroup) else dist.get_world_size(group)


def _through_host(x, group) -> bool:
    if not (x.is_cuda and dist.get_backend(group) == "gloo"):
        return False
    if not _SAID["host"]:
        _SAID["host"] = True
        print(f"[collectives] rank {dist.get_rank()}: gloo group on CUDA tensors: "
              "buffers move through the host", file=sys.stderr, flush=True)
    return True


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` in page-locked host memory (torch's caching host allocator):
    the card's copies to and from it run at the link's rate."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _gloo_all_gather(out, src, group):
    """gloo's all-gather as one broadcast a rank: 2-3x the rate of its own
    all-gather over loopback (134 MB: 0.13 s against 0.42 s at 2 ranks)."""
    me, ranks = dist.get_rank(group), dist.get_process_group_ranks(group)
    for i, (r, b) in enumerate(zip(ranks, out.chunk(len(ranks)))):
        if i == me:
            b.copy_(src)
        dist.broadcast(b, src=r, group=group)


def _gloo_reduce_scatter(out, src, group):
    """gloo's reduce-scatter: at 2 ranks an exchange of the block the other
    owns (two broadcasts) and one sum; above, one reduce a block to its
    owner (both faster than its own reduce-scatter over loopback)."""
    me, ranks = dist.get_rank(group), dist.get_process_group_ranks(group)
    blocks = src.chunk(len(ranks))
    if len(ranks) == 2:
        other = torch.empty_like(blocks[0])
        for i, r in enumerate(ranks):
            dist.broadcast(blocks[1 - i] if i == me else other, src=r, group=group)
        torch.add(blocks[me], other, out=out)
        return
    for i, r in enumerate(ranks):
        buf = blocks[i].clone()
        dist.reduce(buf, dst=r, group=group)
        if i == me:
            out.copy_(buf)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, in group-rank order."""
    n = _size(group)
    if n == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    if isinstance(group, ShapeGroup):
        with _span(x, "all_gather", group):
            out = src.new_empty((n * src.shape[0], *src.shape[1:]), device="meta")
        return out.movedim(0, dim)
    host = _through_host(x, group)
    with _span(x, "all_gather", group):
        if host:
            src = _host_copy(src)
        out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=src.dtype,
                          device=src.device, pin_memory=host)
        if _gloo(group):
            _gloo_all_gather(out, src, group)
        else:
            _ALL_GATHER(out, src, group=group)
        if host:
            out = out.to(x.device)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of every rank's ``x``, this rank's block along ``dim``."""
    n = _size(group)
    if n == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    if isinstance(group, ShapeGroup):
        with _span(x, "reduce_scatter", group):
            out = src.new_empty((src.shape[0] // n, *src.shape[1:]), device="meta")
        return out.movedim(0, dim)
    host = _through_host(x, group)
    with _span(x, "reduce_scatter", group):
        if host:
            src = _host_copy(src)
        out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=src.dtype,
                          device=src.device, pin_memory=host)
        if _gloo(group):
            _gloo_reduce_scatter(out, src, group)
        else:
            _REDUCE_SCATTER(out, src, group=group)
        if host:
            out = out.to(x.device)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (or ``op="max"``) of every rank's ``x``, as a new tensor."""
    if _size(group) == 1:
        return x
    if isinstance(group, ShapeGroup):
        with _span(x, "all_reduce", group):
            return x.new_empty(x.shape, device="meta")
    host = _through_host(x, group)
    with _span(x, "all_reduce", group):
        out = _host_copy(x.detach()) if host else x.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=group)
        if host:
            out = out.to(x.device)
    return out


def block(x: torch.Tensor, dim: int, index: int, n: int) -> torch.Tensor:
    """Block ``index`` of ``n`` equal blocks of ``x`` along ``dim``."""
    size = x.shape[dim] // n
    return x.narrow(dim, index * size, size)
