"""Mesh construction over the ranks of a ``torch.distributed`` group, and
the production mesh shapes.

The JAX package's ``launch/mesh.py`` on the port.  :func:`make_mesh` builds
a :class:`Mesh` over the running process group: the
``torch.distributed.device_mesh.DeviceMesh`` of the shape (ranks laid out
row-major, ``model`` the fastest axis), the group of this rank's ``model``
row, and the group of the data axes (``pod`` and ``data`` flattened, pod
major: the order of the reference's ``P(("pod", "data"))``).  Building it
is a collective: every rank calls it with the same arguments.

:func:`production_mesh_shape` gives the shapes the reference's dry run
lowers for (16 x 16, or 2 x 16 x 16 over two pods) as :class:`MeshShape`:
shapes only, with no ranks, which is all the sharding rules read.
:class:`ShapeMesh` is one rank of such a shape with no processes behind
it: its groups are ``collectives.ShapeGroup`` groups and its device the meta
device, so model code runs one rank's step on it in shapes only
(``launch/dryrun.py``).

:func:`spawn` starts the ranks of a mesh in processes of their own
(``torch.multiprocessing``, start method ``spawn``: CUDA cannot fork),
meeting at a file store (no network).  On the card NCCL takes one card a
rank and raises with fewer cards than ranks; gloo (``backend="gloo"``)
runs ranks that share the cards, the counterpart of the reference's fake
host devices.  On the CPU the ranks run gloo.
"""
from __future__ import annotations

import math
import os
import tempfile
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch import resolve_device

# NVIDIA H100 80GB HBM3 (SXM, 700 W power limit) datasheet values, a card
# (``chip_smoke.py``'s bounds read them)
PEAK_FLOPS_BF16 = 989e12       # dense bfloat16 tensor-core operations/s
HBM_BW = 3.35e12               # B/s of device memory
HBM_BYTES = 80e9               # bytes of device memory (the datasheet's 80 GB)


class MeshShape(NamedTuple):
    """A mesh's shape and axis names, with no ranks behind it."""
    shape: tuple
    axis_names: tuple


def axis_names(ndim: int) -> tuple:
    """The reference trainer's axis names for a mesh of ``ndim`` axes."""
    if ndim == 2:
        return ("data", "model")
    if ndim == 3:
        return ("pod", "data", "model")
    raise ValueError(f"a mesh has 2 or 3 axes, got {ndim}")


def production_mesh_shape(multi_pod: bool = False) -> MeshShape:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return MeshShape(shape, axis_names(len(shape)))


def parse_mesh(text: str) -> tuple:
    """``"2x4"`` or ``"2x2x4"`` as a shape."""
    return tuple(int(x) for x in text.lower().split("x"))


class Mesh:
    """A (data, model) or (pod, data, model) mesh over every rank of the
    default process group; ``device`` is where this rank's tensors live."""

    def __init__(self, shape, axes, device):
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        if not dist.is_initialized():
            raise RuntimeError("a Mesh needs an initialised process group "
                               "(torch.distributed.init_process_group)")
        self.shape, self.axis_names = tuple(shape), tuple(axes)
        if len(self.shape) != len(self.axis_names) or self.axis_names[-1] != "model":
            raise ValueError(f"mesh axes {self.axis_names} for shape {self.shape}: "
                             "the last axis is 'model'")
        world = dist.get_world_size()
        if math.prod(self.shape) != world:
            raise ValueError(f"a {self.shape} mesh needs {math.prod(self.shape)} ranks, "
                             f"the group has {world}")
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.device_mesh = init_device_mesh(self.device.type, self.shape,
                                            mesh_dim_names=self.axis_names)
        self.model_size = self.shape[-1]
        self.dp_size = world // self.model_size
        self.model_rank = self.rank % self.model_size
        self.dp_rank = self.rank // self.model_size
        self.model_group = self.device_mesh.get_group("model")
        # the data axes flattened: one group per model index (every rank
        # creates every group, in the same order)
        dp_groups = [dist.new_group([d * self.model_size + m for d in range(self.dp_size)])
                     for m in range(self.model_size)]
        self.dp_group = dp_groups[self.model_rank]
        self.world_group = dist.group.WORLD
        from repro_torch.distributed import collectives

        for group, axis in ((self.dp_group, "data"), (self.model_group, "model"),
                            (self.world_group, "all")):
            collectives.name_group(group, axis)

    def group(self, names):
        """The process group over the axes ``names`` (a set of axis names):
        the data axes' group, the model axis', every rank's, or None."""
        names = set(names)
        if not names:
            return None
        model = self.axis_names[-1]
        if model not in names:
            return self.dp_group
        return self.model_group if names == {model} else self.world_group

    def __repr__(self):
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, rank {self.rank}, "
                f"{self.backend}, {self.device})")


class ShapeMesh(Mesh):
    """Rank 0 of a mesh of ``shape`` with no processes behind it: what a
    live :class:`Mesh` gives model code (sizes, the rank's coordinates,
    groups), with ``collectives.ShapeGroup`` groups and the meta device."""

    def __init__(self, shape, axes=None):
        from repro_torch.distributed.collectives import ShapeGroup

        self.shape = tuple(shape)
        self.axis_names = tuple(axes) if axes else axis_names(len(self.shape))
        self.device, self.backend = torch.device("meta"), "shape"
        self.device_mesh = None
        self.model_size = self.shape[-1]
        self.dp_size = math.prod(self.shape) // self.model_size
        self.rank = self.model_rank = self.dp_rank = 0
        self.model_group = ShapeGroup(self.model_size, "model")
        self.dp_group = ShapeGroup(self.dp_size, "data")
        self.world_group = ShapeGroup(math.prod(self.shape), "all")


def make_mesh(shape, axes=None, device="cuda") -> Mesh:
    """A :class:`Mesh` of ``shape`` over the running process group (axes
    named as :func:`axis_names` when not given), its tensors on ``device``
    (default ``cuda``)."""
    shape = tuple(shape)
    return Mesh(shape, tuple(axes) if axes else axis_names(len(shape)),
                resolve_device(device))


def _entry(rank, fn, world, backend, device, store, args):
    import torch.distributed as dist

    if device == "cuda":
        card = rank if backend == "nccl" else rank % torch.cuda.device_count()
        torch.cuda.set_device(card)
        dev = torch.device("cuda", card)
    else:
        dev = torch.device("cpu")
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        fn(rank, world, dev, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args=(), *, device="cuda", backend=None, store=None):
    """Run ``fn(rank, world, device, *args)`` in ``world`` processes, each a
    rank of one process group (``fn`` a module-level function).
    ``backend``: ``nccl`` (default on the card: one card a rank) or
    ``gloo`` (default on the CPU; on the card, ranks share the cards).
    ``store``: the file the ranks meet at (it must not exist; default a
    new temporary directory's).  A rank's exception or exit code ends every
    rank and raises ``torch.multiprocessing.ProcessRaisedException`` or
    ``ProcessExitedException``."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cpu" and backend != "gloo":
        raise ValueError(f"CPU ranks run gloo, not {backend}")
    if dev.type == "cuda" and backend == "nccl" and world > torch.cuda.device_count():
        raise RuntimeError(f"{world} NCCL ranks need {world} cards, this machine has "
                           f"{torch.cuda.device_count()}; backend='gloo' (--backend gloo) "
                           "runs ranks that share the cards")
    if store is None:
        store = Path(tempfile.mkdtemp(prefix="repro_torch_ranks_")) / "store"
    store = Path(store)
    if store.exists():
        os.remove(store)
    store.parent.mkdir(parents=True, exist_ok=True)
    mp.start_processes(_entry, args=(fn, world, backend, dev.type, str(store), tuple(args)),
                       nprocs=world, join=True, start_method="spawn")
