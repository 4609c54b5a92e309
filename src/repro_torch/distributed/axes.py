"""The ambient mesh, and the weight use sites of model code on it.

The JAX package's ``distributed/axes.py`` on the port.  Model code never
names mesh axes; it asks for "dp" (all data-parallel axes: pod+data) or
"model", resolved against the mesh in scope (:func:`use_mesh`, which the
trainer enters where the reference enters ``compat.set_mesh``).  With no
mesh in scope every function here is the identity or its one-device value.

A mesh in scope is either live (a ``launch.mesh.Mesh`` over the ranks of a
process group: each rank holds its rows of the batch and its blocks of the
weights) or a shape only (``launch.mesh.MeshShape``: one process holding
the global arrays, as the reference's program is written; only
:func:`dp_size` reads it, so MoE groups its tokens as the reference does).

On a live mesh in train mode each weight is stored in the rules' layout
(``distributed/sharding.py``; FSDP over the data axes, TP/EP over
``model``) and its use site asks for its use layout:

  * :func:`weight_use` moves a weight from storage to use: the data axes
    gathered, ``model`` on the dimension ``tp_spec`` names (which may be
    another one than storage's: the rules shard the input of ``wi``/``wg``
    and the output of ``wo`` over ``model``, the use sites the other way
    round), and hands the call site its local block.  Its backward turns
    the block's gradient back into the storage layout: gathered over
    ``model`` where the use split a dimension storage did not, cut to
    storage's block, reduce-scattered over the data axes (the counterpart
    of the reference's ``_pin_fn`` custom VJP).  A stored dimension with
    no data axis keeps this rank's partial sum; the train step all-reduces
    those leaves over the data axes once a step.
  * :func:`linear` completes a product over ``model`` with a collective
    (Megatron's conjugate pairs): an output dimension split over ``model``
    is all-gathered (its input's gradient all-reduced), a split contraction
    dimension all-reduced (its input cut to the block, the gradient
    all-gathered), a split expert axis all-gathered.  Every activation
    that leaves a call site is whole on ``model``, so the code between
    call sites runs unchanged and each model rank computes it alike.

Serving on a mesh (the reference's ``set_mode("serve")``, weights stored
in their use layout) is not ported yet.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.distributed import collectives as coll

_AMBIENT = {"mesh": None}


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a live ``Mesh`` or a ``MeshShape``) the ambient mesh."""
    prev = _AMBIENT["mesh"]
    _AMBIENT["mesh"] = mesh
    try:
        yield mesh
    finally:
        _AMBIENT["mesh"] = prev


def live():
    """The ambient mesh when it is live (has ranks behind it), else None."""
    mesh = _AMBIENT["mesh"]
    return mesh if hasattr(mesh, "model_group") else None


def dp_size() -> int:
    """Total data-parallel way count of the ambient mesh (1 if none)."""
    mesh = _AMBIENT["mesh"]
    if mesh is None:
        return 1
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    n = 1
    for a in ("pod", "data"):
        n *= sizes.get(a, 1)
    return int(n)


def constrain(x, *spec):
    """The reference's activation layout hint.  The port's activations are
    this rank's rows and whole on ``model`` between use sites, so there is
    nothing to move: the identity."""
    return x


# ---------------------------------------------------------------------------
# storage layout of a weight and the use layout its call site asks for
# ---------------------------------------------------------------------------


def storage_spec(w) -> tuple:
    """The storage spec of a weight's block (set by ``models.convert`` when
    it shards the weights; a weight without one is whole)."""
    return getattr(w, "mesh_spec", None) or (None,) * w.ndim


def _model_dim(spec, mesh):
    """The dimension stored split over ``model`` (None when the axis is 1)."""
    model = mesh.axis_names[-1]
    if mesh.model_size == 1:
        return None
    return next((i for i, e in enumerate(spec) if e == model), None)


def _dp_dim(spec, mesh):
    """The dimension stored split over the data axes (None when they are 1)."""
    model = mesh.axis_names[-1]
    if mesh.dp_size == 1:
        return None
    return next((i for i, e in enumerate(spec) if e is not None and e != model), None)


def _use_dim(w, tp_spec, mesh):
    """The dimension the use layout splits over ``model``: the one
    ``tp_spec`` names, when ``model`` divides its global size."""
    if mesh.model_size == 1 or "model" not in tp_spec:
        return None
    i = tp_spec.index("model")
    e = storage_spec(w)[i]
    ways = 1 if e is None else mesh.model_size if e == mesh.axis_names[-1] else mesh.dp_size
    return i if (w.shape[i] * ways) % mesh.model_size == 0 else None


class _Use(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, mesh, a, b, u):
        ctx.mesh, ctx.dims = mesh, (a, b, u)
        x = w
        if a is not None:
            x = coll.all_gather(x, a, mesh.dp_group)
        if b is not None and b != u:
            x = coll.all_gather(x, b, mesh.model_group)
        if u is not None and u != b:
            x = coll.block(x, u, mesh.model_rank, mesh.model_size).contiguous()
        return x

    @staticmethod
    def backward(ctx, g):
        mesh, (a, b, u) = ctx.mesh, ctx.dims
        if u is not None and u != b:
            g = coll.all_gather(g, u, mesh.model_group)
        if b is not None and b != u:
            g = coll.block(g, b, mesh.model_rank, mesh.model_size)
        if a is not None:
            g = coll.reduce_scatter(g, a, mesh.dp_group)
        return g.contiguous(), None, None, None, None


def weight_use(w, dep, *tp_spec):
    """Weight use-site hook: ``w``'s block in the use layout ``tp_spec``
    asks for (entries "model" or None, one a dimension) on the live mesh
    in scope; ``w`` itself with no live mesh.  ``dep`` is
    the activation the weight meets (kept for the reference's
    signature)."""
    mesh = live()
    if mesh is None:
        return w
    spec = storage_spec(w)
    a, b = _dp_dim(spec, mesh), _model_dim(spec, mesh)
    u = _use_dim(w, tp_spec, mesh)
    if a is None and b == u:
        return w
    return _Use.apply(w, mesh, a, b, u)


# ---------------------------------------------------------------------------
# Megatron's conjugate pairs over the model axis
# ---------------------------------------------------------------------------


class _Copy(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over ``model``."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return coll.all_reduce(g, ctx.mesh.model_group), None


class _Reduce(torch.autograd.Function):
    """All-reduce over ``model`` forward; the gradient as it comes."""

    @staticmethod
    def forward(ctx, x, mesh):
        return coll.all_reduce(x, mesh.model_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``model``; the gradient's own block."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return coll.all_gather(x, dim, mesh.model_group)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return coll.block(g, ctx.dim, m.model_rank, m.model_size).contiguous(), None, None


class _Scatter(torch.autograd.Function):
    """This rank's block along ``dim``; the gradient all-gathered."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return coll.block(x, dim, mesh.model_rank, mesh.model_size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return coll.all_gather(g, ctx.dim, ctx.mesh.model_group), None, None


def linear(x, w, *tp_spec, transpose: bool = False):
    """``x @ w`` (``x @ w.T`` with ``transpose``) at a weight use site:
    ``weight_use(w, x, *tp_spec)``, the product of the local blocks, and
    the collective over ``model`` that completes it.  ``w`` is (in, out)
    (``tp_spec`` (None, "model") splits the output, ("model", None) the
    contraction) or experts (E, in, out) against ``x`` (..., E, C, in)
    (("model", None, None) splits the experts)."""
    wl = weight_use(w, x, *tp_spec)
    mesh = live()
    u = None if mesh is None else _use_dim(w, tp_spec, mesh)
    if transpose:
        wl = wl.T
        u = None if u is None else 1 - u
    if u is None:
        return torch.matmul(x, wl)
    if wl.ndim == 2 and u == 1:                 # output features over model
        return _Gather.apply(torch.matmul(_Copy.apply(x, mesh), wl), mesh, x.ndim - 1)
    if wl.ndim == 2 and u == 0:                 # contraction over model
        return _Reduce.apply(torch.matmul(_Scatter.apply(x, mesh, x.ndim - 1), wl), mesh)
    if wl.ndim == 3 and u == 0:                 # experts over model
        y = torch.matmul(_Scatter.apply(x, mesh, x.ndim - 3), wl)
        return _Gather.apply(y, mesh, y.ndim - 3)
    raise ValueError(f"no product for a {tuple(w.shape)} weight used as {tp_spec}")


def embed_lookup(table, tokens):
    """``table[tokens]`` at the embedding's use site: the table's rows over
    ``model`` (its storage), each rank looking up the tokens of its rows
    and the partial lookups all-reduced over ``model``."""
    wl = weight_use(table, tokens, "model", None)
    mesh = live()
    if mesh is None or _use_dim(table, ("model", None), mesh) is None:
        return wl[tokens]
    rows = wl.shape[0]
    local = tokens - mesh.model_rank * rows
    hit = (local >= 0) & (local < rows)
    out = wl[torch.where(hit, local, 0)] * hit[..., None].to(wl.dtype)
    return _Reduce.apply(out, mesh)


@torch.no_grad()
def dp_sum(x):
    """The sum of ``x`` over the data axes of the live mesh (no gradient);
    ``x`` itself with none."""
    mesh = live()
    return x if mesh is None else coll.all_reduce(x, mesh.dp_group)
