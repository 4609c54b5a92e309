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

In serve mode (:func:`set_mode`, the reference's ``set_mode("serve")``)
each weight is stored in the rules' serve layout (``param_specs(mode=
"serve")``: TP over ``model``, experts over the data axes and their inner
dimension over ``model``, nothing FSDP) and is used as stored:

  * :func:`weight_use` passes the stored block through, with no collective
    (a decode step moves no weight: regathering a layer's weights a step
    would dominate decode traffic, as the reference's docstring says).
  * :func:`linear` completes the product over ``model`` along the
    dimension the weight is *stored* split on, which for ``wi``/``wg`` and
    the FFN's ``wo`` is not the one ``tp_spec`` names: an output split
    all-gathers the output, an input split cuts the activation to its block
    and all-reduces.  Both are activation-sized (what GSPMD makes of the
    reference's no-op use sites).  Experts stored over the data axes take
    every data rank's dispatch buffer (one all-gather over the data axes),
    run the rank's own experts and give every rank its rows of every
    expert's output (a second all-gather).
  * :func:`embed_lookup` and the tied head behave the same way (the rows of
    the table over ``model``: a masked lookup and an all-reduce; the tied
    head's vocabulary: an output split).

A decode cache on a live mesh is cut by the rules' cache layout
(``models.convert.shard_cache``: K/V sequence over ``model``, SSM heads
and conv channels over ``model``, batch over the data axes), in either
mode; each cache block carries its spec (``mesh_spec``) and
:func:`block_of` tells the model code which block of a dimension a rank
holds.  :data:`WEIGHT_MOVES` counts the collectives :func:`weight_use`
makes (none in serve mode).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.distributed import collectives as coll

_AMBIENT = {"mesh": None}
_MODE = {"mode": "train"}
# the collectives the weight use sites make (``_Use``): calls and bytes
WEIGHT_MOVES = {"calls": 0, "bytes": 0}


def set_mode(mode: str) -> str:
    """"train": weights stored FSDP(dp)+TP(model), moved to their use layout
    at each use site.  "serve": weights stored in their final TP/EP layout
    (``param_specs(mode="serve")``) and used as stored (the module
    docstring).  Returns the mode it replaces."""
    if mode not in ("train", "serve"):
        raise ValueError(f"mode is 'train' or 'serve', not {mode!r}")
    prev, _MODE["mode"] = _MODE["mode"], mode
    return prev


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


def current_axes():
    """(the data axes, the model axis) of the ambient mesh: ``((), None)``
    with none."""
    mesh = _AMBIENT["mesh"]
    names = tuple(getattr(mesh, "axis_names", ()) or ())
    model = "model" if "model" in names else None
    return tuple(n for n in names if n in ("pod", "data")), model


def block_of(t, dim: int) -> tuple[int, int]:
    """(this rank's block index, the number of blocks) of ``t``'s dimension
    ``dim`` over ``model`` on the live mesh in scope, by ``t``'s spec
    (``mesh_spec``); (0, 1) when ``model`` does not split it or with no
    live mesh."""
    mesh = live()
    if mesh is None or dim % t.ndim != _model_dim(storage_spec(t), mesh):
        return 0, 1
    return mesh.model_rank, mesh.model_size


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


def _moved(x):
    WEIGHT_MOVES["calls"] += 1
    WEIGHT_MOVES["bytes"] += x.numel() * x.element_size()


class _Use(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, mesh, a, b, u):
        ctx.mesh, ctx.dims = mesh, (a, b, u)
        x = w
        if a is not None:
            _moved(x)
            x = coll.all_gather(x, a, mesh.dp_group)
        if b is not None and b != u:
            _moved(x)
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
    signature).  In serve mode the stored block itself."""
    mesh = live()
    if mesh is None or _MODE["mode"] == "serve":
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
    (("model", None, None) splits the experts).  In serve mode the split
    is the one ``w`` is stored with, whatever ``tp_spec`` names."""
    mesh = live()
    if mesh is not None and _MODE["mode"] == "serve":
        return _serve_linear(x, w, mesh, transpose)
    wl = weight_use(w, x, *tp_spec)
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


def _model_product(x, wl, u, mesh):
    """``x @ wl`` of a block ``wl`` split over ``model`` on dimension ``u``
    (of its last two; None: whole), completed: an output split
    all-gathered, an input split all-reduced over the activation's block."""
    if u is None:
        return torch.matmul(x, wl)
    if u == wl.ndim - 1:
        return _Gather.apply(torch.matmul(_Copy.apply(x, mesh), wl), mesh, x.ndim - 1)
    return _Reduce.apply(torch.matmul(_Scatter.apply(x, mesh, x.ndim - 1), wl), mesh)


def _serve_linear(x, w, mesh, transpose: bool):
    """:func:`linear` in serve mode: ``w`` used as stored (no collective on
    the weight), the product completed over ``model`` along the dimension
    it is stored split on, and experts stored over the data axes run where
    they lie (the module docstring)."""
    spec = storage_spec(w)
    u = _model_dim(spec, mesh)
    a = _dp_dim(spec, mesh)
    if w.ndim == 2:
        if a is not None:
            raise ValueError(f"a {tuple(w.shape)} weight stored over the data axes "
                             f"({spec}) in serve mode: shard it with mode='serve'")
        if transpose:
            w, u = w.T, None if u is None else 1 - u
        return _model_product(x, w, u, mesh)
    if w.ndim != 3 or transpose or a not in (None, 0):
        raise ValueError(f"no serve product for a {tuple(w.shape)} weight stored as {spec}")
    if a is None:
        return _model_product(x, w, u, mesh)
    # experts over the data axes: every data rank's (1, E, C, D) buffer,
    # this rank's experts of each, then every data rank's rows of every
    # expert's output, of which this rank keeps its own
    e = x.ndim - 3
    xs = coll.all_gather(x, 0, mesh.dp_group)
    xs = coll.block(xs, e, mesh.dp_rank, mesh.dp_size)
    y = coll.all_gather(_model_product(xs, w, u, mesh), e, mesh.dp_group)
    return coll.block(y, 0, mesh.dp_rank, mesh.dp_size)


def embed_lookup(table, tokens):
    """``table[tokens]`` at the embedding's use site: the table's rows over
    ``model`` (its storage), each rank looking up the tokens of its rows
    and the partial lookups all-reduced over ``model``."""
    wl = weight_use(table, tokens, "model", None)
    mesh = live()
    if mesh is None:
        return wl[tokens]
    if _MODE["mode"] == "serve":
        u = _model_dim(storage_spec(table), mesh)
        if u not in (None, 0):
            raise ValueError(f"an embedding stored as {storage_spec(table)}")
    else:
        u = _use_dim(table, ("model", None), mesh)
    if u is None:
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
