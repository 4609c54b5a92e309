"""The mesh train step held against the one-process step, shared by the CPU
tests (``tests/torch_mesh_ranks.py``), ``chip_smoke.py`` phase 13 and the
``cuda`` tests.

:func:`step_case` runs on every rank of a live mesh.  All ranks draw the
same global weights from one seed, cut them to their blocks
(``models.convert.shard_params``) and take ``steps`` mesh steps on the
same global batches; rank 0 also takes the one-process steps from the
same weights on the same batches (under a ``MeshShape`` of the mesh's
shape, so MoE groups tokens into ``dp_size`` chunks as the mesh does) and
compares: each step's loss and ``grad_norm`` (relative), and every
parameter after the last step, gathered to the global arrays (the share of
elements outside ``rtol=2e-4, atol=2e-5`` and the largest excess in units
of ``lr``, as ``training.check.step_outside`` counts them).  With
``steps=0`` it compares the loss and every gradient leaf of one
differentiation instead (the largest error over the largest |value|).
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.axes import use_mesh
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import get_model
from repro_torch.models.check import rel_err
from repro_torch.models.convert import abstract_param_tree, params_to_numpy, shard_params
from repro_torch.training import GradCompressor, OptConfig, init_state, make_train_step
from repro_torch.training.check import loss_and_grads, step_outside, train_batch
from repro_torch.training.tree import Stacked, leaves, rebuild, spec, tensors


@dataclasses.dataclass(frozen=True)
class Case:
    arch: str
    optimizer: str = ""              # "" -> the config's
    microbatch: int = 1
    compress: bool = False
    steps: int = 3
    batch: int = 4
    seq: int = 16
    lr: float = 1e-3
    config: dict = dataclasses.field(default_factory=dict)   # ModelConfig overrides


def _batch(cfg, step: int, case: Case, device) -> dict:
    x = train_batch(cfg, 1000 + step, case.batch, case.seq)
    return {k: torch.from_numpy(v).to(device) for k, v in x.items()}


def global_leaves(tree, mesh=None, flat=None) -> list:
    """The leaves of ``tree`` (or of ``flat``: one tensor per tensor of
    it, such as its gradients), a ``Stacked`` group stacked, gathered to
    the global arrays on ``mesh`` (a live mesh), on the host in float32."""
    it = iter(tensors(tree) if flat is None else flat)
    out = []
    for leaf in leaves(tree):
        ts = [next(it) for _ in range(len(leaf) if isinstance(leaf, Stacked) else 1)]
        x = (torch.stack(ts) if isinstance(leaf, Stacked) else ts[0]).detach()
        if mesh is not None:
            x = sh.gather(x, spec(leaf), mesh)
        out.append(x.float().cpu())
    return out


def step_case(cfg, case: Case, mesh, seed: int = 0, keep: bool = False) -> dict | None:
    """One case on every rank of ``mesh``; rank 0 returns the errors, the
    others None (the module docstring).  With ``keep`` (and ``steps`` > 0)
    rank 0's result also holds ``arrays``: the initial weights and the
    gathered weights after the last step, each in the reference's tree
    layout (numpy, float32), and ``grad_norms``, so that a caller can hold
    the mesh step against another implementation from the same weights."""
    dev = mesh.device
    api = get_model(cfg, dev)
    params = api.init(api.generator(seed))
    shape = MeshShape(mesh.shape, mesh.axis_names)
    ref = copy.deepcopy(params) if mesh.rank == 0 else None
    init = params_to_numpy(cfg, ref) if keep and mesh.rank == 0 else None
    shard_params(cfg, params, mesh)
    batches = [_batch(cfg, s, case, dev) for s in range(max(case.steps, 1))]
    out = dict(case=dataclasses.asdict(case), mesh=list(mesh.shape))

    if case.steps == 0:                         # one differentiation
        with use_mesh(mesh):
            tree, loss, gs = _sharded_grads(api, params, batches[0], mesh)
            got = global_leaves(tree, mesh, gs)
        if mesh.rank != 0:
            return None
        with use_mesh(shape):
            rtree, rloss, rgs = loss_and_grads(api, ref, _numpy(batches[0]))
        want = global_leaves(rtree, flat=rgs)
        out.update(loss=rel_err(loss, rloss),
                   grads=max(rel_err(a, b) for a, b in zip(got, want)))
        return out

    opt = OptConfig(name=case.optimizer or cfg.optimizer, lr=case.lr)
    comp = GradCompressor() if case.compress else None
    state = init_state(api.param_tree(params), opt, comp)
    step = make_train_step(api.tree_loss, opt, microbatch=case.microbatch, compressor=comp,
                           mesh=mesh)
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    got = global_leaves(state.params, mesh)
    if mesh.rank != 0:
        return None
    rstate = init_state(api.param_tree(ref), opt, GradCompressor() if case.compress else None)
    rstep = make_train_step(api.tree_loss, opt, microbatch=case.microbatch,
                            compressor=GradCompressor() if case.compress else None)
    want_m = []
    with use_mesh(shape):
        for b in batches:
            rstate, m = rstep(rstate, b)
            want_m.append((float(m["loss"]), float(m["grad_norm"])))
    want = global_leaves(rstate.params)
    out.update(loss=max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(metrics, want_m)),
               grad_norm=max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(metrics, want_m)),
               losses=[m[0] for m in metrics], ref_losses=[m[0] for m in want_m],
               **step_outside(got, want, case.lr))
    if keep:
        final = rebuild(abstract_param_tree(cfg, api.abstract_params()), got)
        out.update(grad_norms=[m[1] for m in metrics],
                   arrays=dict(init=_f32(init), final=_f32(final)))
    return out


def _f32(tree):
    """A tree of tensors or arrays as numpy float32 arrays."""
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().cpu().numpy()
    return np.asarray(tree, dtype=np.float32)


def _numpy(batch: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in batch.items()}


def _sharded_grads(api, params, batch, mesh):
    """The loss (the global batch's) and this rank's gradient blocks of one
    differentiation on ``mesh`` (the mesh train step's, with no update)."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.training.train_step import _reduce_grads, _rows

    tree = api.param_tree(params)
    ts = tensors(tree)
    for t in ts:
        t.requires_grad_(True)
    rows = _rows(batch, 1, mesh)[0]
    with torch.enable_grad():
        loss, _ = api.tree_loss(tree, rows)
        gs = torch.autograd.grad(loss / mesh.dp_size, ts, allow_unused=True)
    gs = [torch.zeros_like(t) if g is None else g.detach() for t, g in zip(ts, gs)]
    with torch.no_grad():
        _reduce_grads(tree, gs, mesh)
        loss = coll.all_reduce(loss.detach(), mesh.dp_group) / mesh.dp_size
    return tree, loss, gs


# ---------------------------------------------------------------------------
# on the card: chip_smoke.py phase 13 (ranks that share one card over gloo)
# ---------------------------------------------------------------------------

FULL_ARCH = "llama3.2-1b"
FULL = dict(batch=8, seq=128, lr=3e-4, steps=4)     # 1 warm-up, then 3 timed


def full_width_run(mesh, seed: int = 0, steps: int = FULL["steps"]) -> dict:
    """llama3.2-1b at its published width (bfloat16, AdamW, microbatch 2,
    remat) on ``mesh``: the weights drawn from the seed a weight at a time
    (``models.convert.init_sharded``: ``draw_peak_gb``, a rank's peak
    while drawing, beside its ``blocks_gb`` and ``largest_weight_gb``, the
    float32 draw and the cast of the largest weight, all it may hold
    beyond its blocks), then ``steps`` steps of the step-indexed
    pipeline, each timed as a user runs it, then one more step with the
    collectives' time and traffic counted (``collectives.STATS``, which
    waits for the card around every call), and each rank's peak memory
    beside the state the rules give it (``sharding.sharded_bytes``)."""
    import time

    import torch.distributed as dist

    from repro_torch import configs as C
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed import collectives as coll
    from repro_torch.models.convert import abstract_train_state, init_sharded

    dev = mesh.device
    cfg = C.get_config(FULL_ARCH)
    api = get_model(cfg, dev)
    abstract_params = api.abstract_params()
    largest = max(t.numel() for t in abstract_params.parameters())
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_sharded(api, api.generator(seed), mesh)
    torch.cuda.synchronize(dev)
    draw_peak, blocks = torch.cuda.max_memory_allocated(dev), torch.cuda.memory_allocated(dev)
    opt = OptConfig(name=cfg.optimizer, lr=FULL["lr"])
    state = init_state(api.param_tree(params), opt)
    torch.cuda.synchronize(dev)
    init_s, init_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    abstract = abstract_train_state(cfg, abstract_params, opt)
    state_bytes = sh.sharded_bytes(abstract, sh.state_specs(abstract, mesh), mesh)
    acc_bytes = 4 * sum(t.numel() for t in tensors(state.params))
    step = make_train_step(api.tree_loss, opt, microbatch=cfg.microbatch, mesh=mesh)
    pipe = TokenPipeline(cfg.vocab, FULL["batch"], FULL["seq"], seed=1)

    def batch_at(s):
        return {k: torch.from_numpy(v).to(dev, torch.long) for k, v in pipe.batch_at(s).items()}

    losses, gnorms, step_ms = [], [], []
    for s in range(steps):
        batch = batch_at(s)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        torch.cuda.synchronize(dev)
        step_ms.append((time.perf_counter() - t1) * 1e3)
    batch = batch_at(steps)
    torch.cuda.synchronize(dev)
    coll.reset_stats(True)
    t1 = time.perf_counter()
    state, m = step(state, batch)
    float(m["loss"])
    torch.cuda.synchronize(dev)
    counted = dict(step_ms=(time.perf_counter() - t1) * 1e3, collective_ms=coll.STATS["s"] * 1e3,
                   collective_gb=coll.STATS["bytes"] / 1e9, calls=coll.STATS["calls"],
                   by=coll.STATS["by"])
    coll.reset_stats(False)
    mine = dict(rank=mesh.rank, peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                draw_peak_gb=draw_peak / 1e9, blocks_gb=blocks / 1e9,
                init_peak_gb=init_peak / 1e9, held_gb=held / 1e9,
                state_gb=state_bytes / 1e9, acc_gb=acc_bytes / 1e9)
    ranks = [None] * mesh.device_mesh.size()
    dist.all_gather_object(ranks, mine)
    timed = step_ms[1:]
    tokens = FULL["batch"] * FULL["seq"]
    del state, params
    torch.cuda.empty_cache()
    return dict(arch=FULL_ARCH, params=cfg.param_count(), mesh=list(mesh.shape),
                backend=mesh.backend, losses=losses, grad_norms=gnorms, step_ms=step_ms,
                step_ms_mean=sum(timed) / len(timed),
                tokens_per_s=tokens / (sum(timed) / len(timed)) * 1e3,
                counted_step=counted, init_s=init_s,
                largest_weight_gb=largest * (4 + cfg.dtype.itemsize) / 1e9, ranks=ranks)


def chip_rank(rank, world, dev, shape, out, launch_names=(), steps: int = FULL["steps"]):
    """A rank of ``chip_smoke.py`` phase 13 on one mesh shape: (13a) every
    smoke architecture in float32 with TF32 off: one differentiation and
    one AdamW and one Adafactor step against the one-process ones; (13b)
    :func:`full_width_run` of ``steps`` steps.  Rank 0 writes the results as JSON to ``out``,
    with the six kernels' launch counts of this process (the mesh path
    runs none of them)."""
    import json
    import time
    from pathlib import Path

    from repro_torch import configs as C
    from repro_torch.kernels import dfloat_unpack, fee_distance
    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(shape, device=dev)
    t0 = time.perf_counter()
    smoke = {}
    for arch in C.ARCHS:
        cfg = C.get_smoke(arch)
        r = [step_case(cfg, Case(arch, steps=0), mesh),
             step_case(cfg, Case(arch, optimizer="adamw", steps=1), mesh),
             step_case(cfg, Case(arch, optimizer="adafactor", steps=1), mesh)]
        if rank == 0:
            smoke[arch] = dict(loss=r[0]["loss"], grads=r[0]["grads"],
                               adamw={k: r[1][k] for k in ("share", "over_lr")},
                               adafactor={k: r[2][k] for k in ("share", "over_lr")})
    smoke_s = time.perf_counter() - t0
    full = full_width_run(mesh, steps=steps)
    mods = (fee_distance, dfloat_unpack)
    launches = {n: next(getattr(m, n).launches for m in mods if hasattr(m, n))
                for n in launch_names}
    if rank == 0:
        Path(out).write_text(json.dumps(dict(mesh=list(shape), smoke=smoke, smoke_s=smoke_s,
                                             full=full, launches=launches)))


def _full_rank(rank, world, dev, shape, out):
    import json
    from pathlib import Path

    from repro_torch.launch.mesh import make_mesh

    res = full_width_run(make_mesh(shape, device=dev))
    if rank == 0:
        Path(out).write_text(json.dumps(res))


def main(argv=None):
    """``python -m repro_torch.training.mesh_check --mesh DxM [--backend
    nccl|gloo]``: :func:`full_width_run` on the cards, one JSON line a
    mesh (every ``--mesh`` given runs in turn)."""
    import argparse
    import json
    import math
    import tempfile
    from pathlib import Path

    from repro_torch.launch.mesh import parse_mesh, spawn

    ap = argparse.ArgumentParser(description=main.__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", action="append", required=True)
    ap.add_argument("--backend", default="nccl")
    args = ap.parse_args(argv)
    for text in args.mesh:
        shape = parse_mesh(text)
        with tempfile.TemporaryDirectory() as d:
            out = Path(d) / "res.json"
            spawn(_full_rank, math.prod(shape), args=(shape, str(out)), device="cuda",
                  backend=args.backend, store=Path(d) / "store")
            print(json.dumps({"mesh_full": json.loads(out.read_text())}), flush=True)


if __name__ == "__main__":
    main()
