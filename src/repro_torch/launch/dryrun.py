"""Dry run of every (arch x shape x mesh) cell at the production mesh shapes.

The JAX package's ``launch/dryrun.py`` on the port.  The reference lowers
and compiles each cell with XLA on 512 fake host devices and reads the
compiler's memory and cost analyses and the collectives of its HLO.  The
card has no fake-device compiler, so the port runs **one rank's step on
the meta device under a shape-only mesh** (``launch.mesh.ShapeMesh``):

  * the weights (``convert.shard_params``), the optimizer state and the
    decode cache (``convert.shard_cache``) are that rank's blocks of the
    rules' layout, as tensors of their shapes with no storage: their bytes
    are the per-rank state (``state``), where the reference reads
    ``memory_analysis``' argument bytes;
  * each collective gives a meta output of the right shape and is counted
    by kind and axis (``distributed.collectives``: the bytes handed in),
    where the reference parses the compiled HLO;
  * ``torch.utils.flop_counter.FlopCounterMode`` counts the FLOPs, where
    the reference reads ``cost_analysis``.

Train cells run a train step in the train layout; prefill, decode and
long-context cells run a prefill or one decode step in the serve layout
(``axes.set_mode("serve")``).  As the reference does for its FLOPs, the
pass runs the model cut to 1 and to 2 layer groups and recovers the whole
model's counts exactly (every count is affine in the groups):
``f(G) = f(1) + (G - 1) * (f(2) - f(1))``.

:func:`analytic_memory` is the reference's per-device budget from the
sharding rules plus the activation terms, number for number (held equal
to the reference's on every cell by ``tests/test_torch_dryrun.py``), with
the fit read against the card's memory (``fits_hbm``: the H100's 80 GB,
``launch.mesh.HBM_BYTES``) where the reference reads a TPU's 16 GB.

Each cell writes one JSON record to ``build/dryrun/`` at the root of the
checkout (``--out``); a cell that fails is recorded with ``ok: false`` and
its error, never hidden.  ``launch/report.py`` renders the table.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k [--multi-pod]
  python -m repro_torch.launch.dryrun --retrieval [--multi-pod]
  python -m repro_torch.launch.dryrun --all            # every cell, both meshes
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch import configs as C
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as mesh_mod

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
GB = 2**30


def _shape(shape) -> C.ShapeSpec:
    return C.SHAPES[shape] if isinstance(shape, str) else shape


def analytic_memory(arch, shape_name, mesh) -> dict:
    """Per-device memory budget (GiB) from the sharding specs and the
    activation terms: the reference's ``analytic_memory``, with
    ``shape_name`` a name of ``C.SHAPES`` (or a ``ShapeSpec``) and ``mesh``
    anything with ``axis_names`` and ``shape`` (``launch.mesh.MeshShape``).
    ``fits_hbm``: ``total_gb`` within the card's memory."""
    from repro_torch.models import get_model
    from repro_torch.models.convert import abstract_param_tree, abstract_train_state, cache_tree
    from repro_torch.training import OptConfig

    cfg, shape = C.get_config(arch), _shape(shape_name)
    mode = "train" if shape.kind == "train" else "serve"
    api = get_model(cfg, "cpu")
    params_abs = abstract_param_tree(cfg, api.abstract_params())
    pspecs = sh.param_specs(params_abs, mesh, mode=mode)
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    dp, tp = sizes.get("data", 1) * sizes.get("pod", 1), sizes.get("model", 1)
    out = dict(params_gb=sh.sharded_bytes(params_abs, pspecs, mesh) / GB)

    d, v = cfg.d_model, cfg.vocab
    leaves = list(sh.flat(params_abs).values())
    if shape.kind == "train":
        opt_abs = abstract_train_state(cfg, api.abstract_params(),
                                       OptConfig(name=cfg.optimizer))[".opt_state"]
        ospecs = sh.opt_specs(opt_abs, pspecs, mesh)
        mb = max(cfg.microbatch, 1)
        tokens_dev = shape.seq_len * shape.global_batch // (mb * dp)
        gbytes = 2 if cfg.grad_acc_dtype == "bf16" else 4
        grads_gb = sum(x.numel() * gbytes for x in leaves) / GB / (dp * tp)
        stacks_gb = cfg.n_groups * tokens_dev * d * 2 / GB
        ff_loc = max(cfg.d_ff, cfg.d_inner if cfg.ssm_state else 0, d) / tp
        transient_gb = 4 * tokens_dev * max(ff_loc, d) * 4 / GB
        logits_gb = 2 * tokens_dev * (v / tp) * 4 / GB
        # per-iteration FSDP gather transient: one group's largest weight
        # slice, model-sharded, x2 live (fwd + bwd recompute overlap)
        gather_gb = 2 * max((x.numel() * x.element_size() / (x.shape[0] if x.ndim >= 3 else 1)
                             for x in leaves), default=0) / tp / GB
        out.update(opt_gb=sh.sharded_bytes(opt_abs, ospecs, mesh) / GB,
                   grads_gb=grads_gb, act_stacks_gb=stacks_gb,
                   transient_gb=transient_gb, logits_gb=logits_gb,
                   weight_gather_gb=gather_gb)
    else:
        cache_abs = cache_tree(cfg, api.abstract_cache(shape.global_batch, shape.seq_len))
        cspecs = sh.cache_specs(cache_abs, mesh)
        out.update(cache_gb=sh.sharded_bytes(cache_abs, cspecs, mesh) / GB)
        if shape.kind == "prefill":
            tokens_dev = shape.seq_len * shape.global_batch // dp
            ff_loc = max(cfg.d_ff, cfg.d_inner if cfg.ssm_state else 0, d) / tp
            out["act_gb"] = 4 * tokens_dev * max(ff_loc, d) * 4 / GB
        else:
            out["act_gb"] = 4 * shape.global_batch * max(d, v // tp) * 4 / GB
    out["total_gb"] = round(sum(v for k, v in out.items() if k.endswith("_gb")), 3)
    out["fits_hbm"] = out["total_gb"] * GB <= mesh_mod.HBM_BYTES
    return {k: (round(v, 3) if isinstance(v, float) else v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# one rank's step on the meta device
# ---------------------------------------------------------------------------


def _cut(cfg, n_groups: int):
    """``cfg`` cut to ``n_groups`` layer groups (whisper: its encoder too)."""
    repl = dict(n_layers=n_groups * cfg.period)
    if cfg.is_encdec:
        repl["encoder_layers"] = n_groups
    return dataclasses.replace(cfg, **repl)


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def meta_pass(cfg, shape, mesh_shape, mode: str | None = None) -> dict:
    """One rank's step of ``cfg`` at ``shape`` on rank 0 of ``mesh_shape``
    (a ``MeshShape``), every tensor on the meta device: the state it holds
    (bytes of its blocks: params, opt or cache), the FLOPs it runs and the
    collectives it calls (by kind and by kind and axis).  ``mode``: the
    weights' layout (default: train for a train cell, serve otherwise)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.axes import set_mode, use_mesh
    from repro_torch.models import get_model
    from repro_torch.models.convert import shard_params
    from repro_torch.training import OptConfig, init_state, make_train_step
    from repro_torch.training.tree import tensors

    shape = _shape(shape)
    mode = mode or ("train" if shape.kind == "train" else "serve")
    mesh = mesh_mod.ShapeMesh(mesh_shape.shape, mesh_shape.axis_names)
    api = get_model(cfg, "cpu")
    batch = {k: v.long() if v.dtype == torch.int32 else v
             for k, v in C.input_specs(cfg, shape).items()}
    state = {}
    prev = set_mode(mode)
    coll.reset_stats(True)
    try:
        with use_mesh(mesh), FlopCounterMode(display=False) as fc:
            params = shard_params(cfg, api.abstract_params(), mesh, mode=mode)
            state["params_bytes"] = _bytes(params.parameters())
            if shape.kind == "train":
                opt = OptConfig(name=cfg.optimizer)
                ts = init_state(api.param_tree(params), opt)
                state["opt_bytes"] = _bytes(tensors(ts.opt_state))
                step = make_train_step(api.tree_loss, opt, microbatch=max(cfg.microbatch, 1),
                                       mesh=mesh)
                step(ts, batch)
            else:
                mine = {k: sh.shard(v, sh.batch_specs({k: v}, mesh)[k], mesh)
                        for k, v in batch.items() if k != "labels"}
                if shape.kind == "prefill":
                    if cfg.is_encdec:
                        mine = dict(frames=mine["frames"])
                    _, cache = api.prefill(params, mine, shape.seq_len)
                else:
                    cache = api.init_cache(mine["tokens"].shape[0], shape.seq_len,
                                           device="meta")
                    # the last slot (whisper: the self window's)
                    cache["pos"] = (cfg.decoder_self_window if cfg.is_encdec
                                    else shape.seq_len) - 1
                    api.decode(params, cache, mine["tokens"])
                state["cache_bytes"] = _bytes(_cache_leaves(cfg, cache))
    finally:
        set_mode(prev)
        stats = dict(coll.STATS)
        coll.reset_stats(False)
    colls = dict(total_bytes=stats["bytes"], total_count=stats["calls"], by_axis={})
    for key, (calls, nbytes, _) in stats["by"].items():
        kind, axis, _ = key.split(" ")
        for table, k in ((colls, kind), (colls["by_axis"], f"{kind} {axis}")):
            row = table.setdefault(k, {"count": 0, "bytes": 0})
            row["count"] += calls
            row["bytes"] += nbytes
    return dict(state=state, flops=int(fc.get_total_flops()), collectives=colls)


def _cache_leaves(cfg, cache):
    if cfg.is_encdec:
        return [cache[k] for k in ("self_k", "self_v", "cross_k", "cross_v")]
    return [t for layer in cache["layers"] for t in layer.values()]


def _affine(a, b, groups: int):
    """The whole model's count from the 1- and 2-group passes' (trees of
    numbers; a key one pass lacks counts 0 there)."""
    if isinstance(a, dict) or isinstance(b, dict):
        a, b = a or {}, b or {}
        return {k: _affine(a.get(k), b.get(k), groups) for k in {**a, **b}}
    a, b = a or 0, b or 0
    return a + (groups - 1) * (b - a)


def run_pass(arch: str, shape, mesh_shape, mode: str | None = None) -> dict:
    """:func:`meta_pass` at 1 and 2 layer groups, recovered to the whole
    model (the module docstring): the record's ``state``, ``flops`` and
    ``collectives``, and ``pass_s``."""
    cfg = C.get_config(arch)
    t0 = time.perf_counter()
    one = meta_pass(_cut(cfg, 1), shape, mesh_shape, mode)
    two = meta_pass(_cut(cfg, 2), shape, mesh_shape, mode) if cfg.n_groups > 1 else one
    rec = _affine(one, two, cfg.n_groups)
    rec.update(pass_s=round(time.perf_counter() - t0, 2),
               group_extrapolation=dict(groups=cfg.n_groups))
    return rec


# ---------------------------------------------------------------------------
# the paper's own workload: the sharded searcher at BigANN-1B scale
# ---------------------------------------------------------------------------


def retrieval_state(mesh_shape, n: int = 1_000_000_000, d: int = 128, m_part: int = 8,
                    ef: int = 64, batch: int = 1024) -> dict:
    """The sharded searcher's per-rank state at the reference's dry-run
    shape (``dryrun.py:229``): one shard of n rows a ``model`` rank
    (bfloat16 rows, its slots' ids, its neighbour partitions over every
    row, the reference's ``abstract_db``), as ``distributed.retrieval.
    ShardedDB`` tensors on the meta device, and the queries of this rank's
    data block; bytes by array, and the per-query collective payload of
    the owner-sharded search (``retrieval.collective_payload``)."""
    from repro_torch.core.search import SearchConfig
    from repro_torch.distributed import retrieval as rt

    c = mesh_shape.shape[-1]
    dp = max(1, int(torch.tensor(mesh_shape.shape[:-1]).prod()))
    n_loc = -(-n // c)
    meta = lambda s, dt: torch.empty(s, dtype=dt, device="meta")
    db = rt.ShardedDB(vectors=meta((1, n_loc, d), torch.bfloat16),
                      local_ids=meta((1, n_loc), torch.int32),
                      part_adj=meta((1, n, m_part), torch.int32))
    arrays = dict(vectors=db.vectors, local_ids=db.local_ids, part_adj=db.part_adj,
                  queries=meta((batch // dp, d), torch.float32),
                  entries=meta((batch // dp,), torch.int32))
    by = {k: t.numel() * t.element_size() for k, t in arrays.items()}
    cfg = SearchConfig(ef=ef, k=10, metric="l2", seg=16, use_fee=True, max_hops=2 * ef)
    return dict(state=dict(by, total_bytes=sum(by.values())),
                collective_payload=rt.collective_payload(cfg, m_part, c),
                workload=dict(n=n, d=d, m_part=m_part, ef=ef, batch=batch, shards=c))


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, multi_pod: bool, force: bool = False,
             out_dir: Path = OUT_DIR) -> dict:
    """One cell's record (cached as JSON in ``out_dir``)."""
    tag = f"{arch}__{shape_name}__{'multi' if multi_pod else 'single'}"
    out_file = Path(out_dir) / f"{tag}.json"
    if out_file.exists() and not force:
        return json.loads(out_file.read_text())
    out_file.parent.mkdir(parents=True, exist_ok=True)
    mesh = mesh_mod.production_mesh_shape(multi_pod)
    meta = dict(arch=arch, shape=shape_name, mesh="x".join(map(str, mesh.shape)),
                chips=int(torch.tensor(mesh.shape).prod()))
    try:
        if arch == "retrieval-bigann1b":
            rec = dict(meta, ok=True, **retrieval_state(mesh), meta_pass=None,
                       why_no_meta_pass="the sharded search's hop loop ends on a test of "
                       "its live lanes read on the host, which tensors on the meta device "
                       "cannot answer: the record holds the per-rank state and the "
                       "reference's per-query payload model")
        else:
            cfg = C.get_config(arch)
            ok, why = C.shape_applicable(cfg, shape_name)
            if not ok:
                rec = dict(meta, ok=False, skipped=True, reason=why)
            else:
                kind = C.SHAPES[shape_name].kind
                rec = dict(meta, ok=True, mode="train" if kind == "train" else "serve",
                           **run_pass(arch, shape_name, mesh))
                rec["analytic_memory"] = analytic_memory(arch, shape_name, mesh)
    except Exception as e:  # noqa: BLE001 - record the failure, don't hide it
        rec = dict(meta, ok=False, skipped=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    out_file.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--retrieval", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR), help="the records' directory")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    if args.all:
        import subprocess

        cells = [(a, s) for a, s, _, _ in C.cells(include_skipped=True)]
        cells.append(("retrieval-bigann1b", "search"))
        for mp in (False, True):
            for arch, shape in cells:
                tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                f = out_dir / f"{tag}.json"
                if f.exists() and not args.force:
                    print(f"[cached] {tag}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out", str(out_dir),
                       "--force"]
                cmd += ["--retrieval"] if arch == "retrieval-bigann1b" else [
                    "--arch", arch, "--shape", shape]
                if mp:
                    cmd.append("--multi-pod")
                t0 = time.time()
                r = subprocess.run(cmd, capture_output=True, text=True, timeout=3600)
                status = "?"
                if f.exists():
                    rec = json.loads(f.read_text())
                    status = "OK" if rec.get("ok") else "SKIP" if rec.get("skipped") else "FAIL"
                print(f"[{status}] {tag} ({time.time() - t0:.0f}s)", flush=True)
                if status == "?":
                    print(r.stdout[-2000:], r.stderr[-2000:])
        return 0

    if args.retrieval:
        rec = run_cell("retrieval-bigann1b", "search", args.multi_pod, args.force, out_dir)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --retrieval, or --all)")
        rec = run_cell(args.arch, args.shape, args.multi_pod, args.force, out_dir)
    print(json.dumps(rec, indent=1)[:3000])
    return 0 if rec.get("ok") or rec.get("skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
