"""Decode on a (data, model) mesh of ranks held against the one-process
decode, shared by the CPU tests (``tests/torch_mesh_serve_ranks.py``),
``chip_smoke.py`` phase 14 and the ``cuda`` tests.

:func:`serve_case` runs on every rank of a live mesh.  All ranks take the
same global weights (drawn from one seed, or the reference's tree carried
across), cut them to their blocks of the ``mode`` layout
(``models.convert.shard_params``), and prefill and decode the same seeded
global inputs, each rank its rows (``sharding.batch_specs``) into its
blocks of the cache (``convert.shard_cache``), teacher-forced.  Rank 0
also runs the one-process prefill and decode of the same weights and
inputs (under a ``MeshShape`` of the mesh's shape, so MoE groups tokens
into ``dp_size`` chunks as the mesh does) and compares: the prefill's and
every step's logits (gathered over the data axes) and every cache array
after the last step (gathered), each as the largest error over the
largest |value|, and counts the collectives the weight use sites made
(``axes.WEIGHT_MOVES``: none in serve mode).

:func:`full_width_decode` is ``chip_smoke.py`` 14b: llama3.2-1b at its
published width in bfloat16 on a mesh of ranks.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed import axes
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.axes import set_mode, use_mesh
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import get_model
from repro_torch.models.check import rel_err
from repro_torch.models.convert import from_jax_params, gather_cache, shard_params

N_PROMPT, N_STEPS, BATCH, ENC_LEN = 8, 6, 4, 16


def decode_inputs(cfg, seed: int = 0, batch: int = BATCH, n_prompt: int = N_PROMPT,
                  n_steps: int = N_STEPS, enc_len: int = ENC_LEN) -> dict:
    """Seeded numpy inputs: ``n_prompt + n_steps`` tokens a row (the first
    ``n_prompt`` the prompt, the rest fed one a step; whisper feeds the
    first ``n_steps`` after the frames), and the frames or patch
    embeddings of the model's frontend stub."""
    rng = np.random.default_rng(seed)
    x = dict(tokens=rng.integers(0, cfg.vocab, (batch, n_prompt + n_steps)))
    if cfg.is_encdec:
        x["frames"] = rng.standard_normal((batch, enc_len, cfg.d_model)).astype(np.float32)
    elif cfg.frontend == "vision":
        x["prefix_embeds"] = rng.standard_normal(
            (batch, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return x


def kv_slots(cfg, n_prompt: int = N_PROMPT, n_steps: int = N_STEPS) -> int:
    """The decoder's cache length: the prompt (and the frontend's prefix)
    and the steps, rounded up to a multiple of 4 (so that 2 and 4 model
    ranks split it)."""
    n = n_prompt + n_steps + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    return -(-n // 4) * 4


def row_spec(n_rows: int, ndim: int, mesh) -> tuple:
    """The spec of an array of ``n_rows`` global rows: rows over the data
    axes where they divide them (``sharding.batch_specs``)."""
    x = torch.empty((n_rows,) + (1,) * (ndim - 1), device="meta")
    return sh.batch_specs({"x": x}, mesh)["x"]


def rows(x: dict, mesh) -> dict:
    """This rank's rows of each global numpy array of ``x``."""
    return {k: sh.shard(v, row_spec(v.shape[0], v.ndim, mesh), mesh) for k, v in x.items()}


@torch.no_grad()
def decode_run(api, params, x: dict, n_prompt: int = N_PROMPT):
    """The prefill's logits and each teacher-forced step's, and the cache
    after the last step, on the device of ``params`` (under the ambient
    mesh: a live one gives this rank's rows and blocks)."""
    cfg, dev = api.cfg, api.device
    t = {k: torch.as_tensor(np.ascontiguousarray(v)).to(dev) for k, v in x.items()}
    tokens = t["tokens"].long()
    n_steps = tokens.shape[1] - n_prompt
    if cfg.is_encdec:
        logits, cache = api.prefill(params, dict(frames=t["frames"]), 0)
        feed = tokens
    else:
        prompt = dict(tokens=tokens[:, :n_prompt])
        if "prefix_embeds" in t:
            prompt["prefix_embeds"] = t["prefix_embeds"]
        logits, cache = api.prefill(params, prompt, kv_slots(cfg, n_prompt, n_steps))
        feed = tokens[:, n_prompt:]
    out = [logits]
    for s in range(n_steps):
        logits, cache = api.decode(params, cache, feed[:, s])
        out.append(logits)
    return out, cache


def gather_rows(t: torch.Tensor, n_rows: int, mesh) -> torch.Tensor:
    """The global rows of a per-rank array (``row_spec``)."""
    return sh.gather(t, row_spec(n_rows, t.ndim, mesh), mesh)


def _cache_arrays(cfg, cache) -> dict:
    if cfg.is_encdec:
        return {k: cache[k] for k in ("self_k", "self_v", "cross_k", "cross_v")}
    return {f"{l}/{k}": t for l, layer in enumerate(cache["layers"]) for k, t in layer.items()}


def serve_case(cfg, mesh, mode: str = "serve", tree: dict | None = None, seed: int = 0,
               keep: bool = False) -> dict | None:
    """One case on every rank of ``mesh``; rank 0 returns the errors, the
    others None (the module docstring).  ``tree``: the reference's
    parameter tree (numpy) to carry across, else the port's weights from
    ``seed``.  With ``keep`` rank 0's result also holds ``arrays``: the
    mesh's prefill and step logits (numpy, float32), to hold against
    another implementation."""
    dev = mesh.device
    api = get_model(cfg, dev)
    params = from_jax_params(cfg, tree, dev) if tree is not None else api.init(api.generator(seed))
    x = decode_inputs(cfg, seed)
    n_rows = x["tokens"].shape[0]
    want = None
    if mesh.rank == 0:
        with use_mesh(MeshShape(mesh.shape, mesh.axis_names)):
            want, want_cache = decode_run(api, params, x)
        want_cache = _cache_arrays(cfg, want_cache)
    shard_params(cfg, params, mesh, mode=mode)
    prev, moves = set_mode(mode), axes.WEIGHT_MOVES["calls"]
    try:
        with use_mesh(mesh):
            got, cache = decode_run(api, params, rows(x, mesh))
        got = [gather_rows(g, n_rows, mesh) for g in got]
        cache = _cache_arrays(cfg, gather_cache(cfg, cache, mesh))
    finally:
        set_mode(prev)
    moves = axes.WEIGHT_MOVES["calls"] - moves
    if mesh.rank != 0:
        return None
    out = dict(arch=cfg.name, mesh=list(mesh.shape), mode=mode,
               logits=max(rel_err(g, w) for g, w in zip(got, want)),
               cache=max(rel_err(cache[k], want_cache[k]) for k in want_cache),
               weight_moves=moves, steps=len(got) - 1)
    if keep:
        out["arrays"] = [g.float().cpu().numpy() for g in got]
    return out


# ---------------------------------------------------------------------------
# on the card: chip_smoke.py phase 14 (ranks that share one card over gloo)
# ---------------------------------------------------------------------------

FULL_ARCH = "llama3.2-1b"
FULL = dict(batch=4, prompt=64, steps=16, kv_len=96)


def full_reference(dev, seed: int = 0) -> dict:
    """The one-process run of 14b on ``dev``: llama3.2-1b in bfloat16 from
    the seed, a ``FULL["prompt"]``-token prompt at B = ``FULL["batch"]``
    (seeded), then ``FULL["steps"]`` greedy steps: the prompt, the fed
    tokens and every logits array (numpy, float32)."""
    import time

    from repro_torch import configs as C

    cfg = C.get_config(FULL_ARCH)
    api = get_model(cfg, dev)
    params = api.init(api.generator(seed))
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab, (FULL["batch"], FULL["prompt"]))
    with torch.no_grad():
        logits, cache = api.prefill(params, dict(tokens=torch.from_numpy(prompt).to(dev)),
                                    FULL["kv_len"])
        out, fed, step_ms = [logits.float().cpu().numpy()], [], []
        for _ in range(FULL["steps"]):
            tok = logits.argmax(-1)
            fed.append(tok.cpu().numpy())
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            logits, cache = api.decode(params, cache, tok)
            torch.cuda.synchronize(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            out.append(logits.float().cpu().numpy())
    del params, cache
    torch.cuda.empty_cache()
    return dict(prompt=prompt, fed=np.stack(fed, 1), logits=np.stack(out), step_ms=step_ms)


def _counted_step(api, params, cache, tok, dev) -> dict:
    """One decode step with the collectives' time and traffic counted
    (``collectives.STATS``, which waits for the card around every call)
    and the weight use sites' collectives (``axes.WEIGHT_MOVES``)."""
    import time

    from repro_torch.distributed import collectives as coll

    moves = dict(axes.WEIGHT_MOVES)
    torch.cuda.synchronize(dev)
    coll.reset_stats(True)
    t0 = time.perf_counter()
    api.decode(params, cache, tok)
    torch.cuda.synchronize(dev)
    out = dict(step_ms=(time.perf_counter() - t0) * 1e3, collective_ms=coll.STATS["s"] * 1e3,
               collective_bytes=coll.STATS["bytes"], calls=coll.STATS["calls"],
               by=coll.STATS["by"],
               weight_moves={k: axes.WEIGHT_MOVES[k] - moves[k] for k in moves})
    coll.reset_stats(False)
    return out


@torch.no_grad()
def full_width_decode(mesh, ref: dict, seed: int = 0) -> dict:
    """llama3.2-1b at its published width in bfloat16 on ``mesh``: the
    weights drawn from the seed a weight at a time in the serve layout
    (``convert.init_sharded(mode="serve")``), the reference's prompt
    prefilled and its fed tokens decoded (teacher-forced), each step
    timed as a user runs it and its logits (gathered) against the
    one-process run's (``ref``: :func:`full_reference`); then one counted
    step in the serve layout and one in the train layout (the weights
    drawn again in it, over a zeroed cache at the same position), each
    beside the collectives the dry run's meta pass counts for rank 0 of
    the same shape and mesh (``meta_pass``: bytes and calls), and each
    rank's peak memory beside ``launch.dryrun.analytic_memory`` of it."""
    import time

    import torch.distributed as dist

    from repro_torch import configs as C
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.dryrun import analytic_memory, run_pass
    from repro_torch.models.convert import init_sharded

    dev = mesh.device
    cfg = C.get_config(FULL_ARCH)
    api = get_model(cfg, dev)
    b, kv = FULL["batch"], FULL["kv_len"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    prev = set_mode("serve")
    try:
        t0 = time.perf_counter()
        params = init_sharded(api, api.generator(seed), mesh, mode="serve")
        torch.cuda.synchronize(dev)
        init_s = time.perf_counter() - t0
        x = rows(dict(tokens=ref["prompt"], fed=ref["fed"]), mesh)
        tok = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev).long()
        errs, step_ms = [], []
        with use_mesh(mesh):
            logits, cache = api.prefill(params, dict(tokens=tok(x["tokens"])), kv)
            errs.append(rel_err(gather_rows(logits, b, mesh), torch.from_numpy(ref["logits"][0])))
            for s in range(FULL["steps"]):
                torch.cuda.synchronize(dev)
                t1 = time.perf_counter()
                logits, cache = api.decode(params, cache, tok(x["fed"][:, s]))
                torch.cuda.synchronize(dev)
                step_ms.append((time.perf_counter() - t1) * 1e3)
                errs.append(rel_err(gather_rows(logits, b, mesh),
                                    torch.from_numpy(ref["logits"][s + 1])))
            serve = _counted_step(api, params, cache, tok(x["fed"][:, -1]), dev)
        peak = torch.cuda.max_memory_allocated(dev)
        pos = cache["pos"]
        del params, cache, logits
        torch.cuda.empty_cache()
        set_mode("train")
        params = init_sharded(api, api.generator(seed), mesh, mode="train")
        with use_mesh(mesh):
            cache = api.init_cache(x["tokens"].shape[0], kv)
            cache["pos"] = pos
            train = _counted_step(api, params, cache, tok(x["fed"][:, -1]), dev)
        del params, cache
        torch.cuda.empty_cache()
    finally:
        set_mode(prev)
    mine = dict(rank=mesh.rank, peak_gb=peak / 1e9, init_s=init_s)
    ranks = [None] * mesh.device_mesh.size()
    dist.all_gather_object(ranks, mine)
    shape = ShapeSpec("decode_full", kv, b, "decode")
    mshape = MeshShape(mesh.shape, mesh.axis_names)
    analytic = analytic_memory(FULL_ARCH, shape, mshape)
    for step, layout in ((serve, "serve"), (train, "train")):
        c = run_pass(FULL_ARCH, shape, mshape, layout)["collectives"]
        step["meta_pass"] = dict(bytes=c["total_bytes"], calls=c["total_count"])
    p50 = float(np.median(step_ms))
    return dict(arch=FULL_ARCH, mesh=list(mesh.shape), backend=mesh.backend, errors=errs,
                step_ms=step_ms, step_ms_p50=p50, tokens_per_s=b / p50 * 1e3,
                serve_step=serve, train_step=train, ranks=ranks,
                analytic_memory=analytic)


def chip_rank(rank, world, dev, shapes, ref_path, out, launch_names=()):
    """A rank of ``chip_smoke.py`` phase 14: each mesh of ``shapes`` in
    turn over the same ranks, (14a) every smoke architecture in float32
    (TF32 off) in serve mode against the one-process decode; on the last
    shape (14b) :func:`full_width_decode` against the one-process run
    saved at ``ref_path`` (``np.savez`` of :func:`full_reference`).  Rank 0
    writes the results as JSON to ``out``, with the six kernels' launch
    counts of this process (the mesh path runs none of them)."""
    import json
    import time
    from pathlib import Path

    from repro_torch import configs as C
    from repro_torch.kernels import dfloat_unpack, fee_distance
    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = dict(smoke={}, smoke_s={})
    for shape in shapes:
        mesh = make_mesh(shape, device=dev)
        t0 = time.perf_counter()
        key = "x".join(map(str, shape))
        res["smoke"][key] = {a: serve_case(C.get_smoke(a), mesh) for a in C.ARCHS}
        res["smoke_s"][key] = time.perf_counter() - t0
    with np.load(ref_path) as z:
        ref = {k: z[k] for k in z.files}
    t0 = time.perf_counter()
    res["full"] = full_width_decode(mesh, ref)
    res["full"]["s"] = time.perf_counter() - t0
    mods = (fee_distance, dfloat_unpack)
    res["launches"] = {n: next(getattr(m, n).launches for m in mods if hasattr(m, n))
                       for n in launch_names}
    if rank == 0:
        Path(out).write_text(json.dumps(res))
