"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py                 # SIFT1M shape: 1M x 128, 10k queries

Phases, each of which fails the run when its check fails:

1. device and power limit; build every CUDA kernel from
   ``src/repro_torch/kernels/csrc`` (``nvcc``, sm_90a);
2. each kernel against its plain PyTorch version on the card at edge shapes
   (``repro_torch.kernels.check``: the ``SHAPES`` of ``tests/test_kernels.py``
   and two with seg % 4 != 0, both metrics, random Dfloat layouts);
3. the main path: synthetic data of the SIFT1M shape, ``Index.build`` on the
   card, ``save`` / ``load``, then ``searcher("local")`` over all queries as
   one batch (a warm-up call and three timed calls) with ``storage="f32"``
   and ``storage="packed"``.  The launch counts are reset just before each
   storage's search and read just after it: the f32 search must launch
   ``fee_distance``, the packed search ``fee_distance_packed`` and
   ``dfloat_unpack``.  Packed ids must equal f32 ids, recall@10 must reach
   0.80;
4. the plain path (``fee_backend="jnp"``) on 256 queries: mean id overlap@10
   with the kernel path >= 0.99;
5. each kernel against its plain version at the main path's shapes, timed
   with CUDA events beside its bound (bytes over 3.35 TB/s, operations over
   67 TFLOP/s float32), and the f32 kernel's float4 loads against its
   one-float loads;
6. ``torch.profiler`` over one f32 search batch: device-busy time against
   the batch's wall time, and the costliest kernels.

The second-to-last line is the ``kernels`` JSON object, the last
``{"ok": true, "device": {...}}``.  ``--n`` / ``--queries`` cut the data for a
quick run and print a ``reduced`` line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
BUILD = ROOT / "build"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
F32_FLOPS = 67e12                  # H100 SXM float32 outside the tensor cores
REPEATS = 3                        # timed search calls, each over every query
SLEEP_CYCLES = 100_000_000         # ~50 ms at the H100's clocks: time to queue a timed run
PORT_KERNELS = ("fee_f32_kernel", "fee_packed_kernel", "dfloat_unpack_kernel")
REPLACES = {
    "fee_distance": "src/repro/kernels/fee_distance.py:106",
    "fee_distance_packed": "src/repro/kernels/fee_distance.py:465",
    "dfloat_unpack": "src/repro/kernels/dfloat_unpack.py:36",
}
SOURCES = {
    "fee_distance": "src/repro_torch/kernels/csrc/fee_distance.cu",
    "fee_distance_packed": "src/repro_torch/kernels/csrc/fee_distance.cu",
    "dfloat_unpack": "src/repro_torch/kernels/csrc/dfloat_unpack.cu",
}


def log(*a):
    print(*a, flush=True)


class Failed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Failed(msg)


# ---------------------------------------------------------------------------
# kernel vs plain
# ---------------------------------------------------------------------------


def fee_inputs(db, ids, q, dev, metric, seg, seed):
    """Per-segment alpha/beta/margin and per-query thresholds at the median
    candidate score, so about half the lanes exit early."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    s = db.shape[1] // seg
    k = torch.arange(1, s + 1, dtype=torch.float32)
    alpha = (1.0 + 1.0 / k).to(dev)
    beta = (1.0 + 0.2 / k).to(dev)
    margin = (torch.rand(s, generator=g) * 0.1).to(dev) if metric == "ip" else \
        torch.zeros(s, device=dev)
    x = db[ids.long()]
    full = ((x - q[:, None]) ** 2).sum(-1) if metric == "l2" else -(x * q[:, None]).sum(-1)
    thr = full.median(dim=1).values.contiguous()
    return thr, alpha, beta, margin


def edge_shape_checks(dev):
    from repro_torch.core import dfloat as dfl
    from repro_torch.kernels import dfloat_unpack as unpack_kernel
    from repro_torch.kernels import fee_distance as fee_kernel
    from repro_torch.kernels import ref
    from repro_torch.kernels.check import SCALAR_SHAPES, SHAPES, compare_fee, near_threshold

    rng = np.random.default_rng(0)
    n_cases = 0
    for c, d, seg in SHAPES + SCALAR_SHAPES:
        for metric in ("l2", "ip"):
            x_np = rng.standard_normal((c, d)).astype(np.float32)
            xt = torch.from_numpy(x_np).to(dev)
            n_q = 3
            ids = torch.from_numpy(rng.integers(0, c, (n_q, c)).astype(np.int32)).to(dev)
            q = torch.from_numpy(rng.standard_normal((n_q, d)).astype(np.float32)).to(dev)
            thr, alpha, beta, margin = fee_inputs(xt, ids, q, dev, metric, seg, c)
            mask = torch.from_numpy(rng.random((n_q, c)) < 0.8).to(dev)
            args = (ids, q, thr, alpha, beta, margin)
            kw = dict(seg=seg, metric=metric, lane_mask=mask)
            near = near_threshold(xt[ids.long()], q, thr, alpha, beta, margin,
                                  seg=seg, metric=metric)
            got = fee_kernel.fee_distance(xt, *args, **kw)
            want = ref.fee_distance_gather_ref(xt, *args, **kw)
            _, diff, n_near = compare_fee(got, want, near, f"fee_distance {c}x{d}/{seg} {metric}")
            # a random Dfloat layout of up to three widths
            widths = sorted(set(rng.choice(dfl.WIDTH_PALETTE, rng.integers(1, 4))),
                            reverse=True)
            cuts = sorted(rng.choice(np.arange(1, d), len(widths) - 1, replace=False))
            bounds = [0, *cuts, d]
            runs = [(int(w), dfl.EXP_BITS[int(w)], int(b - a))
                    for w, a, b in zip(widths, bounds[:-1], bounds[1:])]
            cfg = dfl.make_config(d, runs, x_np)
            packed = torch.from_numpy(dfl.pack_db(x_np, cfg).view(np.int32)).to(dev)
            xq = unpack_kernel.dfloat_unpack(packed, cfg)
            check(torch.equal(xq.view(torch.int32),
                              ref.dfloat_unpack_ref(packed, cfg).view(torch.int32)),
                  f"dfloat_unpack {c}x{d} {runs}: not bit-exact")
            pk = fee_kernel.fee_distance_packed(packed, *args, dfloat_cfg=cfg, **kw)
            near_q = near_threshold(xq[ids.long()], q, thr, alpha, beta, margin,
                                    seg=seg, metric=metric)
            pw = ref.fee_distance_packed_gather_ref(packed, *args, dfloat_cfg=cfg, **kw)
            compare_fee(pk, pw, near_q, f"fee_distance_packed {c}x{d}/{seg} {metric}")
            f32 = fee_kernel.fee_distance(xq, *args, **kw)
            check(all(torch.equal(a, b) for a, b in zip(pk, f32)),
                  f"fee_distance_packed {c}x{d}/{seg} {metric}: not bit-identical "
                  "to fee_distance over the decoded rows")
            log(f"edge {c}x{d} seg={seg} {metric}: ok (exit flips {diff}, near-threshold "
                f"lanes {n_near}), layout {runs}")
            n_cases += 1
    torch.cuda.synchronize()
    return n_cases


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(fn, reps=20, warmup=3):
    """Device milliseconds per call: CUDA events around ``reps`` calls.  A
    sleep kernel first holds the device while the host queues every call, so
    the events see the device's time, not the host's launch pace (a call's
    checks and ctypes launch can take longer on the host than its kernel on
    the device)."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main_path_kernels(index, db, res64, dev, launches):
    """Each kernel against its plain version at the shapes the search gives
    it: (Q, L=40) lanes per hop, the neighbors of each query's two nearest
    results scored against its final beam bound (a late hop's threshold);
    the decode of the first upper level's rows (the descent's largest call)."""
    from repro_torch.core import dfloat as dfl
    from repro_torch.kernels import dfloat_unpack as unpack_kernel
    from repro_torch.kernels import fee_distance as fee_kernel
    from repro_torch.kernels import ref
    from repro_torch.kernels.check import compare_fee, near_threshold

    cfg, seg, metric = index.dfloat_cfg, index.seg, index.metric
    x = index.device_db(True, "f32", dev)
    xp = index.device_db(True, "packed", dev)
    adj = index.device_adjacency(dev)
    near_ids = torch.from_numpy(np.maximum(res64.ids[:, :2], 0).astype(np.int64)).to(dev)
    ids = adj[near_ids].reshape(len(res64.ids), -1).contiguous()            # (Q, 40)
    q = torch.from_numpy(index.transform_queries(db.queries)).to(dev)
    thr = torch.from_numpy(res64.dists[:, -1].copy()).to(dev)
    fee = index.fee.params(dev)
    mask = torch.ones(ids.shape, dtype=torch.bool, device=dev)
    n_q, lanes = ids.shape
    d, s = x.shape[1], x.shape[1] // seg
    args = (ids, q, thr, fee.alpha, fee.beta, fee.margin)
    kw = dict(seg=seg, metric=metric, lane_mask=mask)
    near = near_threshold(x[ids.long()], q, thr, fee.alpha, fee.beta, fee.margin,
                          seg=seg, metric=metric)
    rows = []

    # bytes every FEE call moves besides the rows: ids, mask, queries,
    # thresholds, alpha/beta/margin in; dist, rejected, segs_used out
    common = n_q * lanes * (4 + 1) + n_q * d * 4 + n_q * 4 + 3 * s * 4 \
        + n_q * lanes * (4 + 1 + 4)

    got = fee_kernel.fee_distance(x, *args, **kw)
    want = ref.fee_distance_gather_ref(x, *args, **kw)
    err, flips, n_near = compare_fee(got, want, near, "fee_distance (main path)")
    segs_used = got[2].long()
    n_feat = int(segs_used.sum()) * seg
    b_ms, b_by = bound(common + n_feat * 4, 3 * n_feat)
    rows.append(dict(
        name="fee_distance", route="cuda", source=SOURCES["fee_distance"],
        replaces=REPLACES["fee_distance"], launches=launches["fee_distance"],
        max_abs_err=err,
        ms=time_ms(lambda: fee_kernel.fee_distance(x, *args, **kw)),
        plain_ms=time_ms(lambda: ref.fee_distance_gather_ref(x, *args, **kw)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    log(f"fee_distance at Q={n_q} L={lanes} D={d} seg={seg}: exit flips {flips}, "
        f"near-threshold lanes {n_near}, mean segs_used "
        f"{float(segs_used.float().mean()):.3f} of {s}")
    # the same launch through the one-float loads: a query buffer 4 bytes off
    # 16-byte alignment turns the float4 loads off
    q_off = torch.empty(q.numel() + 1, device=dev)[1:].view_as(q).copy_(q)
    args_off = (ids, q_off, *args[2:])
    got_s = fee_kernel.fee_distance(x, *args_off, **kw)
    check(all(torch.equal(a, b) for a, b in zip(got_s, got)),
          "fee_distance one-float loads: not bit-identical to float4 loads")
    loads = {"float4_ms": [], "one_float_ms": []}
    for key in ("float4_ms", "one_float_ms", "one_float_ms", "float4_ms"):   # in turns
        lane_args = args if key == "float4_ms" else args_off
        loads[key].append(time_ms(lambda: fee_kernel.fee_distance(x, *lane_args, **kw)))
    log(json.dumps({"fee_distance_loads": loads}))

    got_p = fee_kernel.fee_distance_packed(xp, *args, dfloat_cfg=cfg, **kw)
    check(all(torch.equal(a, b) for a, b in zip(got_p, got)),
          "fee_distance_packed (main path): not bit-identical to fee_distance")
    want_p = ref.fee_distance_packed_gather_ref(xp, *args, dfloat_cfg=cfg, **kw)
    err_p, flips_p, _ = compare_fee(got_p, want_p, near, "fee_distance_packed (main path)")
    # words of the live spans: the block prefix of k segments ends at w1 of block k-1
    pos, w_words = dfl.feature_positions(cfg)
    w1 = [max(wi + (1 if ofs + sg.width > 32 else 0) for wi, ofs, sg in
              pos[k * seg:(k + 1) * seg]) + 1 for k in range(s)]
    span = torch.tensor(w1, device=dev)[(segs_used - 1).clamp(min=0)]
    n_words = int(torch.where(segs_used > 0, span, 0).sum())
    b_ms, b_by = bound(common + n_words * 4 + d * 16, 8 * n_feat)
    rows.append(dict(
        name="fee_distance_packed", route="cuda", source=SOURCES["fee_distance_packed"],
        replaces=REPLACES["fee_distance_packed"],
        launches=launches["fee_distance_packed"], max_abs_err=err_p,
        ms=time_ms(lambda: fee_kernel.fee_distance_packed(xp, *args, dfloat_cfg=cfg, **kw)),
        plain_ms=time_ms(lambda: ref.fee_distance_packed_gather_ref(
            xp, *args, dfloat_cfg=cfg, **kw)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    log(f"fee_distance_packed: {w_words} words/row, {n_words * 4 / max(1, n_feat):.3f} "
        f"B per scored feature vs 4 for f32, exit flips {flips_p}")

    lvl_ids = torch.from_numpy(index.graph.levels[1][0].astype(np.int64)).to(dev)
    words = xp[lvl_ids].contiguous()
    dec = unpack_kernel.dfloat_unpack(words, cfg)
    check(torch.equal(dec.view(torch.int32), ref.dfloat_unpack_ref(words, cfg)
                      .view(torch.int32)), "dfloat_unpack (main path): not bit-exact")
    check(torch.equal(dec, x[lvl_ids]), "dfloat_unpack (main path): decode differs "
          "from the emulated f32 rows")
    c = words.shape[0]
    b_ms, b_by = bound(c * w_words * 4 + c * d * 4 + d * 16, 8 * c * d)
    rows.append(dict(
        name="dfloat_unpack", route="cuda", source=SOURCES["dfloat_unpack"],
        replaces=REPLACES["dfloat_unpack"], launches=launches["dfloat_unpack"],
        max_abs_err=0.0,
        ms=time_ms(lambda: unpack_kernel.dfloat_unpack(words, cfg)),
        plain_ms=time_ms(lambda: ref.dfloat_unpack_ref(words, cfg)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    log(f"dfloat_unpack at C={c} W={w_words} D={d}: bit-exact")
    return rows


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------


def overlap(a, b):
    return float(np.mean([len(set(x.tolist()) & set(y.tolist())) / a.shape[1]
                          for x, y in zip(a, b)]))


def run_search(index, db, params, dev):
    """One warm-up call, then REPEATS timed calls, each searching every query
    as one batch; returns the last result and the seconds of each call."""
    run = index.searcher("local", params, device=dev)
    run(db.queries)
    secs = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        res = run(db.queries)                  # numpy out: synchronised
        secs.append(time.perf_counter() - t0)
    return res, secs


def report(storage, res, secs, db, k):
    from repro_torch.data.synthetic import recall_at_k

    out = dict(storage=storage, batch=len(db.queries),
               qps=len(db.queries) * len(secs) / sum(secs),
               p50_batch_ms=float(np.median(secs)) * 1e3,
               recall_at_10=recall_at_k(res.ids, db.gt, k),
               hops=float(res.hops.mean()), n_eval=float(res.n_eval.mean()),
               dims_per_eval=float(res.dims.sum() / max(1, res.n_eval.sum())))
    log(json.dumps({"search": out}))
    return out


def main_path(args, dev, kernels):
    """Build, save, load and search; returns the loaded index, the data, a
    k=64 result for the kernels' main-path inputs, each kernel's launches in
    the search of its storage, and the two storages' reports."""
    from repro_torch.data.synthetic import DATASETS, make_dataset
    from repro_torch.index import Index, IndexSpec, SearchParams

    spec = dataclasses.replace(DATASETS["sift1m"], n=args.n, n_queries=args.queries)
    if (spec.n, spec.n_queries) != (DATASETS["sift1m"].n, DATASETS["sift1m"].n_queries):
        log(json.dumps({"reduced": {"n": spec.n, "n_queries": spec.n_queries,
                                    "from": "sift1m 1000000 x 128, 10000 queries"}}))
    t = {}
    t0 = time.perf_counter()
    db = make_dataset(spec, seed=0, device=dev, cache=False)
    t["data_s"] = time.perf_counter() - t0
    log(f"data: {db.n} x {db.dim} {db.metric}, {len(db.queries)} queries, "
        f"{t['data_s']:.1f} s")

    t0 = time.perf_counter()
    built = Index.build(db, IndexSpec(m=16, dfloat_recall_target=0.9, dfloat_proxy=True),
                        device=dev)
    t["build_s"] = time.perf_counter() - t0
    log(json.dumps({"build": {**built.timings, "total_s": t["build_s"]}}))
    log(f"dfloat layout: {[dataclasses.astuple(s) for s in built.dfloat_cfg.segments]}, "
        f"{built.db_packed.shape[1] * 4} B/vec packed vs {db.dim * 4} f32")
    path = BUILD / "chip_smoke_index"
    shutil.rmtree(path, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        built.save(path)
        t["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        index = Index.load(path, device=dev)
        t["load_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(path, ignore_errors=True)
    check(np.array_equal(index.db_packed, built.db_packed), "load: payload differs")
    del built
    log(f"save {t['save_s']:.1f} s, load {t['load_s']:.1f} s")

    # each storage's search carries its own launch counts
    launches = {}
    runs = {}
    for storage, path_kernels in (("f32", ("fee_distance",)),
                                  ("packed", ("fee_distance_packed", "dfloat_unpack"))):
        for fn in kernels.values():
            fn.launches = 0
        runs[storage] = run_search(index, db, SearchParams(ef=64, k=10, storage=storage), dev)
        counts = {name: fn.launches for name, fn in kernels.items()}
        log(json.dumps({"launches": {"storage": storage, **counts}}))
        for name in path_kernels:
            check(counts[name] > 0, f"kernel {name} was not launched by the {storage} search")
            launches[name] = counts[name]
    (res_f, secs_f), (res_p, secs_p) = runs["f32"], runs["packed"]
    rep = [report("f32", res_f, secs_f, db, 10), report("packed", res_p, secs_p, db, 10)]
    check(np.array_equal(res_p.ids, res_f.ids), "packed ids differ from f32 ids")
    check(rep[0]["recall_at_10"] >= 0.80,
          f"recall@10 {rep[0]['recall_at_10']:.4f} < 0.80")

    # the plain path on a slice of the queries
    sub = dataclasses.replace(db, queries=db.queries[:256], gt=db.gt[:256])
    for storage, res in (("f32", res_f), ("packed", res_p)):
        plain = index.searcher("local", SearchParams(ef=64, k=10, storage=storage,
                                                     fee_backend="jnp"), device=dev)
        ov = overlap(plain(sub.queries).ids, res.ids[:256])
        log(f"plain path ({storage}) vs kernel path on 256 queries: id overlap@10 {ov:.4f}")
        check(ov >= 0.99, f"plain vs kernel id overlap {ov:.4f} < 0.99 ({storage})")
    res64 = index.search(db.queries, SearchParams(ef=64, k=64), device=dev)
    return index, db, res64, launches, rep


def profile_search(index, db, dev, p50_ms):
    """Where one f32 search batch (every query) spends the device's time: the
    device-busy milliseconds (the sum of the kernels' times on the one
    stream) against the timed batch's p50 wall time, the port's own kernels'
    share, and the costliest kernels.  Only the profiler's device-side rows
    are summed: its CPU-op rows carry their kernels' time too."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.index import SearchParams

    run = index.searcher("local", SearchParams(ef=64, k=10), device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(db.queries)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        log(json.dumps({"profile": "the profiler recorded no device time: not measured"}))
        return
    ms = lambda es: sum(e.self_device_time_total for e in es) / 1e3
    busy_ms = ms(kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    log(json.dumps({"profile": {
        "batch": len(db.queries), "p50_batch_ms": p50_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / p50_ms,
        "kernel_launches": sum(e.count for e in kernels),
        "port_kernels_ms": ms(e for e in kernels if any(k in e.key for k in PORT_KERNELS)),
        "top": [[e.key[:90], e.self_device_time_total / 1e3, e.count] for e in top]}}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="base vectors")
    ap.add_argument("--queries", type=int, default=10_000, help="evaluation queries")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from the root of "
              "a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # the port takes float32 products in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build
    from repro_torch.kernels import dfloat_unpack as unpack_kernel
    from repro_torch.kernels import fee_distance as fee_kernel

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    log(f"device: {name}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi[0] if smi else "nvidia-smi: no output")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for stem, text in _build.build_logs().items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {stem}: {line.strip()}")

    n_edge = edge_shape_checks(dev)
    log(f"edge shapes: {n_edge} cases match their plain versions")

    kernels = {"fee_distance": fee_kernel.fee_distance,
               "fee_distance_packed": fee_kernel.fee_distance_packed,
               "dfloat_unpack": unpack_kernel.dfloat_unpack}
    index, db, res64, launches, rep = main_path(args, dev, kernels)
    rows = main_path_kernels(index, db, res64, dev, launches)
    profile_search(index, db, dev, rep[0]["p50_batch_ms"])
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
