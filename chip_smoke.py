"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py                 # SIFT1M shape: 1M x 128, 10k queries

Phases, each of which fails the run when its check fails:

1. device and power limit; build every CUDA kernel from
   ``src/repro_torch/kernels/csrc`` (``nvcc``, sm_90a); the packed and
   tiered FEE kernels and the f32 skip-DMA kernel must have no stack frame
   (their staged words stay in registers);
2. each kernel against its plain PyTorch version on the card at edge shapes
   (``repro_torch.kernels.check``: the ``SHAPES`` of ``tests/test_kernels.py``
   and two with seg % 4 != 0, both metrics, random Dfloat layouts); the
   skip-DMA kernels bit-identical to the kernels whose contract they share,
   and the tiered kernel at every tier split bit-identical to the packed
   kernel over the parent rows; ``dfloat_unpack`` bit-exact over row views
   at pitch W + 4, with ids (repeats, and ids that name no row), at column
   offsets 0-3 of a wider output, and as the tiered pair at every split;
3. the main path: synthetic data of the SIFT1M shape, ``Index.build`` on the
   card, ``save`` / ``load``, then ``searcher("local")`` over all queries as
   one batch (a warm-up call and three timed calls) with ``storage="f32"``,
   ``"packed"`` and ``"tiered"`` (at the index's automatic tier split), and
   with ``fee_backend="pallas_skip_dma"`` for f32 and packed.  The launch
   counts are reset just before each search and read just after it: each
   search must launch its own kernels (f32: ``fee_distance``; packed:
   ``fee_distance_packed`` and ``dfloat_unpack``; tiered:
   ``fee_distance_tiered``; skip-DMA: ``fee_distance_skipdma``, or
   ``fee_distance_packed_skipdma`` and ``dfloat_unpack``) and not the ones
   they replace, and ``descend`` once a search call.  Packed ids must
   equal f32 ids, tiered ids and distances packed ones, each skip-DMA
   search's ids and distances its storage's
   default ones; recall@10 must reach 0.80;
4. the plain path (``fee_backend="jnp"``) on 256 queries: mean id overlap@10
   with the kernel path >= 0.99 for each storage;
5. each kernel against its plain version at the main path's shapes, timed
   with CUDA events beside its bound (bytes over 3.35 TB/s, operations over
   67 TFLOP/s float32); the f32 kernel's float4 loads against its one-float
   loads (``fee_distance_loads``), the f32 skip-DMA kernel's 16 B copies
   against its 4 B copies (``skipdma_loads``), the packed and the tiered
   kernel's 16 B burst loads against their 4 B loads (``packed_loads``,
   ``tiered_loads``), the two packed kernels and the tiered kernel over
   rows at a 256 B and a 272 B pitch (``pitch_ms``), and ``dfloat_unpack``
   gathering the upper level's rows itself against torch's gather followed
   by the kernel (``unpack_gather_ms``); the hop's ``frontier`` kernel
   against its plain version at Q = 10,000, E*M = 80, L = 40 over a 1M-row
   visited bitmap, bit for bit, each timed (``frontier``; a phase-5b-only
   run: ``python3 -c "import sys, torch; sys.path[:0] = ['src', '.'];
   import chip_smoke as cs; cs.frontier_phase(torch.device('cuda'))"``);
   the descent's ``descend`` kernel against its plain version (the host
   loop of batched torch steps) at sift packed and f32 (Q = 10,000,
   D = 128) and gist packed (Q = 1,000, D = 960) over 1M clustered rows
   and the upper levels ``build_graph`` makes, entries agreeing on >= 99.9% of the
   queries, each timed beside the bound of the bytes the walks read
   (``descend``; a phase-5c-only run: ``python3 -c "import sys, torch;
   sys.path[:0] = ['src', '.']; import chip_smoke as cs;
   cs.descend_phase(torch.device('cuda'))"``);
6. ``torch.profiler`` over one f32 and one packed search batch: device-busy
   time against the batch's wall time, and the costliest kernels;
7. the ndpsim backend (``searcher("ndpsim")``) over the first 128 queries
   (cut from 256 for phase 13's time, printed as ``reduced``)
   for ``storage="packed"`` and ``"tiered"``: its traced search must launch
   that storage's FEE kernel and ``dfloat_unpack`` and no other FEE kernel,
   reach recall@10 0.80, and give the plain path's trace (``nbrs``,
   ``node``) on >= 99% of the queries; one ``ndpsim`` line per storage with
   the traced search's wall time and launches, the host replay's seconds
   and the simulator's projection of the paper's DIMM-NDP hardware (not a
   time of this card);
8. churn on the card (``repro_torch.streaming.MutableIndex`` over phase 3's
   index, ``ef_build=64``, ``sub_batch=64``): 2 seeded rounds (cut from 4
   to make room for phases 11 and 13 and printed as ``reduced``), each appending
   1,024 rows (copies of random base rows plus Gaussian noise at 5% of the
   per-dimension standard deviation) and deleting 512 random alive rows (half
   the rows of the full traffic, a cut printed as ``reduced``),
   then ``freeze()`` and all queries at ``SearchParams(ef=64, k=10)`` with
   ``storage="f32"`` and ``"packed"`` (on the last generation also
   ``"tiered"`` and both skip-DMA searches), launch counts reset before each
   search and read after it as in phase 3.  No tombstoned id may appear in
   any result; packed ids must equal f32 ids, tiered and skip-DMA ids and
   distances their storage's default ones; recall@10 against the exact
   top-10 over the survivors >= 0.80, and on the last generation no more
   than 2 points below phase 3's; the first generation's snapshot must
   return its round-1 ids again after the last round; ``save_delta`` then
   ``MutableIndex.load`` on the card must give bit-equal arrays and equal
   ids and distances.  One ``churn`` line per round (rates, seconds, QPS,
   recall, ``MutationStats`` and the ndpsim write-burst model).

9. the serving tier on the card (``repro_torch.serve`` over phase 3's
   index): (9a) a ``Server`` over 36 cells (ef 32/64/128 x f32/packed/tiered
   x batch 1/4/16/32) warmed, each storage's warm-up launching its kernels
   and no other FEE kernel (``serve_warmup``); (9b) a burst of 512 requests
   cycling k, ef and storage, every response bit-identical to its query
   replayed through ``run_bucketed`` at its (ef, batch bucket), and within
   each such cell packed ids equal to f32 ids, tiered ids and distances
   packed ones, recall@10 of the ef-64 f32 requests >= 0.80
   (``serve_replay``); (9c) Poisson traffic at 0.5 and 0.9 of C = 32 / the
   (ef 64, f32, bucket 32) cell's steady seconds for 5 s each, f32 and
   packed alternating, every future resolved with a status
   (``serve_load``); (9d) ``torch.profiler`` over 5 batches at buckets 1 and
   32 (``serve_profile``); (9e) a ``MutableIndex`` served under Poisson
   traffic at 0.5 C for 6 s while 64 rows are appended and 16 deleted each
   second: every response ok, >= 2 generations, each generation's first
   response replayed on its snapshot, no tombstoned id, >= 1 delta install,
   each re-uploading < 25% of the payload; a failing install rolls back and
   the previous generation serves on; one more delta install equals a cold
   ``DeviceCache(donate=False)`` install (``serve_swap``).  The load and
   churn run for 5 and 6 s, cut from 15 and 20 s and printed as
   ``reduced``: at the full durations the script ran past 600 s.
10. the sharded search on the card (``searcher("sharded", n_shards=C)``,
   the C shards stacked on the one device, over phase 3's index and all
   queries, ef 64): (10a) at ``compact=1.0``, C = 4 for f32, packed and
   tiered and C = 8 for f32, ids, distances and hops bit-identical to the
   local search at ``compact=1.0``; launch counts reset before each search's
   timed calls and read after them: its storage's FEE kernel (and
   ``dfloat_unpack`` for packed and tiered) and no other FEE kernel; one
   recorded hop's FEE launch (its C x Q lanes over the stacked shards)
   against its plain version (``sharded_kernel``); one ``sharded`` line a
   search (QPS and p50 call beside the local search's, FEE launches a hop,
   partition width Mc, memory, ``run.payload``); (10b) the default
   ``compact=0.5``, C = 4, f32: recall@10 >= 0.80 and between the local
   search's at ``compact=0.5`` and at 1.0, +- 0.005 (each shard keeps half
   of its own lanes, so the shards drop fewer than the local search's one
   budget: ``sharded_lossy``); (10c) ``overlap=True``, C = 4, f32,
   ``compact=1.0``: mean id overlap@10 with 10a's result >= 0.99
   (``sharded_overlap``).
11. the LM stack (``repro_torch.models``): (11a) the 10 smoke
   architectures' forward, prefill and 6 decode steps in float32 on the
   card against the CPU, one set of weights, within 1e-4 (``models``);
   (11b) llama3.2-1b at full width, decode against forward in float32 and
   bfloat16 (``llama_full``); (11c) RAG: packed retrieval over phase 3's
   index feeding the bfloat16 model at batches 4 and 32 (``rag``);
12. LM training (``repro_torch.training``): (12a) the 10 smoke
   architectures' loss and gradients in float32 on the card against the
   CPU within 1e-4, and the weights after one AdamW and one Adafactor step
   (``train_models``); (12b) llama3.2-1b at full width in bfloat16 (AdamW,
   lr 3e-4, batch 8 x 128, microbatch 2, remat): 10 steps on one batch
   lower the loss by more than 0.5, the first loss at microbatch 2 within
   1e-3 of microbatch 1's, every loss and grad norm finite; step ms,
   tokens/s, model-FLOP share, the optimizer's ms, peak memory and one
   profiled step beside their bounds (``train_full``); (12c) the trainer
   (``launch/train.py --device cuda``) crashed at step 7 and resumed from
   its step-5 checkpoint ends within 1e-4 of an uninterrupted run
   (``train_resume``).
13. LM training on a (data, model) mesh of 2 ranks sharing the card over
   gloo (``repro_torch.training.mesh_check.chip_rank``, one spawn a layout,
   at (2, 1) and (1, 2)): (13a) the 10 smoke architectures in float32, TF32
   off: the loss and every gathered gradient leaf of one differentiation
   within 1e-4 of the one-process ones, and the weights after one AdamW
   and one Adafactor step within 12a's bound (``mesh_models``); (13b)
   llama3.2-1b at full width in bfloat16 (AdamW, lr 3e-4, batch 8 x 128,
   microbatch 2, remat): 1 warm-up and 1 timed step of the step-indexed
   pipeline (cut from 3 timed for phase 14, printed as ``reduced``), each
   loss within 3e-4 relative of the one-process trainer's
   from the same seeded weights on the same batches (``mesh_reference``,
   run first), with step ms, the collectives' ms and bytes by kind, tokens/s
   and each rank's peak memory beside the state the sharding rules give it
   (``mesh_full``), and none of the six kernels launched; (13c) the smoke
   llama through ``launch/train.py --devices 2 --backend gloo`` crashed at
   step 7 and resumed ends within 1e-4 of the uninterrupted run, and the
   one-process trainer resumed from its step-5 checkpoint takes step 5 at
   the mesh run's loss (``mesh_resume``).
14. LM serving on a (data, model) mesh of 2 ranks sharing the card over
   gloo, in serve mode (``repro_torch.models.mesh_check.chip_rank``, one
   spawn, the meshes (2, 1) and (1, 2) in turn): (14a) the 10 smoke
   architectures in float32, TF32 off: prefill and 6 teacher-forced decode
   steps within 1e-4 of the largest |logit| of the one-process decode, the
   gathered cache within that of the one-process cache, and no collective
   on a weight (``mesh_serve_models``); (14b) llama3.2-1b at full width in
   bfloat16 at (1, 2), drawn a weight at a time in the serve layout: a
   64-token prompt at B = 4 and 16 decode steps teacher-forced with the
   one-process run's tokens (``mesh_serve_reference``, run here first),
   each step's logits within 3e-2 of the largest |logit| of the one-process
   run's, step ms (p50), one counted step in the serve layout (no
   collective on a weight) and one in the train layout with the
   collectives' bytes by kind and axis, each equal in bytes and calls to
   what ``launch/dryrun.py``'s meta pass counts, each rank's peak memory
   beside ``launch.dryrun.analytic_memory`` of the same shape and mesh,
   and none of the six kernels launched (``mesh_serve_full``); (14c) the
   smoke llama through ``launch/serve.py --decode --smoke --devices 2
   --backend gloo`` prints the one-process run's sample token ids
   (``mesh_serve_cli``).
15. the compression baselines and the twins of the examples: (15a) PQ
   (``repro_torch.core.baselines.fit_pq``, n_sub 8, 16, 32 and 64, 4 Lloyd
   steps on 4,000 sampled rows) and RaBitQ fitted on the card over every
   row of phase 3's ``db_rot`` (1,000,000 x 128); each fit twice, bit-equal;
   the card's fit against the port's CPU fit (codebooks, center, norms and
   ``ip_unit``, and the codes and sign bits of the first 65,536 rows) and
   ADC distances and estimates from one state on both devices, at the CPU
   tests' bounds (``repro_torch.core.baselines_check``); the ADC and the
   estimates over every row for 24 queries with an exact re-rank of 40 / 30
   (recall@10), fit and encode seconds, ms a query beside the bound, peak
   memory (``baseline_pq``, ``baseline_rabitq``), and none of the six
   kernels launched; (15b) ``launch/quickstart.py`` at its default ``sift``
   (40,000 x 128): packed ids == f32 ids, recall@10 >= 0.80, kernels
   ``fee_distance``, ``fee_distance_packed`` and ``dfloat_unpack`` launched
   (``quickstart``); (15c) ``launch/distributed_search.py`` (4 shards
   stacked on the card): one ``fee_distance`` launch a hop and no other FEE
   kernel, recall@10 between the local search's at ``compact=0.5`` and 1.0,
   +- 0.005 (``distributed_search``).

The second-to-last line is the ``kernels`` JSON object, the last
``{"ok": true, "device": {...}}``.  ``--n`` / ``--queries`` cut the data for a
quick run and print a ``reduced`` line; ``--churn-append`` /
``--churn-delete`` set phase 8's rows a round
(``--churn-append 2048 --churn-delete 1024`` is the full traffic).
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
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

F32_FLOPS = 67e12                  # H100 SXM float32 outside the tensor cores
REPEATS = 3                        # timed search calls, each over every query
SLEEP_CYCLES = 100_000_000         # ~50 ms at the H100's clocks: time to queue a timed run
PORT_KERNELS = ("fee_f32_kernel", "fee_packed_kernel", "dfloat_unpack_kernel",
                "fee_skipdma_f32_kernel", "fee_skipdma_packed_kernel", "fee_tiered_kernel",
                "frontier_kernel", "descend_kernel")
# kernels whose staged words must stay in registers (no local-memory frame)
NO_FRAME_KERNELS = ("fee_packed_kernel", "fee_skipdma_packed_kernel", "fee_tiered_kernel",
                    "fee_skipdma_f32_kernel")
REPLACES = {
    "fee_distance": "src/repro/kernels/fee_distance.py:106",
    "fee_distance_skipdma": "src/repro/kernels/fee_distance.py:192",
    "fee_distance_packed": "src/repro/kernels/fee_distance.py:465",
    "fee_distance_packed_skipdma": "src/repro/kernels/fee_distance.py:465",
    "fee_distance_tiered": "src/repro/kernels/fee_distance.py:380",
    "dfloat_unpack": "src/repro/kernels/dfloat_unpack.py:36",
}
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {
    "fee_distance": CSRC + "fee_distance.cu",
    "fee_distance_skipdma": CSRC + "fee_skipdma.cu",
    "fee_distance_packed": CSRC + "fee_distance.cu",
    "fee_distance_packed_skipdma": CSRC + "fee_skipdma.cu",
    "fee_distance_tiered": CSRC + "fee_tiered.cu",
    "dfloat_unpack": CSRC + "dfloat_unpack.cu",
}
# (search, SearchParams fields, kernels it must launch, kernels it must not)
SEARCHES = (
    ("f32", dict(storage="f32"), ("fee_distance",), ()),
    ("packed", dict(storage="packed"), ("fee_distance_packed", "dfloat_unpack"), ()),
    ("tiered", dict(storage="tiered"), ("fee_distance_tiered",), ("fee_distance_packed",)),
    ("f32 skip-DMA", dict(storage="f32", fee_backend="pallas_skip_dma"),
     ("fee_distance_skipdma",), ("fee_distance",)),
    ("packed skip-DMA", dict(storage="packed", fee_backend="pallas_skip_dma"),
     ("fee_distance_packed_skipdma", "dfloat_unpack"), ("fee_distance_packed",)),
)


def h100(name: str) -> float:
    """A datasheet rate of the H100 SXM at 700 W (``repro_torch.launch.mesh``:
    ``HBM_BW`` B/s of device memory, ``PEAK_FLOPS_BF16`` dense bfloat16
    operations/s on the tensor cores)."""
    from repro_torch.launch import mesh

    return getattr(mesh, name)


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


def same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def stack_frames(logs):
    """{function: bytes of stack frame} from the ptxas ``-v`` output of
    every source (mangled names)."""
    frames = {}
    for text in logs.values():
        name = None
        for line in text.splitlines():
            if "Function properties for" in line:
                name = line.split("Function properties for")[1].strip()
            elif name and "bytes stack frame" in line:
                frames[name] = int(line.split("bytes stack frame")[0].split()[-1])
                name = None
    return frames


def row_copy(xp, pad=0, offset=0):
    """``xp`` (N, W) copied into a row view at a pitch of W + ``pad`` words
    whose base lies ``offset`` words past a 16 B aligned allocation."""
    n, w = xp.shape
    buf = torch.empty(offset + n * (w + pad), dtype=xp.dtype, device=xp.device)
    rows = buf.as_strided((n, w), (w + pad, 1), offset)
    rows.copy_(xp)
    return rows


def unpack_routes(packed, cfg, rng, what):
    """``dfloat_unpack`` bit-exact with its plain version over ``packed``
    (N, W) rows at pitch W and W + 4, whole and gathered by ids (repeats,
    and two that name no row), into a new matrix and at columns 0-3 of a
    wider one (runs off 16 B alignment)."""
    from repro_torch.kernels import dfloat_unpack as unpack_kernel
    from repro_torch.kernels import ref

    n, d = packed.shape[0], cfg.dim
    ids = torch.from_numpy(rng.integers(0, n, 2 * n + 3)).to(packed.device)
    ids[0], ids[-1] = -1, n
    want = ref.dfloat_unpack_ref(packed, cfg, ids).view(torch.int32)
    for pad in (0, 4):
        rows = row_copy(packed, pad=pad)
        for col in range(4):
            out = torch.full((len(ids), d + 3), -7.0, device=packed.device)
            unpack_kernel.dfloat_unpack(rows, cfg, ids=ids, out=out, col=col)
            check(torch.equal(out[:, col:col + d].view(torch.int32), want)
                  and bool((out[:, :col] == -7).all() and (out[:, col + d:] == -7).all()),
                  f"{what}: pitch {rows.stride(0)}, ids, column {col}: not bit-exact")
        check(torch.equal(unpack_kernel.dfloat_unpack(rows, cfg, ids=ids).view(torch.int32),
                          want), f"{what}: pitch {rows.stride(0)}, ids: not bit-exact")


def edge_shape_checks(dev):
    from repro_torch.core import dfloat as dfl
    from repro_torch.kernels import dfloat_unpack as unpack_kernel
    from repro_torch.kernels import fee_distance as fee_kernel
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.check import (SCALAR_SHAPES, SHAPES, compare_fee,
                                           near_threshold, random_layout)

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
            case = f"{c}x{d}/{seg} {metric}"
            near = near_threshold(xt[ids.long()], q, thr, alpha, beta, margin,
                                  seg=seg, metric=metric)
            got = fee_kernel.fee_distance(xt, *args, **kw)
            want = ref.fee_distance_gather_ref(xt, *args, **kw)
            _, diff, n_near = compare_fee(got, want, near, f"fee_distance {case}")
            skip = fee_kernel.fee_distance_skipdma(xt, *args, **kw)
            compare_fee(skip, want, near, f"fee_distance_skipdma {case}")
            check(same_bits(skip, got), f"fee_distance_skipdma {case}: not bit-identical "
                  "to fee_distance")
            cfg, runs = random_layout(rng, d, x_np)
            packed = torch.from_numpy(dfl.pack_db(x_np, cfg).view(np.int32)).to(dev)
            xq = unpack_kernel.dfloat_unpack(packed, cfg)
            check(torch.equal(xq.view(torch.int32),
                              ref.dfloat_unpack_ref(packed, cfg).view(torch.int32)),
                  f"dfloat_unpack {c}x{d} {runs}: not bit-exact")
            # the decode's routes draw from their own generator, so the
            # earlier checks' inputs stay as they were
            urng = np.random.default_rng([c, d, seg])
            unpack_routes(packed, cfg, urng, f"dfloat_unpack {c}x{d} {runs}")
            pk = fee_kernel.fee_distance_packed(packed, *args, dfloat_cfg=cfg, **kw)
            near_q = near_threshold(xq[ids.long()], q, thr, alpha, beta, margin,
                                    seg=seg, metric=metric)
            pw = ref.fee_distance_packed_gather_ref(packed, *args, dfloat_cfg=cfg, **kw)
            compare_fee(pk, pw, near_q, f"fee_distance_packed {case}")
            f32 = fee_kernel.fee_distance(xq, *args, **kw)
            check(same_bits(pk, f32), f"fee_distance_packed {case}: not bit-identical "
                  "to fee_distance over the decoded rows")
            pks = fee_kernel.fee_distance_packed_skipdma(packed, *args, dfloat_cfg=cfg, **kw)
            compare_fee(pks, pw, near_q, f"fee_distance_packed_skipdma {case}")
            check(same_bits(pks, pk), f"fee_distance_packed_skipdma {case}: not "
                  "bit-identical to fee_distance_packed")
            for split in range(d // seg + 1):
                ccfg, rcfg = dfl.split_config(cfg, split * seg)
                tiers = [torch.from_numpy(t.view(np.int32)).to(dev)
                         for t in dfl.pack_tiers(x_np, cfg, split * seg)]
                tkw = dict(coarse_cfg=ccfg, resid_cfg=rcfg, **kw)
                tg = fee_kernel.fee_distance_tiered(*tiers, *args, **tkw)
                compare_fee(tg, ref.fee_distance_tiered_gather_ref(*tiers, *args, **tkw),
                            near_q, f"fee_distance_tiered {case} split={split}")
                check(same_bits(tg, pk), f"fee_distance_tiered {case} split={split}: not "
                      "bit-identical to fee_distance_packed")
                tier_ids = torch.from_numpy(urng.integers(0, c, 2 * c)).to(dev)
                check(torch.equal(ops.dfloat_unpack_tiered_rows(*tiers, ccfg, rcfg,
                                                                ids=tier_ids), xq[tier_ids])
                      and torch.equal(ops.dfloat_unpack_tiered_rows(*tiers, ccfg, rcfg), xq),
                      f"dfloat_unpack tiered pair {c}x{d} split={split}: not bit-exact")
            log(f"edge {case}: ok (exit flips {diff}, near-threshold lanes {n_near}), "
                f"layout {runs}, tiered at {d // seg + 1} splits")
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


def time_cold_ms(fn, reps=20, flush_bytes=256 << 20):
    """Device milliseconds per call with the L2 cache (50 MB) flushed before
    each call by a 256 MB write, as a search hop over fresh ids finds it:
    events bracket the call alone, and a sleep kernel holds the device while
    the host queues every (flush, call) pair."""
    flush = torch.empty(flush_bytes // 4, device="cuda")
    fn()
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(2)] for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / reps


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / h100("HBM_BW") * 1e3
    t_ops = n_ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_row(name, launches, fn, plain, err, n_bytes, n_ops):
    """One ``kernels`` entry: the kernel and its plain version timed on the
    same inputs, beside the bound of the work."""
    b_ms, b_by = bound(n_bytes, n_ops)
    return dict(name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
                launches=launches[name], max_abs_err=err, ms=time_ms(fn),
                plain_ms=time_ms(plain), bound_ms=b_ms, bound_by=b_by, library_ms=None)


def span_words(spans, used, dev):
    """Words of a block-prefix read per lane: the prefix of ``used`` blocks
    ends at w1 of block ``used - 1`` (0 words for ``used == 0``)."""
    w1 = torch.tensor([0] + [b for _, b in spans], device=dev)
    return int(w1[used.clamp(min=0, max=len(spans))].sum())


def main_path_kernels(index, db, res64, dev, launches):
    """Each kernel against its plain version at the shapes the search gives
    it: (Q, L=40) lanes per hop, the neighbors of each query's two nearest
    results scored against its final beam bound (a late hop's threshold);
    the decode of the first upper level's rows (the descent's largest call).
    Rows in the order of the TPU kernels they replace."""
    from repro_torch.core import dfloat as dfl
    from repro_torch.kernels import dfloat_unpack as unpack_kernel
    from repro_torch.kernels import fee_distance as fee_kernel
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.check import compare_fee, near_threshold

    cfg, seg, metric = index.dfloat_cfg, index.seg, index.metric
    x = index.device_db(True, "f32", dev)
    xp = index.device_db(True, "packed", dev)
    tiers = index.device_db(True, "tiered", dev)
    ccfg, rcfg = index.tier_cfgs()
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
    pkw = dict(dfloat_cfg=cfg, **kw)
    tkw = dict(coarse_cfg=ccfg, resid_cfg=rcfg, **kw)
    near = near_threshold(x[ids.long()], q, thr, fee.alpha, fee.beta, fee.margin,
                          seg=seg, metric=metric)

    # bytes every FEE call moves besides the rows: ids, mask, queries,
    # thresholds, alpha/beta/margin in; dist, rejected, segs_used out
    common = n_q * lanes * (4 + 1) + n_q * d * 4 + n_q * 4 + 3 * s * 4 \
        + n_q * lanes * (4 + 1 + 4)

    got = fee_kernel.fee_distance(x, *args, **kw)
    want = ref.fee_distance_gather_ref(x, *args, **kw)
    err, flips, n_near = compare_fee(got, want, near, "fee_distance (main path)")
    segs_used = got[2].long()
    n_feat = int(segs_used.sum()) * seg
    f32_bytes, f32_ops = common + n_feat * 4, 3 * n_feat
    log(f"fee_distance at Q={n_q} L={lanes} D={d} seg={seg}: exit flips {flips}, "
        f"near-threshold lanes {n_near}, mean segs_used "
        f"{float(segs_used.float().mean()):.3f} of {s}")
    # the same launch through the one-float loads: a query buffer 4 bytes off
    # 16-byte alignment turns the float4 loads off
    q_off = torch.empty(q.numel() + 1, device=dev)[1:].view_as(q).copy_(q)
    args_off = (ids, q_off, *args[2:])
    got_s = fee_kernel.fee_distance(x, *args_off, **kw)
    check(same_bits(got_s, got), "fee_distance one-float loads: not bit-identical to "
          "float4 loads")
    loads = {"float4_ms": [], "one_float_ms": []}
    for key in ("float4_ms", "one_float_ms", "one_float_ms", "float4_ms"):   # in turns
        lane_args = args if key == "float4_ms" else args_off
        loads[key].append(time_ms(lambda: fee_kernel.fee_distance(x, *lane_args, **kw)))
    log(json.dumps({"fee_distance_loads": loads}))

    got_k = fee_kernel.fee_distance_skipdma(x, *args, **kw)
    err_k, _, _ = compare_fee(got_k, want, near, "fee_distance_skipdma (main path)")
    check(same_bits(got_k, got), "fee_distance_skipdma (main path): not bit-identical "
          "to fee_distance")
    # the same launch through the 4 B copies: rows 4 bytes off 16-byte
    # alignment turn the 16 B copies off
    x_off = row_copy(x, offset=1)
    check(same_bits(fee_kernel.fee_distance_skipdma(x_off, *args, **kw), got),
          "fee_distance_skipdma 4 B copies: not bit-identical to fee_distance")
    kloads = {"copy16_ms": [], "copy4_ms": []}
    for key in ("copy16_ms", "copy4_ms", "copy4_ms", "copy16_ms"):   # in turns
        rows = x if key == "copy16_ms" else x_off
        kloads[key].append(time_ms(lambda: fee_kernel.fee_distance_skipdma(rows, *args, **kw)))
    log(json.dumps({"skipdma_loads": kloads}))
    del x_off

    got_p = fee_kernel.fee_distance_packed(xp, *args, **pkw)
    check(same_bits(got_p, got), "fee_distance_packed (main path): not bit-identical to "
          "fee_distance")
    want_p = ref.fee_distance_packed_gather_ref(xp, *args, **pkw)
    err_p, flips_p, _ = compare_fee(got_p, want_p, near, "fee_distance_packed (main path)")
    w_words = xp.shape[1]
    n_words = span_words(fee_kernel.block_spans(cfg, seg), segs_used, dev)
    packed_bytes, packed_ops = common + n_words * 4 + d * 16, 8 * n_feat
    log(f"fee_distance_packed: {w_words} words/row, {n_words * 4 / max(1, n_feat):.3f} "
        f"B per scored feature vs 4 for f32, exit flips {flips_p}")
    got_pk = fee_kernel.fee_distance_packed_skipdma(xp, *args, **pkw)
    err_pk, _, _ = compare_fee(got_pk, want_p, near, "fee_distance_packed_skipdma (main path)")
    check(same_bits(got_pk, got_p), "fee_distance_packed_skipdma (main path): not "
          "bit-identical to fee_distance_packed")
    # the same launch through the 4 B loads: rows 4 bytes off 16-byte
    # alignment turn the 16 B burst loads off
    xp_off = row_copy(xp, offset=1)
    for name, fn in (("fee_distance_packed", fee_kernel.fee_distance_packed),
                     ("fee_distance_packed_skipdma", fee_kernel.fee_distance_packed_skipdma)):
        check(same_bits(fn(xp_off, *args, **pkw), got_p), f"{name} 4 B loads: not "
              "bit-identical to 16 B loads")
    ploads = {"burst16_ms": [], "word4_ms": []}
    for key in ("burst16_ms", "word4_ms", "word4_ms", "burst16_ms"):   # in turns
        src = xp if key == "burst16_ms" else xp_off
        ploads[key].append(time_ms(lambda: fee_kernel.fee_distance_packed(src, *args, **pkw)))
    log(json.dumps({"packed_loads": ploads}))
    del xp_off

    got_t = fee_kernel.fee_distance_tiered(*tiers, *args, **tkw)
    check(same_bits(got_t, got_p), "fee_distance_tiered (main path): not bit-identical "
          "to fee_distance_packed")
    want_t = ref.fee_distance_tiered_gather_ref(*tiers, *args, **tkw)
    err_t, _, _ = compare_fee(got_t, want_t, near, "fee_distance_tiered (main path)")
    n_coarse = ccfg.dim // seg
    c_words = span_words(fee_kernel.block_spans(ccfg, seg), segs_used.clamp(max=n_coarse),
                         dev)
    r_words = span_words(fee_kernel.block_spans(rcfg, seg), segs_used - n_coarse, dev)
    tiered_bytes = common + (c_words + r_words) * 4 + d * 16
    past = float((segs_used > n_coarse).float().mean())
    log(f"fee_distance_tiered at tier_split={index.tier_split}: Wc={tiers[0].shape[1]} "
        f"Wr={tiers[1].shape[1]} words, {past:.4f} of the lanes read the residual tier, "
        f"{(c_words + r_words) * 4 / max(1, n_feat):.3f} B per scored feature")
    # the same launch through the 4 B loads: both tiers' rows 4 bytes off
    # 16-byte alignment turn their 16 B burst loads off
    tiers_off = [row_copy(t, offset=1) for t in tiers]
    check(same_bits(fee_kernel.fee_distance_tiered(*tiers_off, *args, **tkw), got_p),
          "fee_distance_tiered 4 B loads: not bit-identical to fee_distance_packed")
    tloads = {"burst16_ms": [], "word4_ms": []}
    for key in ("burst16_ms", "word4_ms", "word4_ms", "burst16_ms"):   # in turns
        src = tiers if key == "burst16_ms" else tiers_off
        tloads[key].append(time_ms(lambda: fee_kernel.fee_distance_tiered(*src, *args, **tkw)))
    log(json.dumps({"tiered_loads": tloads}))
    del tiers_off

    lvl_ids = torch.from_numpy(index.graph.levels[1][0].astype(np.int64)).to(dev)
    words = xp[lvl_ids].contiguous()
    dec = unpack_kernel.dfloat_unpack(words, cfg)
    check(torch.equal(dec.view(torch.int32), ref.dfloat_unpack_ref(words, cfg)
                      .view(torch.int32)), "dfloat_unpack (main path): not bit-exact")
    check(torch.equal(dec, x[lvl_ids]), "dfloat_unpack (main path): decode differs "
          "from the emulated f32 rows")
    c = words.shape[0]
    # the same rows gathered inside the kernel, from the whole matrix at a
    # 64- and a 68-word pitch, and the tiered pair written into one matrix
    wide = row_copy(xp, pad=4)
    for rows in (xp, wide):
        check(torch.equal(unpack_kernel.dfloat_unpack(rows, cfg, ids=lvl_ids), dec),
              f"dfloat_unpack with ids at pitch {rows.stride(0)} (main path): not bit-exact")
    check(torch.equal(ops.dfloat_unpack_tiered_rows(*tiers, ccfg, rcfg, ids=lvl_ids), dec),
          "dfloat_unpack tiered pair with ids (main path): not bit-exact")
    del wide
    log(f"dfloat_unpack at C={c} W={w_words} D={d}: bit-exact, pre-gathered, with ids at "
        "pitch 64 and 68, and as the tiered pair")
    gather = {"fused_ms": [], "torch_gather_ms": []}
    fused = lambda: unpack_kernel.dfloat_unpack(xp, cfg, ids=lvl_ids)
    unfused = lambda: unpack_kernel.dfloat_unpack(xp[lvl_ids], cfg)
    for key in ("fused_ms", "torch_gather_ms", "torch_gather_ms", "fused_ms"):   # in turns
        gather[key].append(time_ms(fused if key == "fused_ms" else unfused))
    g_ms, g_by = bound(c * 8 + c * w_words * 4 + c * d * 4 + w_words * 4, 8 * c * d)
    log(json.dumps({"unpack_gather_ms": {**gather, "bound_ms": g_ms, "bound_by": g_by}}))

    calls = {   # name: (kernel, plain version, max |dist error|, bytes, operations)
        "fee_distance": (lambda: fee_kernel.fee_distance(x, *args, **kw),
                         lambda: ref.fee_distance_gather_ref(x, *args, **kw),
                         err, f32_bytes, f32_ops),
        "fee_distance_skipdma": (lambda: fee_kernel.fee_distance_skipdma(x, *args, **kw),
                                 lambda: ref.fee_distance_gather_ref(x, *args, **kw),
                                 err_k, f32_bytes, f32_ops),
        "fee_distance_packed": (lambda: fee_kernel.fee_distance_packed(xp, *args, **pkw),
                                lambda: ref.fee_distance_packed_gather_ref(xp, *args, **pkw),
                                err_p, packed_bytes, packed_ops),
        "fee_distance_packed_skipdma": (
            lambda: fee_kernel.fee_distance_packed_skipdma(xp, *args, **pkw),
            lambda: ref.fee_distance_packed_gather_ref(xp, *args, **pkw),
            err_pk, packed_bytes, packed_ops),
        "fee_distance_tiered": (lambda: fee_kernel.fee_distance_tiered(*tiers, *args, **tkw),
                                lambda: ref.fee_distance_tiered_gather_ref(*tiers, *args, **tkw),
                                err_t, tiered_bytes, packed_ops),
        "dfloat_unpack": (lambda: unpack_kernel.dfloat_unpack(words, cfg),
                          lambda: ref.dfloat_unpack_ref(words, cfg), 0.0,
                          c * w_words * 4 + c * d * 4 + w_words * 4, 8 * c * d),
    }
    rows = [kernel_row(name, launches, *calls[name]) for name in SOURCES]
    # the same calls with the L2 flushed before each: the timed lanes' rows
    # (up to 100 MB packed, 158 MB f32) fit the 50 MB L2 in part, and
    # differently for each storage, when one call follows another on them
    cold = {name: time_cold_ms(calls[name][0]) for name in SOURCES}
    log(json.dumps({"cold_l2_ms": cold}))
    # kernel 5 over kernel 3's own rows: the degenerate splits are the
    # parent bitstream as one tier and an empty other tier, so the same
    # words go through each kernel's staging and decode (in turns)
    empty = xp[:, :0]
    full, none = dfl.split_config(cfg, d)
    layouts = {"packed": lambda: fee_kernel.fee_distance_packed(xp, *args, **pkw),
               "tiered_split_S": lambda: fee_kernel.fee_distance_tiered(
                   xp, empty, *args, coarse_cfg=full, resid_cfg=none, **kw),
               "tiered_split_0": lambda: fee_kernel.fee_distance_tiered(
                   empty, xp, *args, coarse_cfg=none, resid_cfg=full, **kw)}
    for name in ("tiered_split_S", "tiered_split_0"):
        check(same_bits(layouts[name](), got_p), f"fee_distance_tiered {name}: not "
              "bit-identical to fee_distance_packed")
    same_rows = {name: [] for name in layouts}
    for name in (*layouts, *reversed(layouts)):
        same_rows[name].append(time_ms(layouts[name]))
    log(json.dumps({"same_rows_ms": same_rows}))
    # the row pitch: the same words at 256 B (W) and at 272 B (W + 4) per row,
    # through the two packed kernels and the tiered kernel at split S (all
    # three stage 16 B bursts), in turns
    wide = row_copy(xp, pad=4)
    pitched = {
        "fee_distance_packed": lambda r: fee_kernel.fee_distance_packed(r, *args, **pkw),
        "fee_distance_packed_skipdma":
            lambda r: fee_kernel.fee_distance_packed_skipdma(r, *args, **pkw),
        "tiered_split_S": lambda r: fee_kernel.fee_distance_tiered(
            r, r[:, :0], *args, coarse_cfg=full, resid_cfg=none, **kw)}
    pitch = {}
    for name, fn in pitched.items():
        check(same_bits(fn(wide), got_p), f"{name} at a 272 B pitch: not bit-identical "
              "to fee_distance_packed")
        pitch[name] = {"256B_ms": [], "272B_ms": []}
        for key, r in (("256B_ms", xp), ("272B_ms", wide), ("272B_ms", wide), ("256B_ms", xp)):
            pitch[name][key].append(time_ms(lambda: fn(r)))
    log(json.dumps({"pitch_ms": pitch}))
    del wide
    return rows


def frontier_phase(dev, n_q=10_000, n=1_000_000, e=4, m=20, width=40, sets=8):
    """The hop's ``frontier`` kernel against its plain version at the batch
    cells' shape: Q queries popping E nodes of an N-row graph of degree M
    (random rows, 10% -1 pads, 80% of pops selected), a (Q, ceil(N/32))
    visited bitmap with 1% of its bits set, L lanes kept.  Bit for bit on
    every output and the visited words, then each timed with CUDA events
    over ``sets`` sets of pops in turn (the kernel's visited update leaves
    each later call nearly as much fresh work: ~L bits of N a call), beside
    the bound of its bytes: the pops, E*M ids and as many visited words
    read, L lanes of 4 + 4 + 1 + 4 B and the fresh lanes' words written, at
    4 B a word and at the 32 B sector a random word costs."""
    from repro_torch.kernels import frontier as frontier_kernel
    from repro_torch.kernels import ref

    g = torch.Generator(device=dev).manual_seed(29)
    adj = torch.randint(0, n, (n, m), generator=g, device=dev, dtype=torch.int32)
    adj[torch.rand((n, m), generator=g, device=dev) < 0.1] = -1
    words = -(-n // 32)
    visited = torch.where(torch.rand((n_q, words), generator=g, device=dev) < 0.3,
                          1 << torch.randint(0, 31, (n_q, words), generator=g, device=dev),
                          0).to(torch.int32)
    pops = []
    for _ in range(sets):
        sel = torch.rand((n_q, e), generator=g, device=dev) < 0.8
        nodes = torch.where(sel, torch.randint(0, n, (n_q, e), generator=g, device=dev), -1)
        pops.append((nodes.to(torch.int32), sel))
    for nodes, sel in pops[:2]:
        vk, vp = visited.clone(), visited.clone()
        got = frontier_kernel.frontier(nodes, sel, adj, vk, width)
        want = ref.frontier_ref(nodes, sel, adj, vp, width)
        check(all(torch.equal(a, b) for a, b in zip(got, want)) and torch.equal(vk, vp),
              "frontier (main path shape): kernel differs from its plain version")
        fresh = int(got[2].sum())
        del vk, vp
    turn = iter(range(1 << 30))
    step = lambda fn: (lambda: fn(*pops[next(turn) % sets], adj, visited, width))
    times = {"kernel_ms": [], "plain_ms": []}
    for key in ("kernel_ms", "plain_ms", "plain_ms", "kernel_ms"):     # in turns
        fn = frontier_kernel.frontier if key == "kernel_ms" else ref.frontier_ref
        times[key].append(time_ms(step(fn)))
    slots = n_q * e * m
    out_b = n_q * width * (4 + 4 + 1 + 4)
    exact = n_q * e * (4 + 1) + slots * 4 * 2 + out_b + fresh * 4
    sectors = n_q * e * (4 + 1) + n_q * e * 96 + slots * 32 + out_b + fresh * 32
    log(json.dumps({"frontier": {
        "q": n_q, "n": n, "e": e, "m": m, "width": width, "fresh_lanes": fresh,
        **times, "bound_ms": bound(exact, 0)[0], "sector_bound_ms": bound(sectors, 0)[0],
        "bytes": exact, "sector_bytes": sectors}}))
    return times


def descent_levels(x, metric, seed):
    """The upper levels ``build_graph`` makes at m = 16 over the rows ``x``
    (a CUDA tensor), on its device, without the base level's kNN (the
    descent never reads the base level)."""
    from repro_torch.core import graph as graph_mod
    from repro_torch.core import search

    ups = graph_mod.upper_levels(x, 16, metric, np.random.default_rng(seed), n_long=4)
    base = (np.arange(x.shape[0], dtype=np.int32), np.zeros((x.shape[0], 1), np.int32))
    graph = graph_mod.GraphIndex(levels=[base] + ups, entry=int(ups[-1][0][0]), m=16)
    return search.DeviceLevels.of(graph, x.device)


def walk_steps(levels, rows, q, metric):
    """The steps the queries' greedy walks take (a query's steps on a level
    are its moves plus the one that finds no nearer neighbour), from the
    plain version's levels."""
    from repro_torch.kernels import ref

    entries = torch.full((q.shape[0],), levels.entry, dtype=torch.int32, device=q.device)
    total = 0
    for ids, adj in reversed(levels.levels):
        cur, _, moved = ref.greedy_level(ids, adj, rows, q, ref.level_start(ids, entries),
                                         metric=metric)
        total += q.shape[0] + moved
        entries = ids[cur]
    return total


# (name, storage, queries, dim, field width of the packed layout)
DESCEND_CASES = (("sift packed", "packed", 10_000, 128, 16),
                 ("gist packed", "packed", 1_000, 960, 12),
                 ("sift f32", "f32", 10_000, 128, None))


def descend_phase(dev, n=1_000_000):
    """The descent's ``descend`` kernel against its plain version (the host
    loop of batched torch steps it replaced, one sync a step) at the batch
    cells' shapes: N clustered rows made on the card and packed at the
    cell's field width (sift: Q = 10,000, D = 128, 16-bit; gist: Q = 1,000,
    D = 960, 12-bit) or kept as f32 rows (sift f32: the f32 template case
    that the main path's f32 search runs), the upper levels ``build_graph``
    makes at m = 16.
    Entries must agree on >= 99.9% of the queries (the kernel's f32 sums are
    not torch's).  Each is timed with CUDA events over 20 calls after 3
    warm-ups (``time_ms``), in turns, beside the bound of the bytes the walks
    read: every step's m positions, m ids and m rows and each query's first
    row, at 4 B a word (and at the 32 B sector a random id costs) over
    3.35 TB/s."""
    from repro_torch.core import dfloat as dfl
    from repro_torch.core import search
    from repro_torch.kernels import descend as descend_kernel
    from repro_torch.kernels import ref

    out = {}
    for name, storage, n_q, d, width in DESCEND_CASES:
        g = torch.Generator(device=dev).manual_seed(d)
        centers = 3.0 * torch.randn((64, d), generator=g, device=dev)
        x = centers[torch.randint(0, 64, (n,), generator=g, device=dev)] + torch.randn(
            (n, d), generator=g, device=dev)
        q = x[torch.randint(0, n, (n_q,), generator=g, device=dev)] + 0.5 * torch.randn(
            (n_q, d), generator=g, device=dev)
        levels = descent_levels(x, "l2", d)
        cfg = None
        if storage == "packed":
            cfg = dfl.make_config(d, [(width, dfl.EXP_BITS[width], d)], x)
            x = torch.from_numpy(dfl.pack_db(x, cfg).view(np.int32)).to(dev)
        args = (levels, x, storage, cfg, q, "l2")
        got, want = descend_kernel.descend(*args), ref.descend_ref(*args)
        agree = float((got[0] == want[0]).float().mean())
        check(agree >= 0.999, f"descend ({name}): entries agree on {agree:.5f} of the "
              "queries, under 0.999")
        check(got[2] == len(levels.spans), f"descend ({name}): the kernel walked {got[2]} "
              f"of {len(levels.spans)} levels")
        steps = walk_steps(levels, search.row_reader(x, storage, cfg), q, "l2")
        times = {"kernel_ms": [], "plain_ms": []}
        for key in ("kernel_ms", "plain_ms", "plain_ms", "kernel_ms"):     # in turns
            fn = descend_kernel.descend if key == "kernel_ms" else ref.descend_ref
            times[key].append(time_ms(lambda: fn(*args)))
        m = levels.spans[0][3]
        row_b = x.shape[1] * 4
        exact = steps * m * (4 + 4 + row_b) + n_q * row_b
        sectors = steps * (-(-m * 4 // 32) * 32 + m * 32 + m * row_b) + n_q * row_b
        out[name] = dict(
            storage=storage, q=n_q, n=n, d=d, width=width, row_bytes=row_b,
            level_nodes=[s[1] for s in levels.spans], m=m, agree=agree,
            moves=got[1].tolist(), plain_moves=want[1].tolist(), walk_steps=steps,
            steps_a_query=steps / n_q, **times, bound_ms=bound(exact, 0)[0],
            sector_bound_ms=bound(sectors, 0)[0], bytes=exact, sector_bytes=sectors)
        del x, levels, q, got, want
        torch.cuda.empty_cache()
    log(json.dumps({"descend": out}))
    return out


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


def report(name, res, secs, db, k, **extra):
    from repro_torch.data.synthetic import recall_at_k

    out = dict(search=name, batch=len(db.queries),
               qps=len(db.queries) * len(secs) / sum(secs),
               p50_batch_ms=float(np.median(secs)) * 1e3,
               recall_at_10=recall_at_k(res.ids, db.gt, k),
               hops=float(res.hops.mean()), n_eval=float(res.n_eval.mean()),
               dims_per_eval=float(res.dims.sum() / max(1, res.n_eval.sum())), **extra)
    log(json.dumps({"search": out}))
    return out


def main_path(args, dev, kernels):
    """Build, save, load and search; returns the loaded index, the data, a
    k=64 result for the kernels' main-path inputs, each kernel's launches in
    the search of its path, and the searches' reports."""
    from repro_torch.data.synthetic import DATASETS, make_dataset
    from repro_torch.index import Index, IndexSpec, SearchParams
    from repro_torch.kernels import descend as descend_kernel

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
    t0 = time.perf_counter()
    xc, xr = index.tier_arrays()
    log(f"tiers at the automatic split {index.tier_split} of {index.dim // index.seg}: "
        f"{xc.shape[1]} + {xr.shape[1]} words, packed in {time.perf_counter() - t0:.1f} s")

    # each search carries its own launch counts, the descent's among them:
    # one ``descend`` launch a search call (a warm-up and REPEATS timed)
    launches, runs = {}, {}
    for name, fields, must, must_not in SEARCHES:
        for fn in (*kernels.values(), descend_kernel.descend):
            fn.launches = 0
        runs[name] = run_search(index, db, SearchParams(ef=64, k=10, **fields), dev)
        counts = {k: fn.launches for k, fn in kernels.items()}
        counts["descend"] = descend_kernel.descend.launches
        log(json.dumps({"launches": {"search": name, "calls": 1 + REPEATS, **counts}}))
        check(counts["descend"] == 1 + REPEATS, f"the {name} search launched descend "
              f"{counts['descend']} times in {1 + REPEATS} calls")
        for k in must:
            check(counts[k] > 0, f"kernel {k} was not launched by the {name} search")
            launches.setdefault(k, counts[k])
        for k in must_not:
            check(counts[k] == 0, f"the {name} search launched {k} {counts[k]} times")
    rep = {}
    for name, (res, secs) in runs.items():
        extra = {}
        if name == "tiered":
            extra = dict(tier_split=index.tier_split, coarse_words=int(xc.shape[1]),
                         residual_words=int(xr.shape[1]),
                         residual_fetch_fraction=res.residual_fetch_fraction)
        rep[name] = report(name, res, secs, db, 10, **extra)
    res = {name: r for name, (r, _) in runs.items()}
    check(np.array_equal(res["packed"].ids, res["f32"].ids), "packed ids differ from f32 ids")
    for name, base in (("tiered", "packed"), ("f32 skip-DMA", "f32"),
                       ("packed skip-DMA", "packed")):
        check(np.array_equal(res[name].ids, res[base].ids)
              and np.array_equal(res[name].dists, res[base].dists),
              f"{name} ids and distances differ from {base}")
    check(rep["f32"]["recall_at_10"] >= 0.80,
          f"recall@10 {rep['f32']['recall_at_10']:.4f} < 0.80")

    # the plain path on a slice of the queries
    sub = dataclasses.replace(db, queries=db.queries[:256], gt=db.gt[:256])
    for storage in ("f32", "packed", "tiered"):
        plain = index.searcher("local", SearchParams(ef=64, k=10, storage=storage,
                                                     fee_backend="jnp"), device=dev)
        ov = overlap(plain(sub.queries).ids, res[storage].ids[:256])
        log(f"plain path ({storage}) vs kernel path on 256 queries: id overlap@10 {ov:.4f}")
        check(ov >= 0.99, f"plain vs kernel id overlap {ov:.4f} < 0.99 ({storage})")
    res64 = index.search(db.queries, SearchParams(ef=64, k=64), device=dev)
    return index, db, res64, launches, rep


def profile_search(index, db, dev, p50_ms, storage="f32", backend="local", **opts):
    """Where one search batch (every query) over ``storage`` spends the
    device's time: the device-busy milliseconds (the sum of the kernels'
    times on the one stream) against the timed batch's p50 wall time, the
    port's own kernels' share, and the costliest kernels.  Only the
    profiler's device-side rows are summed: its CPU-op rows carry their
    kernels' time too.  ``opts`` (``compact``, ``n_shards``) go to the
    searcher of ``backend``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.index import SearchParams

    compact = opts.pop("compact", 0.5)
    run = index.searcher(backend, SearchParams(ef=64, k=10, storage=storage, compact=compact),
                         device=dev, **opts)
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
        "backend": backend, **opts, "compact": compact,
        "storage": storage, "batch": len(db.queries), "p50_batch_ms": p50_ms,
        "device_busy_ms": busy_ms,
        "kernel_launches": sum(e.count for e in kernels),
        "port_kernels_ms": ms(e for e in kernels if any(k in e.key for k in PORT_KERNELS)),
        "top": [[e.key[:90], e.self_device_time_total / 1e3, e.count] for e in top]}}))


# cut from 256 to make room for phase 13 (the script would run ~820 s with
# phase 13 at the earlier depths; PERF.md)
NDPSIM_QUERIES = 128           # the slice of the plain-path phase
NDPSIM_QUERIES_FULL = 256
NDPSIM_CUT_QUERIES = 64        # when one replay takes longer than NDPSIM_REPLAY_S
NDPSIM_REPLAY_S = 60.0
NDPSIM_FEE = {"packed": "fee_distance_packed", "tiered": "fee_distance_tiered"}


def ndpsim_phase(index, db, dev, kernels, n_q=NDPSIM_QUERIES):
    """``searcher("ndpsim")`` for packed and tiered storage over the first
    ``n_q`` queries: the launches of its traced search (counted from 0 just
    before the call), recall, the plain path's trace, the traced search's
    warm wall time, and one more host replay of the same trace, timed and
    held equal to the searcher's projection.  Returns the reports, or None
    when a replay took longer than NDPSIM_REPLAY_S."""
    from repro_torch.core import graph as graph_mod
    from repro_torch.data.synthetic import recall_at_k
    from repro_torch.index import SearchParams
    from repro_torch.ndpsim import SimFlags, simulate_ndp
    from repro_torch.ndpsim.timing import NASZIP_2CH

    queries, gt = db.queries[:n_q], db.gt[:n_q]
    owner = graph_mod.map_owners(index.n, NASZIP_2CH.n_subchannels, "shuffle", seed=0)
    reports = []
    for storage, fee_name in NDPSIM_FEE.items():
        params = SearchParams(ef=64, k=10, storage=storage)
        run = index.searcher("ndpsim", params, device=dev)
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = run(queries)
        call_s = time.perf_counter() - t0
        counts = {k: fn.launches for k, fn in kernels.items()}
        log(json.dumps({"launches": {"search": f"ndpsim {storage}", **counts}}))
        check(counts[fee_name] > 0 and counts["dfloat_unpack"] > 0,
              f"the ndpsim {storage} search did not launch {fee_name} and dfloat_unpack")
        others = {k: n for k, n in counts.items() if n and k not in (fee_name, "dfloat_unpack")}
        check(not others, f"the ndpsim {storage} search launched {others}")
        recall = recall_at_k(res.ids, gt, 10)
        check(recall >= 0.80, f"ndpsim {storage}: recall@10 {recall:.4f} < 0.80")
        traced = dataclasses.replace(params, trace=True)
        plain = index.searcher("local", dataclasses.replace(traced, fee_backend="jnp"),
                               device=dev)(queries)
        same = np.ones(n_q, bool)
        for key in ("nbrs", "node"):
            same &= (plain.trace[key] == res.trace[key]).reshape(n_q, -1).all(1)
        check(same.mean() >= 0.99, f"ndpsim {storage}: kernel and plain traces agree on "
              f"{same.mean():.4f} of the queries (< 0.99)")
        local = index.searcher("local", traced, device=dev)    # the one ndpsim drives
        t0 = time.perf_counter()
        again = local(queries)
        search_s = time.perf_counter() - t0
        check(np.array_equal(again.ids, res.ids), f"ndpsim {storage}: traced search not "
              "repeatable")
        tiers = index.tier_cfgs() if storage == "tiered" else None
        t0 = time.perf_counter()
        sim = simulate_ndp(res, owner, index.graph.base_adjacency, NASZIP_2CH, SimFlags(),
                           index.dfloat_cfg, index.seg, tier_cfgs=tiers)
        replay_s = time.perf_counter() - t0
        check(sim.qps == res.sim.qps and sim.dram_bytes_per_query
              == res.sim.dram_bytes_per_query, f"ndpsim {storage}: replay not repeatable")
        if replay_s > NDPSIM_REPLAY_S and n_q > NDPSIM_CUT_QUERIES:
            log(json.dumps({"reduced": {"ndpsim_queries": NDPSIM_CUT_QUERIES, "from": n_q,
                                        "why": f"one replay took {replay_s:.1f} s "
                                               f"> {NDPSIM_REPLAY_S} s"}}))
            return None
        share = res.sim.breakdown()
        rep = dict(
            storage=storage, queries=n_q, hops_traced=int(res.trace["node"].shape[1]),
            search_s=search_s, call_s=call_s, replay_s=replay_s,
            fee_launches=counts[fee_name], unpack_launches=counts["dfloat_unpack"],
            recall_at_10=recall, trace_match=float(same.mean()),
            projection="ndpsim projection of the paper's DIMM-NDP hardware "
                       f"({NASZIP_2CH.name}), not a time of this card",
            qps=res.sim.qps, avg_latency_us=res.sim.avg_latency_us,
            neighbor_share=share["neighbor"], distance_share=share["distance"],
            partial_share=share["partial"], lnc_t_hit=res.sim.lnc_t_hit,
            lnc_d_hit=res.sim.lnc_d_hit, prefetch_hit=res.sim.prefetch_hit,
            dram_bytes_per_query=res.sim.dram_bytes_per_query)
        if storage == "tiered":
            rep.update(survivor_fetch_fraction=res.sim.survivor_fetch_fraction,
                       residual_fetch_fraction=res.residual_fetch_fraction,
                       far_bytes_per_query=res.sim.far_bytes_per_query)
        log(json.dumps({"ndpsim": rep}))
        reports.append(rep)
    return reports


# phase 8's traffic: 4 rounds of 2,048 appends and 1,024 deletes, cut to half
# the rows a round because at full traffic the phase took 283-311 s on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md), over its 3-minute budget; and cut
# to 3 rounds to make room for phase 11, since the script ran 519-564 s
# through phase 10 on the same card, then to 2 rounds to make room for phase 13
CHURN_ROUNDS = 2
CHURN_ROUNDS_FULL = 4
CHURN_FULL = dict(append=2048, delete=1024)
CHURN = dict(append=1024, delete=512)
CHURN_ISOLATION_QUERIES = 256
# searches of every generation, then the ones added on the last
CHURN_SEARCHES = ("f32", "packed")
CHURN_LAST = ("tiered", "f32 skip-DMA", "packed skip-DMA")


def timed_sync(fn):
    """(result, seconds) of ``fn()``, the device drained at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def churn_phase(index, db, dev, kernels, recall_main, *, append, delete):
    """Phase 8: a MutableIndex over the loaded index under seeded appends and
    deletes, its snapshots searched on the card after every round, then its
    WAL saved and replayed on the card.  Returns the per-round reports."""
    from repro_torch.core import dfloat as dfl
    from repro_torch.data.synthetic import exact_topk, recall_at_k
    from repro_torch.index import SearchParams
    from repro_torch.streaming import MutableIndex

    searches = {name: (fields, must, must_not) for name, fields, must, must_not in SEARCHES}
    rng = np.random.default_rng(0)
    noise = 0.05 * db.vectors.std(axis=0)
    mi = MutableIndex(index, ef_build=64, sub_batch=64)
    log(f"churn: capacity {mi.capacity} rows for {index.n}, device mirrors on {mi.device}")
    sub_q = db.queries[:CHURN_ISOLATION_QUERIES]
    first = None
    reports = []
    for r in range(CHURN_ROUNDS):
        src = rng.integers(0, db.n, append)
        new = db.vectors[src] + (noise * rng.standard_normal((append, db.dim))
                                 ).astype(np.float32)
        c0 = mi.candidate_s
        _, append_s = timed_sync(lambda: mi.append(new))
        candidate_s = mi.candidate_s - c0
        dels = rng.choice(mi.alive_ids(), delete, replace=False)
        _, delete_s = timed_sync(lambda: mi.delete(dels))
        r0 = mi.stats.repair_s
        snap, freeze_s = timed_sync(mi.freeze)
        repair_s = mi.stats.repair_s - r0
        dead = mi._dead.copy()
        # the snapshot's first-search uploads, each timed on its own
        _, f32_upload_s = timed_sync(lambda: snap.device_db(True, "f32", dev))
        _, db_q_s = timed_sync(lambda: dfl.emulate_db(snap.device_db(True, "f32", dev),
                                                      snap.dfloat_cfg))
        _, packed_upload_s = timed_sync(lambda: snap.device_db(True, "packed", dev))
        _, adj_upload_s = timed_sync(lambda: (snap.device_adjacency(dev),
                                              snap.device_tombstone(dev)))
        up = dict(f32_upload_s=f32_upload_s, db_q_s=db_q_s,
                  packed_upload_s=packed_upload_s, adjacency_upload_s=adj_upload_s)
        last = r == CHURN_ROUNDS - 1
        if last:
            _, up["tier_repack_s"] = timed_sync(snap.tier_arrays)
            _, up["tiered_upload_s"] = timed_sync(lambda: snap.device_db(True, "tiered", dev))
        surv = mi.alive_ids()
        gt = surv[exact_topk(torch.from_numpy(mi._rot[surv]).to(dev),
                             mi.spca.transform(db.queries), 10, db.metric, device=dev)]
        res, qps = {}, {}
        for name in CHURN_SEARCHES + (CHURN_LAST if last else ()):
            fields, must, must_not = searches[name]
            for fn in kernels.values():
                fn.launches = 0
            res[name], secs = run_search(snap, db, SearchParams(ef=64, k=10, **fields), dev)
            counts = {k: fn.launches for k, fn in kernels.items()}
            log(json.dumps({"launches": {"search": f"churn round {r} {name}", **counts}}))
            for k in must:
                check(counts[k] > 0, f"churn round {r}: kernel {k} was not launched by "
                      f"the {name} search")
            for k in must_not:
                check(counts[k] == 0, f"churn round {r}: the {name} search launched {k}")
            ids = res[name].ids
            check(not dead[ids[ids >= 0]].any(),
                  f"churn round {r}: the {name} search returned a tombstoned id")
            qps[name] = len(db.queries) * len(secs) / sum(secs)
        check(np.array_equal(res["packed"].ids, res["f32"].ids),
              f"churn round {r}: packed ids differ from f32 ids")
        for name, base in (("tiered", "packed"), ("f32 skip-DMA", "f32"),
                           ("packed skip-DMA", "packed")):
            if name in res:
                check(np.array_equal(res[name].ids, res[base].ids)
                      and np.array_equal(res[name].dists, res[base].dists),
                      f"churn round {r}: {name} ids and distances differ from {base}")
        recall = recall_at_k(res["f32"].ids, gt, 10)
        check(recall >= 0.80, f"churn round {r}: recall@10 {recall:.4f} < 0.80")
        if first is None:
            first = (snap, res["f32"].ids[:CHURN_ISOLATION_QUERIES])
        rep = dict(round=r, generation=snap.generation, n_rows=mi.n, n_alive=mi.n_alive,
                   appended=append, deleted=delete, append_rows_per_s=append / append_s,
                   append_s=append_s, candidate_share_of_append=candidate_s / append_s,
                   delete_s=delete_s, repair_s=repair_s, freeze_s=freeze_s, **up,
                   qps=qps, recall_at_10=recall,
                   stats=dataclasses.asdict(mi.stats),
                   write_model={"what": "ndpsim write-burst model of the paper's DIMM-NDP "
                                        "hardware, not a time of this card",
                                **dataclasses.asdict(mi.write_stats())})
        log(json.dumps({"churn": rep}))
        reports.append(rep)
    check(recall >= recall_main - 0.02, f"churn: last recall@10 {recall:.4f} more than "
          f"2 points below the main path's {recall_main:.4f}")

    # snapshot isolation: the first generation still serves its own results
    snap0, ids0 = first
    again = snap0.searcher("local", SearchParams(ef=64, k=10), device=dev)(sub_q)
    check(np.array_equal(again.ids, ids0), "churn: the first snapshot's results changed")

    # the WAL: saved beside the base, replayed on the card
    path = BUILD / "chip_smoke_churn"
    shutil.rmtree(path, ignore_errors=True)
    try:
        _, save_s = timed_sync(lambda: mi.save_delta(path))
        m2, load_s = timed_sync(lambda: MutableIndex.load(path, device=dev))
    finally:
        shutil.rmtree(path, ignore_errors=True)
    for f in ("_rot", "_packed", "_adj", "_dead", "_coarse", "_resid"):
        a, b = getattr(mi, f), getattr(m2, f)
        check((a is None and b is None) or np.array_equal(a, b),
              f"churn: the replayed {f} differs from the live one")
    params = SearchParams(ef=64, k=10)
    live = mi.search(db.queries, params, device=dev)
    replayed = m2.search(db.queries, params, device=dev)
    check(np.array_equal(live.ids, replayed.ids) and np.array_equal(live.dists, replayed.dists),
          "churn: the replayed index returns other ids or distances")
    log(json.dumps({"churn_wal": {"save_s": save_s, "load_and_replay_s": load_s,
                                  "arrays_bit_equal": True, "search_equal": True}}))
    return reports


# phase 9: the serving tier over phase 3's index
SERVE_KERNELS = {"f32": ("fee_distance",),
                 "packed": ("fee_distance_packed", "dfloat_unpack"),
                 "tiered": ("fee_distance_tiered", "dfloat_unpack")}
SERVE_BURST = 512                  # 9b: requests submitted at once
SERVE_BURST_K = (1, 5, 10)
SERVE_BURST_EF = (32, 48, 64, 100)
# 9c: seconds per rate and shares of C; 9e: seconds, share of C, rows a
# second.  The full durations (15 s a rate, 20 s of churn) took the script
# past 600 s on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md), so both are cut
SERVE_LOAD_FULL, SERVE_SWAP_FULL = 15.0, 20.0
SERVE_LOAD = dict(seconds=5.0, rates=(0.5, 0.9))
SERVE_SWAP = dict(seconds=6.0, rate=0.5, append=64, delete=16)
SERVE_PROFILE_BATCHES = 5                              # 9d: per bucket
NO_TIMEOUT_MS = 600_000.0          # a deadline no request reaches
NO_SHED_QUEUE = 1 << 16            # a queue no burst or stall fills


def serve_config(storages, **kw):
    from repro_torch.serve import ServeConfig

    return ServeConfig(ef_buckets=(32, 64, 128), batch_buckets=(1, 4, 16, 32), k_max=10,
                       expand=4, storages=storages, use_dfloat=True, **kw)


def launch_counts(kernels):
    return {k: fn.launches for k, fn in kernels.items()}


def check_serve_kernels(counts, storages, what):
    """``counts`` must hold every kernel of ``storages``' searches and no
    other FEE kernel."""
    want = {k for st in storages for k in SERVE_KERNELS[st]}
    for k in sorted(want):
        check(counts[k] > 0, f"{what}: kernel {k} was not launched")
    others = {k: n for k, n in counts.items() if n and k not in want}
    check(not others, f"{what}: launched {others}")


def resolve_all(futures, what):
    """Every future's Response; fails on an exception or an unknown status."""
    out = []
    for f in futures:
        e = f.exception(timeout=300)
        check(e is None, f"{what}: a future resolved with {type(e).__name__}: {e}")
        r = f.result()
        check(r.status in ("ok", "timeout", "shed"), f"{what}: status {r.status!r}")
        out.append(r)
    return out


def load_report(resps, offered_rps, duration_s, slo_ms, wall_s):
    """The ``serve_load`` line: rates, latency percentiles of ok responses,
    statuses, degraded count, batch-bucket histogram and goodput."""
    ok = [r for r in resps if r.ok]
    pct = lambda xs, p: float(np.percentile(xs, p)) if xs else None
    buckets = {}
    for r in ok:
        buckets[str(r.batch_bucket)] = buckets.get(str(r.batch_bucket), 0) + 1
    return dict(offered_rps=offered_rps, duration_s=duration_s, submitted=len(resps),
                achieved_rps=len(ok) / wall_s, wall_s=wall_s, slo_ms=slo_ms,
                p50_total_ms=pct([r.total_ms for r in ok], 50),
                p99_total_ms=pct([r.total_ms for r in ok], 99),
                p50_service_ms=pct([r.service_ms for r in ok], 50),
                p99_service_ms=pct([r.service_ms for r in ok], 99),
                status={s: sum(r.status == s for r in resps)
                        for s in ("ok", "timeout", "shed")},
                degraded=sum(r.degraded for r in resps), batch_buckets=buckets,
                goodput_rps=sum(r.good for r in resps) / wall_s)


class AlternateStorage:
    """A ``submit`` front for ``run_load`` that alternates the storage of
    consecutive requests and records each request's (query row, storage):
    ``run_load`` sends row ``i % n_queries`` as its ``i``-th request."""

    def __init__(self, srv, n_queries, storages):
        self.srv, self.n_queries, self.storages = srv, n_queries, storages
        self.cases = []

    def submit(self, query, **kw):
        i = len(self.cases)
        st = self.storages[i % len(self.storages)]
        self.cases.append((i % self.n_queries, st))
        return self.srv.submit(query, storage=st, **kw)


def serve_load(srv, db, rps, seconds, slo_ms, storages, seed, mutate_fn=None):
    """Open-loop Poisson traffic (ef 64, k 10, storages alternating); returns
    the (query row, storage) of each request, the responses and the wall
    seconds from the first submit to the last response."""
    from repro_torch.serve import run_load

    front = AlternateStorage(srv, len(db.queries), storages)
    t0 = time.perf_counter()
    futs = run_load(front, db.queries, rps=rps, duration_s=seconds, pattern="poisson",
                    ef=64, k=10, deadline_ms=slo_ms, seed=seed, mutate_fn=mutate_fn,
                    wait=False)
    resps = resolve_all(futs, "serve load")
    return front.cases, resps, time.perf_counter() - t0


def count_by_storage(kernels, storages):
    """Wrap the batcher's ``run_bucketed`` so that the launches of each call
    add up per storage (the warm-up runs its cells one at a time on the
    calling thread); returns the tallies and the function that unwraps."""
    from repro_torch.serve import batcher

    tally = {st: dict.fromkeys(kernels, 0) for st in storages}
    orig = batcher.run_bucketed

    def counted(snapshot, cfg, queries, ef_bucket, expand, storage, *a, **kw):
        before = launch_counts(kernels)
        out = orig(snapshot, cfg, queries, ef_bucket, expand, storage, *a, **kw)
        for k, n in launch_counts(kernels).items():
            tally[storage][k] += n - before[k]
        return out

    batcher.run_bucketed = counted
    return tally, lambda: setattr(batcher, "run_bucketed", orig)


def replay(snapshot, cfg, db, cases, resps):
    """Every ok response against ``run_bucketed`` of its own query on
    ``snapshot`` at its (ef served, batch bucket): each such group's queries
    are replayed for every storage in other batches than served them
    (reversed, in chunks of the bucket), and one query per (group, storage)
    alone.  Within a group packed ids must equal f32 ids, tiered ids and
    distances packed ones.  Returns the replayed batches."""
    from repro_torch.serve.batcher import run_bucketed

    groups = {}
    for (row, st), r in zip(cases, resps):
        if r.ok:
            groups.setdefault((r.ef_served, r.batch_bucket), []).append((row, st, r))
    n_batches = 0
    for (ef, b), members in sorted(groups.items()):
        rows = sorted({row for row, _, _ in members}, reverse=True)
        got = {}
        for st in cfg.storages:
            for s in range(0, len(rows), b):
                chunk = rows[s: s + b]
                ids, dists = run_bucketed(snapshot, cfg, db.queries[chunk], ef, cfg.expand,
                                          st, bucket=b)[:2]
                n_batches += 1
                got.update({(st, row): (ids[i], dists[i]) for i, row in enumerate(chunk)})
            row = rows[0]
            ids, dists = run_bucketed(snapshot, cfg, db.queries[[row]], ef, cfg.expand, st,
                                      bucket=b)[:2]
            n_batches += 1
            check(np.array_equal(ids[0], got[st, row][0])
                  and np.array_equal(dists[0], got[st, row][1]),
                  f"serve replay: query {row} alone ({st}, ef {ef}, bucket {b}) differs "
                  "from the same query among others")
        for row, st, r in members:
            ids, dists = got[st, row]
            check(np.array_equal(r.ids, ids[: len(r.ids)])
                  and np.array_equal(r.dists, dists[: len(r.ids)]),
                  f"serve replay: request {r.id} ({st}, ef {ef}, bucket {b}) differs from "
                  "its query replayed")
        for row in rows:
            if {"f32", "packed"} <= set(cfg.storages):
                check(np.array_equal(got["packed", row][0], got["f32", row][0]),
                      f"serve replay: packed ids differ from f32 (ef {ef}, bucket {b})")
            if {"packed", "tiered"} <= set(cfg.storages):
                check(np.array_equal(got["tiered", row][0], got["packed", row][0])
                      and np.array_equal(got["tiered", row][1], got["packed", row][1]),
                      f"serve replay: tiered ids and distances differ from packed "
                      f"(ef {ef}, bucket {b})")
    return n_batches


def profile_buckets(snapshot, cfg, db, dev):
    """``torch.profiler`` over SERVE_PROFILE_BATCHES batches (ef 64, f32) at
    batch buckets 1 and 32, through the batcher's ``run_bucketed``: device
    busy beside the unprofiled wall time, kernel launches per batch and the
    port's kernels' time.  (The benchmark's ``device.idle_pct.serve`` reads
    the idle share from one profiled timeline.)"""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.batcher import run_bucketed

    out = {}
    for b in (1, 32):
        qs = [db.queries[np.arange(i * b, (i + 1) * b) % len(db.queries)]
              for i in range(SERVE_PROFILE_BATCHES)]
        run_bucketed(snapshot, cfg, qs[0], 64, cfg.expand, "f32")
        # wall time unprofiled (the profiler adds host time to every op),
        # then the same batches profiled for the device's time
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        service = [run_bucketed(snapshot, cfg, q, 64, cfg.expand, "f32")[3] for q in qs]
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for q in qs:
                run_bucketed(snapshot, cfg, q, 64, cfg.expand, "f32")
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0]
        ms = lambda es: sum(e.self_device_time_total for e in es) / 1e3
        rep = dict(bucket=b, batches=len(qs), ef=64, storage="f32", wall_ms=wall_ms,
                   service_ms=[s * 1e3 for s in service])
        if kernels:
            busy = ms(kernels)
            rep.update(device_busy_ms=busy,
                       launches_per_batch=sum(e.count for e in kernels) / len(qs),
                       port_kernels_ms=ms(e for e in kernels
                                          if any(k in e.key for k in PORT_KERNELS)))
        else:
            rep["device_busy_ms"] = "the profiler recorded no device time: not measured"
        log(json.dumps({"serve_profile": rep}))
        out[b] = rep
    return out


def dead_ids(snapshot, ids):
    """Tombstone bits of ``ids`` (>= 0) in ``snapshot``."""
    ids = np.asarray(ids, np.int64)
    ids = ids[ids >= 0]
    return ((snapshot.tombstone[ids >> 5] >> (ids & 31).astype(np.uint32)) & 1) == 1


def wait_for(cond, what, timeout_s=60.0):
    t_end = time.monotonic() + timeout_s
    while not cond():
        check(time.monotonic() < t_end, f"{what}: not within {timeout_s:.0f} s")
        time.sleep(0.01)


def serve_phase(index, db, dev, kernels):
    """Phase 9: the serving tier on the card over phase 3's index (9a
    warm-up, 9b burst replay, 9c load, 9d profile, 9e hot swap under churn,
    rollback and a delta install against a cold one)."""
    import copy

    from repro_torch.data.synthetic import recall_at_k
    from repro_torch.index import DeviceCache
    from repro_torch.resilience import FaultPlan, FaultSpec, active_plan
    from repro_torch.serve import Server
    from repro_torch.serve.batcher import run_bucketed
    from repro_torch.streaming import MutableIndex

    storages = tuple(SERVE_KERNELS)
    cfg = serve_config(storages, slo_ms=NO_TIMEOUT_MS, max_queue=NO_SHED_QUEUE)

    # 9a: warm-up of the 36 cells, launches counted per storage
    tally, unwrap = count_by_storage(kernels, storages)
    srv = Server(index, cfg)
    try:
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        srv.start()
        start_s = time.perf_counter() - t0
    finally:
        unwrap()
    try:
        for st in storages:
            check_serve_kernels(tally[st], (st,), f"serve warm-up {st}")
        check_serve_kernels(launch_counts(kernels), storages, "serve warm-up")
        info = srv.warmup_info
        cells = {f"ef{ef} {st} b{b}": dict(first_s=f, steady_s=s)
                 for (ef, _, st, b), (f, s) in info["cells"].items()}
        log(json.dumps({"serve_warmup": {
            "cells": cells, "start_s": start_s, "warmup_s": info["total_s"],
            "cold_start_ms": srv.metrics.cold_start_ms,
            "first_response_s": info["first_response_s"], "launches": tally}}))
        steady = {(ef, st, b): s for (ef, _, st, b), (_, s) in info["cells"].items()}

        # 9b: one burst of mixed k / ef / storage, replayed bit for bit; query
        # row j goes once to each storage with one (k, ef)
        cases = [((i // 3) % len(db.queries), storages[i % 3]) for i in range(SERVE_BURST)]
        knobs = [(SERVE_BURST_K[j % 3], SERVE_BURST_EF[j % 4]) for j, _ in cases]
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        futs = [srv.submit(db.queries[j], k=k, ef=ef, storage=st)
                for (j, st), (k, ef) in zip(cases, knobs)]
        resps = resolve_all(futs, "serve burst")
        burst_s = time.perf_counter() - t0
        counts = launch_counts(kernels)
        check_serve_kernels(counts, storages, "serve burst")
        check(all(r.ok for r in resps), "serve burst: a request was not served: "
              f"{ {s: sum(r.status == s for r in resps) for s in ('timeout', 'shed')} }")
        for r, (k, ef) in zip(resps, knobs):
            check(r.ids.shape == (k,), f"serve burst: request {r.id} has {r.ids.shape} ids")
            check(r.ef_served == cfg.ef_bucket(ef) or r.degraded,
                  f"serve burst: request {r.id} served at ef {r.ef_served} for {ef}")
        t0 = time.perf_counter()
        n_replay = replay(index, cfg, db, cases, resps)
        replay_s = time.perf_counter() - t0
        rec = [(j, r) for (j, st), (k, _), r in zip(cases, knobs, resps)
               if st == "f32" and k == 10 and r.ef_served == 64]
        recall = recall_at_k(np.stack([r.ids for _, r in rec]),
                             db.gt[[j for j, _ in rec]], 10)
        check(recall >= 0.80, f"serve burst: recall@10 {recall:.4f} < 0.80 at ef 64")
        buckets = {}
        for r in resps:
            buckets[str(r.batch_bucket)] = buckets.get(str(r.batch_bucket), 0) + 1
        log(json.dumps({"serve_replay": {
            "requests": len(resps), "burst_s": burst_s, "batch_buckets": buckets,
            "degraded": sum(r.degraded for r in resps), "replayed_batches": n_replay,
            "replay_s": replay_s, "bit_identical": True, "recall_at_10_ef64_f32": recall,
            "recall_queries": len(rec), "launches": counts}}))

        # 9c: Poisson load at shares of C = 32 / (ef 64, f32, bucket 32) steady s
        cap = 32 / steady[64, "f32", 32]
        slo_ms = 3e3 * max(steady[64, st, 32] for st in ("f32", "packed"))
        log(json.dumps({"serve_capacity": {"C_rps": cap, "slo_ms": slo_ms}}))
        loads = []
        for share in SERVE_LOAD["rates"]:
            for fn in kernels.values():
                fn.launches = 0
            _, resps, wall_s = serve_load(srv, db, share * cap, SERVE_LOAD["seconds"], slo_ms,
                                          ("f32", "packed"), seed=int(share * 100))
            check_serve_kernels(launch_counts(kernels), ("f32", "packed"),
                                f"serve load {share} C")
            rep = load_report(resps, share * cap, SERVE_LOAD["seconds"], slo_ms, wall_s)
            rep["events"] = srv.metrics.summary().get("events", {})
            log(json.dumps({"serve_load": {"share_of_C": share, **rep}}))
            loads.append(rep)

        # 9d: where a batch's time goes at buckets 1 and 32
        profiles = profile_buckets(index, cfg, db, dev)
    finally:
        srv.stop()

    # 9e: hot swap under churn, then a failed install, then delta vs cold
    # the traffic asks for ef 64 only, so the lattice holds that bucket alone
    swap_cfg = dataclasses.replace(serve_config(("f32", "packed"), slo_ms=NO_TIMEOUT_MS,
                                                max_queue=NO_SHED_QUEUE, swap_poll_s=0.05),
                                   ef_buckets=(64,))
    rng = np.random.default_rng(9)
    noise = 0.05 * db.vectors.std(axis=0)
    t0 = time.perf_counter()
    mi = MutableIndex(index, ef_build=64, sub_batch=64)
    mutable_s = time.perf_counter() - t0

    def mutate():
        # under the index's lock, so that the watcher freezes the append and
        # the delete as one generation
        with mi._lock:
            new = db.vectors[rng.integers(0, db.n, SERVE_SWAP["append"])]
            mi.append(new + (noise * rng.standard_normal(new.shape)).astype(np.float32))
            mi.delete(rng.choice(mi.alive_ids(), SERVE_SWAP["delete"], replace=False))

    srv = Server(mi, swap_cfg)
    srv.history = collections.deque()            # keep every generation served
    installs = []
    orig_install = srv.installer.install

    def timed_install(snapshot):
        t = time.perf_counter()
        stats = orig_install(snapshot)
        installs.append((snapshot.generation, time.perf_counter() - t,
                         None if stats is None else list(zip(swap_cfg.storages, stats))))
        return stats

    srv.installer.install = timed_install
    try:
        t0 = time.perf_counter()
        srv.start()
        swap_start_s = time.perf_counter() - t0
        for fn in kernels.values():
            fn.launches = 0
        cases, resps, wall_s = serve_load(srv, db, SERVE_SWAP["rate"] * cap,
                                          SERVE_SWAP["seconds"],
                                          NO_TIMEOUT_MS, ("f32", "packed"), seed=17,
                                          mutate_fn=mutate)
        check_serve_kernels(launch_counts(kernels), ("f32", "packed"), "serve swap")
        check(all(r.ok for r in resps), "serve swap: requests not served ok: "
              f"{ {s: sum(r.status == s for r in resps) for s in ('timeout', 'shed')} }")
        history = dict(srv.history)
        gens = sorted({r.generation for r in resps})
        check(len(gens) >= 2, f"serve swap: {len(gens)} generation(s) served, expected >= 2")
        check(set(gens) <= set(history), "serve swap: a response names an uninstalled "
              "generation")
        firsts = {}
        for (row, st), r in zip(cases, resps):
            check(not dead_ids(history[r.generation], r.ids).any(),
                  f"serve swap: generation {r.generation} returned a tombstoned id")
            firsts.setdefault(r.generation, (row, st, r))
        t0 = time.perf_counter()
        for gen, (row, st, r) in firsts.items():
            snap = copy.copy(history[gen])
            snap._device, snap._searchers = {}, {}
            ids, dists = run_bucketed(snap, swap_cfg, db.queries[[row]], r.ef_served,
                                      swap_cfg.expand, st, bucket=r.batch_bucket)[:2]
            check(np.array_equal(r.ids, ids[0]) and np.array_equal(r.dists, dists[0]),
                  f"serve swap: generation {gen}'s first response differs on its snapshot")
        replay_s = time.perf_counter() - t0
        stats = [(st, s) for _, _, ss in installs if ss for st, s in ss]
        deltas = [s for _, s in stats if s.mode == "delta"]
        check(deltas, "serve swap: no delta install")
        worst = max(s.reupload_fraction for s in deltas)
        check(worst < 0.25, f"serve swap: a delta re-uploaded {worst:.3f} of the payload")
        load = load_report(resps, SERVE_SWAP["rate"] * cap, SERVE_SWAP["seconds"],
                           NO_TIMEOUT_MS, wall_s)
        events = srv.metrics.summary().get("events", {})

        # a failing install rolls back; the previous generation keeps serving
        # (first the server catches up with the load's last mutation)
        settled = mi.freeze().generation
        wait_for(lambda: srv.generation == settled, "serve swap: the load's last install")
        prev_snap = srv.installer.serving
        prev_gen = prev_snap.generation
        with active_plan(FaultPlan({"serve.swap.install": FaultSpec("raise", at=(0,))})):
            mutate()
            wait_for(lambda: srv.installer.rollbacks == 1, "serve swap rollback")
        check(srv.generation == prev_gen, "serve swap: the rollback changed the generation")
        prev = copy.copy(prev_snap)
        prev._device, prev._searchers = {}, {}
        rows = list(range(8))
        futs = [srv.submit(db.queries[j], k=10, ef=64, storage=st)
                for j in rows for st in ("f32", "packed")]
        after = resolve_all(futs, "serve after rollback")
        for (j, st), r in zip([(j, st) for j in rows for st in ("f32", "packed")], after):
            check(r.ok and r.generation == prev_gen, "serve swap: after the rollback a "
                  f"request was served by generation {r.generation}, not {prev_gen}")
            ids, dists = run_bucketed(prev, swap_cfg, db.queries[[j]], r.ef_served,
                                      swap_cfg.expand, st, bucket=r.batch_bucket)[:2]
            check(np.array_equal(r.ids, ids[0]) and np.array_equal(r.dists, dists[0]),
                  "serve swap: a response after the rollback differs from its generation's")

        # one more generation into the serving caches, against a cold install
        mutate()
        target = mi.freeze().generation
        wait_for(lambda: srv.generation == target, "serve swap: the last install")
    finally:
        srv.stop()
    last = srv.installer.serving
    cold_equal = {}
    for st, cache in srv.installer.caches.items():
        bare = copy.copy(last)
        bare._device, bare._searchers = {}, {}
        cold = DeviceCache(storage=st, use_dfloat=True, donate=False)
        cold.install(bare)
        for name in ("_db", "_adj", "_tomb"):
            check(torch.equal(getattr(cache, name), getattr(cold, name)),
                  f"serve swap: the {st} cache's {name} differs from a cold install")
        cold_equal[st] = True
    log(json.dumps({"serve_swap": {
        "mutable_index_s": mutable_s, "start_s": swap_start_s, "replay_s": replay_s,
        "generations_served": len(gens), "installs": {
            m: sum(s.mode == m for _, s in stats) for m in ("full", "delta")},
        "install_ms": [[g, s * 1e3] for g, s, _ in installs],
        "upload": [dict(storage=st, generation=s.generation, mode=s.mode,
                        h2d_bytes=s.h2d_bytes,
                        full_bytes=s.full_bytes, reupload_fraction=s.reupload_fraction,
                        tail_rows=s.tail_rows, dirty_adj_rows=s.dirty_adj_rows,
                        dirty_tombstone_words=s.dirty_tombstone_words)
                   for st, s in stats],
        "max_delta_reupload_fraction": worst, "rollbacks": srv.installer.rollbacks,
        "delta_equals_cold": cold_equal, "events": events, "load": load}}))
    return loads, profiles



# phase 10: the sharded search over phase 3's index (LocalShards: C shards
# stacked on the card)
SHARDED_QUERIES = 10_000
SHARDED_PARITY = (("f32", 4), ("packed", 4), ("tiered", 4), ("f32", 8))
SHARDED_FEE = {"f32": "fee_distance", "packed": "fee_distance_packed",
               "tiered": "fee_distance_tiered"}
FEE_NAMES = tuple(k for k in REPLACES if k != "dfloat_unpack")
SHARDED_RECORD_CALL = 10           # the FEE call (hop) whose inputs 10a checks


def fee_by_storage(args, backend):
    """(dist, rejected, segs_used) of one recorded ``fee_distance_stale``
    call's lanes through ``backend``'s dispatcher entry for its storage."""
    from repro_torch.kernels import ops as kops

    db, ids, q, thr, _admit, alpha, beta, margin, kw = args
    common = dict(seg=kw["seg"], metric=kw["metric"], backend=backend,
                  lane_mask=kw["lane_mask"])
    cfg = kw["dfloat_cfg"]
    if cfg is None:
        return kops.fee_distance(db, ids, q, thr, alpha, beta, margin, **common)
    if isinstance(cfg, tuple):
        return kops.fee_distance_tiered(db[0], db[1], ids, q, thr, alpha, beta, margin,
                                        coarse_cfg=cfg[0], resid_cfg=cfg[1], **common)
    return kops.fee_distance_packed(db, ids, q, thr, alpha, beta, margin,
                                    dfloat_cfg=cfg, **common)


def sharded_kernel_check(args, storage, c):
    """The FEE kernel against its plain version on one recorded hop of the
    sharded search (its (C * Q, L) lanes over the stacked shards): live
    lanes held by ``repro_torch.kernels.check``, dead lanes equal, and both
    timed with CUDA events."""
    from repro_torch.core import search as search_mod
    from repro_torch.kernels.check import compare_fee, near_threshold

    db, ids, q, thr, _admit, alpha, beta, margin, kw = args
    got = fee_by_storage(args, "auto")
    want = fee_by_storage(args, "jnp")
    live = kw["lane_mask"]
    for a, b in zip(got, want):
        check(torch.equal(a[~live], b[~live]), f"sharded {storage} C={c}: dead lanes differ")
    lane_q = torch.arange(ids.shape[0], device=ids.device)[:, None].expand_as(ids)[live]
    flat = ids[live].long()
    rows = (db[flat] if kw["dfloat_cfg"] is None
            else search_mod.decode_rows(db, flat, kw["dfloat_cfg"]))
    near = near_threshold(rows[:, None, :], q[lane_q], thr[lane_q], alpha, beta, margin,
                          seg=kw["seg"], metric=kw["metric"])
    err, flips, n_near = compare_fee([t[live] for t in got], [t[live] for t in want],
                                     near, f"sharded {storage} C={c}")
    line = dict(storage=storage, n_shards=c, lanes=list(ids.shape),
                live_lanes=int(live.sum()), max_abs_err=err, exit_flips=flips,
                near_threshold=n_near,
                ms=time_ms(lambda: fee_by_storage(args, "auto")),
                plain_ms=time_ms(lambda: fee_by_storage(args, "jnp"), reps=3, warmup=1))
    log(json.dumps({"sharded_kernel": line}))


def sharded_phase(index, db, dev, kernels, n_q):
    """Phase 10: ``searcher("sharded")`` over phase 3's index.  10a: at
    ``compact=1.0`` each (storage, C) search bit-identical to the local one,
    launching its storage's FEE kernel (and ``dfloat_unpack`` for packed and
    tiered) and no other FEE kernel; one recorded hop's FEE launch against
    its plain version.  10b: lossy compaction (0.5), C = 4, f32: recall@10
    >= 0.80 and between the local search's at 0.5 and at 1.0, +- 0.005.
    10c: ``overlap=True``,
    C = 4, f32, ``compact=1.0``: mean id overlap@10 with 10a's sync result
    >= 0.99."""
    from repro_torch.data.synthetic import recall_at_k
    from repro_torch.index import SearchParams
    from repro_torch.kernels import ops as kops

    sub = dataclasses.replace(db, queries=db.queries[:n_q], gt=db.gt[:n_q])
    q = sub.queries
    n, d = index.n, index.dim
    local, sync = {}, {}
    for storage, c in SHARDED_PARITY:
        params = SearchParams(ef=64, k=10, compact=1.0, storage=storage)
        if storage not in local:
            local[storage] = run_search(index, sub, params, dev)
        t0 = time.perf_counter()
        run = index.searcher("sharded", params, device=dev, n_shards=c)
        build_s = time.perf_counter() - t0
        # the warm-up call records one hop's FEE inputs for the kernel check
        calls, stale = [], kops.fee_distance_stale

        def recording(db_, ids, q_, exit_thr, admit_thr, alpha, beta, margin, **kw):
            if len(calls) <= SHARDED_RECORD_CALL:
                calls.append((db_, ids, q_, exit_thr, admit_thr, alpha, beta, margin, kw))
            return stale(db_, ids, q_, exit_thr, admit_thr, alpha, beta, margin, **kw)

        kops.fee_distance_stale = recording
        try:
            run(q)
        finally:
            kops.fee_distance_stale = stale
        if c == 4:
            sharded_kernel_check(calls[-1], storage, c)
        del calls
        for fn in kernels.values():
            fn.launches = 0
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            res = run(q)
            secs.append(time.perf_counter() - t0)
        counts = {k: fn.launches for k, fn in kernels.items()}
        fee = SHARDED_FEE[storage]
        check(counts[fee] > 0, f"sharded {storage} C={c}: {fee} was not launched")
        others = {k: counts[k] for k in FEE_NAMES if k != fee and counts[k]}
        check(not others, f"sharded {storage} C={c} launched other FEE kernels: {others}")
        if storage != "f32":
            check(counts["dfloat_unpack"] > 0,
                  f"sharded {storage} C={c}: dfloat_unpack was not launched")
        want, lsecs = local[storage]
        check(np.array_equal(res.ids, want.ids) and np.array_equal(res.dists, want.dists),
              f"sharded {storage} C={c}: ids or distances differ from the local search's "
              f"({int((res.ids != want.ids).sum())} ids)")
        check(np.array_equal(res.hops, want.hops), f"sharded {storage} C={c}: hops differ")
        hop_loops = int(res.hops.max())
        pay = run.payload
        words = {"f32": d, "packed": index.db_packed.shape[1],
                 "tiered": sum(t.shape[1] for t in index.tier_arrays())}[storage]
        log(json.dumps({"sharded": {
            "n_shards": c, "storage": storage, "compact": 1.0, "batch": len(q),
            "qps": len(q) * REPEATS / sum(secs), "p50_call_ms": float(np.median(secs)) * 1e3,
            "local_qps": len(q) * len(lsecs) / sum(lsecs),
            "local_p50_call_ms": float(np.median(lsecs)) * 1e3,
            "searcher_build_s": build_s, "hop_loops": hop_loops,
            "hops_mean": float(res.hops.mean()),
            "fee_launches_per_hop": counts[fee] / (REPEATS * hop_loops),
            "unpack_launches": counts["dfloat_unpack"],
            "partition_width_mc": pay["local_lanes"] // pay["expand"],
            "stacked_rows_bytes": c * -(-n // c) * words * 4,
            "part_adj_bytes": n * c * (pay["local_lanes"] // pay["expand"]) * 4,
            "search_peak_bytes": torch.cuda.max_memory_allocated() - held,
            "recall_at_10": recall_at_k(res.ids, sub.gt, 10), "payload": pay}}))
        sync[(storage, c)] = res
        del run
        if (storage, c) == ("f32", 4):
            profile_search(index, sub, dev, float(np.median(secs)) * 1e3, "f32",
                           "sharded", compact=1.0, n_shards=4)
            profile_search(index, sub, dev, float(np.median(local["f32"][1])) * 1e3,
                           "f32", compact=1.0)

    # 10b: lossy compaction, the default 0.5.  Each shard keeps
    # max(Mc, 4 Mc / 2) of its own fresh lanes, C times the local search's
    # one budget of 40 in all, so it drops fewer lanes: its recall lies
    # between the local search's at 0.5 and at 1.0 (10a's, lossless)
    params = SearchParams(ef=64, k=10, storage="f32")
    lossy = index.searcher("sharded", params, device=dev, n_shards=4)(q)
    base = index.searcher("local", params, device=dev)(q)
    rec, rec_local = recall_at_k(lossy.ids, sub.gt, 10), recall_at_k(base.ids, sub.gt, 10)
    rec_lossless = recall_at_k(local["f32"][0].ids, sub.gt, 10)
    log(json.dumps({"sharded_lossy": {"n_shards": 4, "compact": 0.5, "recall_at_10": rec,
                                      "local_recall_at_10": rec_local,
                                      "local_compact1_recall_at_10": rec_lossless,
                                      "id_overlap_with_local": overlap(lossy.ids, base.ids)}}))
    check(rec >= 0.80, f"sharded compact=0.5: recall@10 {rec:.4f} < 0.80")
    check(rec_local - 0.005 <= rec <= rec_lossless + 0.005,
          f"sharded compact=0.5: recall@10 {rec:.4f} outside [{rec_local:.4f}, "
          f"{rec_lossless:.4f}] (the local search at compact 0.5 and 1.0) +- 0.005")

    # 10c: the double-buffered pipeline against 10a's sync result
    params = SearchParams(ef=64, k=10, compact=1.0, storage="f32")
    run = index.searcher("sharded", params, device=dev, n_shards=4, overlap=True)
    run(q)
    t0 = time.perf_counter()
    ov = run(q)
    secs = time.perf_counter() - t0
    frac = overlap(ov.ids, sync[("f32", 4)].ids)
    log(json.dumps({"sharded_overlap": {"n_shards": 4, "id_overlap_with_sync": frac,
                                        "qps": len(q) / secs,
                                        "hops_mean": float(ov.hops.mean()),
                                        "recall_at_10": recall_at_k(ov.ids, sub.gt, 10)}}))
    check(frac >= 0.99, f"sharded overlap vs sync id overlap@10 {frac:.4f} < 0.99")

# phase 11: the LM stack and retrieval-augmented generation
LM_SMOKE_TOL = 1e-4                # 11a: card against CPU, float32, TF32 off
LM_F32_TOL = 5e-4                  # 11b: decode against forward, the reference's bound
LM_BF16_TOL = 3e-2                 # 11b in bfloat16 (PERF.md, stated before the first run)
LM_ARCH = "llama3.2-1b"
LM_PARAMS = 1_235_814_400          # ModelConfig.param_count of llama3.2-1b
RAG_BATCHES = (4, 32)              # the reference example's batch, and a serving batch
RAG_DOCS, RAG_QUESTION, RAG_GEN = 8, 56, 32
RAG_RECALL = 0.80
RAG_PROFILE_STEPS = 8              # decode steps under torch.profiler


def device_rows(prof):
    """The device's rows of a ``torch.profiler`` run's ``key_averages()``."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]


def lm_profile(api, params, prompt, n_steps=RAG_PROFILE_STEPS):
    """``torch.profiler`` over a prefill of ``prompt`` and then over
    ``n_steps`` greedy decode steps: launches and device-busy ms of the
    prefill and of a step, and a step's costliest kernels."""
    from torch.profiler import ProfilerActivity, profile

    tokens = torch.from_numpy(prompt).long().to(params.embed.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pre:
        logits, cache = api.prefill(params, dict(tokens=tokens),
                                    prompt.shape[1] + n_steps + 1)
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as dec:
        for _ in range(n_steps):
            logits, cache = api.decode(params, cache, tok)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
    pre_rows, dec_rows = device_rows(pre), device_rows(dec)
    if not pre_rows or not dec_rows:
        return {"profile": "the profiler recorded no device time: not measured"}
    ms = lambda rows: sum(e.self_device_time_total for e in rows) / 1e3
    top = sorted(dec_rows, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    return {"prefill_launches": sum(e.count for e in pre_rows),
            "prefill_busy_ms": ms(pre_rows),
            "decode_launches_per_step": sum(e.count for e in dec_rows) / n_steps,
            "decode_busy_ms_per_step": ms(dec_rows) / n_steps,
            "decode_top": [[e.key[:80], e.self_device_time_total / 1e3 / n_steps,
                            e.count / n_steps] for e in top]}


def lm_phase(index, db, dev, kernels):
    """Phase 11: (11a) the 10 smoke architectures' forward, prefill and 6
    decode steps in float32 on the card against the CPU, one set of weights;
    (11b) llama3.2-1b at full width, decode against forward in float32 and
    bfloat16, and its parameter count; (11c) RAG: packed top-8 retrieval
    over phase 3's index feeding the bfloat16 model, a 64-token prompt and
    32 greedy tokens, at each of ``RAG_BATCHES``."""
    from repro_torch import configs as C
    from repro_torch.data.synthetic import recall_at_k
    from repro_torch.index import SearchParams
    from repro_torch.launch import rag
    from repro_torch.models import get_model
    from repro_torch.models.check import card_against_cpu, decode_against_forward
    from repro_torch.utils import param_count

    t0 = time.perf_counter()
    errs = {arch: card_against_cpu(C.get_smoke(arch), dev) for arch in C.ARCHS}
    worst = max(max(e.values()) for e in errs.values())
    log(json.dumps({"models": {"errors": errs, "max": worst, "bound": LM_SMOKE_TOL,
                               "s": time.perf_counter() - t0}}))
    bad = {a: e for a, e in errs.items() if max(e.values()) >= LM_SMOKE_TOL}
    check(not bad, f"11a: card against CPU over {LM_SMOKE_TOL}: {bad}")

    t0 = time.perf_counter()
    cfg = C.get_config(LM_ARCH)
    api32 = get_model(dataclasses.replace(cfg, dtype=torch.float32), dev)
    params = api32.init(api32.generator(0))
    n_params = param_count(params)
    err32 = decode_against_forward(api32, params)
    del params
    torch.cuda.empty_cache()
    api = get_model(cfg, dev)
    params = api.init(api.generator(0))         # the float32 draws rounded once
    err16 = decode_against_forward(api, params)
    log(json.dumps({"llama_full": {"arch": LM_ARCH, "params": n_params,
                                   "f32_err": err32, "f32_bound": LM_F32_TOL,
                                   "bf16_err": err16, "bf16_bound": LM_BF16_TOL,
                                   "weights_gb": param_count(params) * 2 / 1e9,
                                   "s": time.perf_counter() - t0}}))
    check(n_params == cfg.param_count() == LM_PARAMS,
          f"11b: {n_params} parameters, the config counts {cfg.param_count()}")
    check(err32 < LM_F32_TOL, f"11b: float32 decode against forward {err32:.3g}")
    check(err16 < LM_BF16_TOL, f"11b: bfloat16 decode against forward {err16:.3g}")

    run = index.searcher("local", SearchParams(ef=64, k=RAG_DOCS, storage="packed"),
                         device=dev)
    weight_bytes = param_count(params) * 2
    for b in RAG_BATCHES:
        queries = db.queries[:b]
        run(queries)                            # warm-up
        for fn in kernels.values():
            fn.launches = 0
        ids, retrieve_ms = rag.retrieve(run, queries)
        counts = {k: fn.launches for k, fn in kernels.items()}
        for k in ("fee_distance_packed", "dfloat_unpack"):
            check(counts[k] > 0, f"11c: the packed retrieval did not launch {k}")
        again, _ = rag.retrieve(run, queries)
        check(np.array_equal(ids, again), f"11c: retrieval ids of B={b} not repeatable")
        recall = recall_at_k(ids, db.gt[:b], RAG_DOCS)
        check(recall >= RAG_RECALL, f"11c: recall@{RAG_DOCS} {recall:.4f} < {RAG_RECALL}")

        prompt = rag.rag_prompt(ids, cfg.vocab, RAG_QUESTION)
        rag.generate(api, params, prompt, 2)    # warm-up
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        gen, prefill_ms, decode_ms = rag.generate(api, params, prompt, RAG_GEN)
        peak = torch.cuda.max_memory_allocated(dev)
        gen2, prefill2_ms, decode2_ms = rag.generate(api, params, prompt, RAG_GEN)
        check(np.array_equal(gen, gen2), f"11c: generated ids of B={b} not repeatable")
        prof = lm_profile(api, params, prompt)
        r = rag.report(ids, retrieve_ms, gen, prefill_ms, decode_ms)
        steps = r["decode_steps"]
        prompt_tokens = b * prompt.shape[1]
        log(json.dumps({"rag": {
            **r, "prompt_len": prompt.shape[1], "gen": RAG_GEN, "storage": "packed",
            "recall_at_8": recall, "retrieval_launches": counts,
            "repeat": {"prefill_ms": prefill2_ms, "decode_ms": decode2_ms},
            "decode_step_ms": decode_ms / steps,
            "decode_step_bound_ms": weight_bytes / h100("HBM_BW") * 1e3,
            **prof,
            "prefill_tflop": 2 * LM_PARAMS * prompt_tokens / 1e12,
            "prefill_bound_ms": 2 * LM_PARAMS * prompt_tokens / h100("PEAK_FLOPS_BF16") * 1e3,
            "peak_gb": peak / 1e9, "peak_above_held_gb": (peak - before) / 1e9}}))
    del params
    torch.cuda.empty_cache()


# phase 12: LM training
TRAIN_SMOKE_TOL = 1e-4             # 12a: loss and gradients, card against CPU (11a's bound)
TRAIN_STEP_SHARE = 1e-4            # 12a: share of weights outside rtol 2e-4 / atol 2e-5 of
                                   # the CPU's after one step (the CPU tests' bound)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 128, 3e-4    # the reference trainer's defaults
TRAIN_MB = 2                       # examples/train_lm.py's --microbatch
TRAIN_OVERFIT_STEPS, TRAIN_DROP = 10, 0.5          # tests/test_training.py's criterion
TRAIN_MB_TOL = 1e-3                # 12b: first loss, microbatch 2 against 1 (PERF.md,
                                   # stated before the first run)
TRAIN_WARMUP, TRAIN_TIMED = 2, 8
TRAIN_RESUME_TOL = 1e-4            # 12c: tests/test_ft.py's bound


def _train_batch(batch: dict, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev, torch.long if v.dtype.kind == "i" else None)
            for k, v in batch.items()}


def train_phase(dev):
    """Phase 12: (12a) the 10 smoke architectures' loss and gradients in
    float32 on the card against the CPU, one set of weights, and the weights
    after one AdamW and one Adafactor step; (12b) llama3.2-1b at full width
    in bfloat16 (AdamW, lr 3e-4, batch 8 x 128, microbatch 2, remat): 10
    steps on one batch lower the loss by more than 0.5, the first loss at
    microbatch 2 equals microbatch 1's, then 8 timed steps of the
    step-indexed pipeline after 2 warm-ups, one profiled step, the
    optimizer alone, peak memory; (12c) the trainer on the card crashed at
    step 7 and resumed from step 5 ends at the uninterrupted run's loss."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs as C
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import get_model
    from repro_torch.training import OptConfig, init_state, make_train_step, optim
    from repro_torch.training import check as train_check
    from repro_torch.training.tree import regroup, tensors
    from repro_torch.utils import param_count

    t0 = time.perf_counter()
    errs = {arch: train_check.card_against_cpu(C.get_smoke(arch), dev) for arch in C.ARCHS}
    log(json.dumps({"train_models": {"errors": errs, "bound": TRAIN_SMOKE_TOL,
                                     "step_share_bound": TRAIN_STEP_SHARE,
                                     "s": time.perf_counter() - t0}}))
    bad = {a: e for a, e in errs.items()
           if max(e["loss"], e["grads"]) >= TRAIN_SMOKE_TOL
           or max(e["adamw"]["share"], e["adafactor"]["share"]) > TRAIN_STEP_SHARE}
    check(not bad, f"12a: training, card against CPU: {bad}")

    t0 = time.perf_counter()
    cfg = C.get_config(LM_ARCH)                 # bfloat16, remat, AdamW
    check(cfg.remat and cfg.optimizer == "adamw" and cfg.microbatch == TRAIN_MB,
          f"12b: {LM_ARCH}'s config changed: {cfg}")
    api = get_model(cfg, dev)
    params = api.init(api.generator(0))
    n_params = param_count(params)
    check(n_params == LM_PARAMS, f"12b: {n_params} parameters")
    pipe = TokenPipeline(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=1)
    batch0 = _train_batch(pipe.batch_at(0), dev)
    with torch.no_grad():
        loss_mb1 = float(api.loss(params, batch0)[0])
    opt = OptConfig(name=cfg.optimizer, lr=TRAIN_LR)
    state = init_state(api.param_tree(params), opt)
    step = make_train_step(api.tree_loss, opt, microbatch=TRAIN_MB)
    losses, gnorms = [], []
    for _ in range(TRAIN_OVERFIT_STEPS):       # overfit one batch
        state, m = step(state, batch0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    mb_err = abs(losses[0] - loss_mb1) / abs(loss_mb1)

    for i in range(TRAIN_WARMUP):
        state, m = step(state, _train_batch(pipe.batch_at(1 + i), dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    step_ms = []
    for i in range(TRAIN_TIMED):
        t1 = time.perf_counter()
        state, m = step(state, _train_batch(pipe.batch_at(1 + TRAIN_WARMUP + i), dev))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated(dev)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, m = step(state, _train_batch(pipe.batch_at(99), dev))
        torch.cuda.synchronize()
    rows = device_rows(prof)
    top = sorted(rows, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    prof_line = ({"step_launches": sum(e.count for e in rows),
                  "step_busy_ms": sum(e.self_device_time_total for e in rows) / 1e3,
                  "top": [[e.key[:80], e.self_device_time_total / 1e3, e.count] for e in top]}
                 if rows else {"profile": "the profiler recorded no device time: not measured"})

    # the optimizer alone, over float32 gradients (what microbatching hands it)
    tree = state.params
    grads = regroup(tree, [torch.zeros(t.shape, dtype=torch.float32, device=dev)
                           for t in tensors(tree)])
    opt_bytes = sum(t.numel() * (2 * t.element_size() + 4 + 16) for t in tensors(tree))
    opt_ms = time_ms(lambda: optim.apply_updates(tree, grads, state.opt_state, opt),
                     reps=3, warmup=1)
    del grads

    tokens = TRAIN_BATCH * TRAIN_SEQ
    flop = 8 * LM_PARAMS * tokens               # forward, recomputed forward, backward
    p50 = float(np.median(step_ms))
    state_gb = 16 * LM_PARAMS / 1e9             # bf16 weights and grads, f32 acc, mu, nu
    log(json.dumps({"train_full": {
        "arch": LM_ARCH, "params": n_params, "dtype": "bfloat16", "optimizer": cfg.optimizer,
        "lr": TRAIN_LR, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "microbatch": TRAIN_MB,
        "remat": cfg.remat, "losses": losses, "grad_norms": gnorms,
        "overfit_drop": losses[0] - losses[TRAIN_OVERFIT_STEPS - 1], "drop_bound": TRAIN_DROP,
        "loss_mb1": loss_mb1, "loss_mb2": losses[0], "mb_rel_err": mb_err,
        "mb_bound": TRAIN_MB_TOL, "step_ms": step_ms, "step_ms_p50": p50,
        "tokens_per_s": tokens / p50 * 1e3, "step_tflop": flop / 1e12,
        "model_flop_share": flop / (p50 / 1e3 * h100("PEAK_FLOPS_BF16")),
        "flop_bound_ms": flop / h100("PEAK_FLOPS_BF16") * 1e3, "opt_ms": opt_ms,
        "opt_bytes_gb": opt_bytes / 1e9, "opt_bound_ms": opt_bytes / h100("HBM_BW") * 1e3,
        "step_bound_ms": (flop / h100("PEAK_FLOPS_BF16") + opt_bytes / h100("HBM_BW")) * 1e3,
        "peak_gb": peak / 1e9, "held_before_gb": held / 1e9, "analytic_state_gb": state_gb,
        **prof_line, "s": time.perf_counter() - t0}}))
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"12b: a loss or grad norm is not finite: {losses} {gnorms}")
    check(losses[TRAIN_OVERFIT_STEPS - 1] < losses[0] - TRAIN_DROP,
          f"12b: 10 steps on one batch: loss {losses[0]:.4f} -> "
          f"{losses[TRAIN_OVERFIT_STEPS - 1]:.4f}, not below by {TRAIN_DROP}")
    check(mb_err < TRAIN_MB_TOL, f"12b: first loss at microbatch 2 {losses[0]:.6f} vs 1 "
          f"{loss_mb1:.6f}: {mb_err:.3g} >= {TRAIN_MB_TOL}")
    del state, params, tree, m
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    work = BUILD / "train_resume"
    shutil.rmtree(work, ignore_errors=True)
    try:
        res = train_check.crash_and_resume("cuda", work, SRC)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(json.dumps({"train_resume": {**res, "bound": TRAIN_RESUME_TOL,
                                     "s": time.perf_counter() - t0}}))
    check(res["rc_full"] == 0 and res["rc_resume"] == 0
          and res["rc_crash"] == train_check.FAILURE_EXIT,
          f"12c: trainer exit codes {res}")
    check(res["restored"], "12c: the resumed run did not restore step 5")
    check(abs(res["resumed_loss"] - res["final_loss"]) < TRAIN_RESUME_TOL,
          f"12c: resumed final loss {res['resumed_loss']} vs {res['final_loss']}")


# phase 13: LM training over a (data, model) mesh of ranks sharing the card
MESH_SHAPES = ((2, 1), (1, 2))
MESH_SMOKE_TOL = 1e-4              # 13a: loss and gradients, mesh against one process
MESH_FULL_TOL = 3e-4               # 13b: each loss, relative to the one-process run's:
                                   # sound 1.2e-4, planted faults 1.2e-3 and 1.4e-3
                                   # (1e-2 before those readings; PERF.md)
MESH_GNORM_TOL = 3e-3              # 13b: each grad_norm, relative: sound 8.3e-4,
                                   # planted faults 0.22-0.65 (PERF.md)
MESH_INIT_SLACK_GB = 0.1           # 13b: a rank's peak while drawing the weights over
                                   # its blocks, beyond the largest weight's draw
MESH_RESUME_TOL = 1e-4             # 13c: tests/test_ft.py's bound
# 13b's steps a layout: 1 warm-up and 1 timed, cut from mesh_check.FULL's 4
# (1 and 3) to make room for phase 14, since the script ran 879.7 s with
# them (PERF.md); each gloo step takes 9-15 s
MESH_FULL_STEPS = 2


def mesh_phase(dev):
    """Phase 13: training on a mesh of 2 ranks that share the card over gloo
    (``repro_torch.training.mesh_check.chip_rank``, one spawn a layout, at
    (2, 1) and (1, 2)): (13a) the 10 smoke architectures in float32, one
    differentiation and one AdamW and one Adafactor step against the
    one-process ones; (13b) llama3.2-1b at full width in bfloat16 (AdamW,
    lr 3e-4, batch 8 x 128, microbatch 2, remat), the weights drawn a
    weight at a time (a rank's peak within its blocks and the largest
    weight's draw), 1 warm-up and 1 timed step of the step-indexed pipeline,
    each loss and grad_norm against the one-process trainer's from the
    same seeded weights on the same batches (run here first);
    (13c) the smoke llama through ``launch/train.py --devices 2 --backend
    gloo`` crashed at step 7 and resumed ends at the uninterrupted run's
    loss, and its step-5 checkpoint resumes in the one-process trainer."""
    from repro_torch import configs as C
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import get_model
    from repro_torch.training import OptConfig, init_state, make_train_step
    from repro_torch.training import check as train_check
    from repro_torch.training import mesh_check

    BUILD.mkdir(exist_ok=True)
    log(json.dumps({"reduced": {"mesh_full_steps": MESH_FULL_STEPS,
                                "from": mesh_check.FULL["steps"],
                                "why": "room for phase 14: the script ran 879.7 s with "
                                       "13b's 4 steps a layout"}}))
    t0 = time.perf_counter()
    cfg = C.get_config(mesh_check.FULL_ARCH)
    full = mesh_check.FULL
    api = get_model(cfg, dev)
    params = api.init(api.generator(0))
    opt = OptConfig(name=cfg.optimizer, lr=full["lr"])
    state = init_state(api.param_tree(params), opt)
    step = make_train_step(api.tree_loss, opt, microbatch=cfg.microbatch)
    pipe = TokenPipeline(cfg.vocab, full["batch"], full["seq"], seed=1)
    ref_losses, ref_gnorms, ref_ms = [], [], []
    for i in range(MESH_FULL_STEPS):
        t1 = time.perf_counter()
        state, m = step(state, _train_batch(pipe.batch_at(i), dev))
        ref_losses.append(float(m["loss"]))
        ref_gnorms.append(float(m["grad_norm"]))
        ref_ms.append((time.perf_counter() - t1) * 1e3)
    del state, params, m
    torch.cuda.empty_cache()
    log(json.dumps({"mesh_reference": {"arch": mesh_check.FULL_ARCH, "losses": ref_losses,
                                       "grad_norms": ref_gnorms, "step_ms": ref_ms,
                                       "s": time.perf_counter() - t0}}))

    for shape in MESH_SHAPES:
        t0 = time.perf_counter()
        out = BUILD / f"mesh_{shape[0]}x{shape[1]}.json"
        out.unlink(missing_ok=True)
        spawn(mesh_check.chip_rank, 2, args=(shape, str(out), tuple(REPLACES),
                                             MESH_FULL_STEPS),
              device="cuda", backend="gloo", store=BUILD / "mesh_store")
        res = json.loads(out.read_text())
        log(json.dumps({"mesh_models": {"mesh": list(shape), "errors": res["smoke"],
                                        "bound": MESH_SMOKE_TOL,
                                        "step_share_bound": TRAIN_STEP_SHARE,
                                        "s": res["smoke_s"]}}))
        bad = {a: e for a, e in res["smoke"].items()
               if max(e["loss"], e["grads"]) >= MESH_SMOKE_TOL
               or max(e["adamw"]["share"], e["adafactor"]["share"]) > TRAIN_STEP_SHARE}
        check(not bad, f"13a: mesh {shape} against one process: {bad}")
        f = res["full"]
        rel = [abs(a - b) / abs(b) for a, b in zip(f["losses"], ref_losses)]
        grel = [abs(a - b) / abs(b) for a, b in zip(f["grad_norms"], ref_gnorms)]
        log(json.dumps({"mesh_full": {**f, "ref_losses": ref_losses, "loss_rel_err": rel,
                                      "ref_grad_norms": ref_gnorms, "grad_norm_rel_err": grel,
                                      "bound": MESH_FULL_TOL, "grad_norm_bound": MESH_GNORM_TOL,
                                      "launches": res["launches"],
                                      "s": time.perf_counter() - t0}}))
        check(all(np.isfinite(f["losses"] + f["grad_norms"])),
              f"13b: a loss or grad norm is not finite: {f['losses']} {f['grad_norms']}")
        check(max(rel) < MESH_FULL_TOL,
              f"13b: mesh {shape} losses {f['losses']} vs one process {ref_losses}")
        check(max(grel) < MESH_GNORM_TOL,
              f"13b: mesh {shape} grad norms {f['grad_norms']} vs one process {ref_gnorms}")
        over = [r for r in f["ranks"] if r["draw_peak_gb"]
                > r["blocks_gb"] + f["largest_weight_gb"] + MESH_INIT_SLACK_GB]
        check(not over, f"13b: a rank held more than its blocks and one weight while "
              f"drawing the weights: {over} (largest weight {f['largest_weight_gb']} GB)")
        check(not any(res["launches"].values()),
              f"13: the mesh path launched a search kernel: {res['launches']}")

    t0 = time.perf_counter()
    work = BUILD / "mesh_resume"
    shutil.rmtree(work, ignore_errors=True)
    try:
        # the one-process trainer resumes from the mesh's step-5 checkpoint
        # while the mesh run resumes from it
        res = train_check.crash_and_resume(
            "cuda", work, SRC, extra=("--devices", "2", "--backend", "gloo"),
            alongside=lambda crash: train_check.resume_one_process(
                "cuda", crash / f"step_{train_check.RESUME_STEP}", work / "one", SRC))
        one = res.pop("alongside")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(json.dumps({"mesh_resume": {**res, "one_process": one, "bound": MESH_RESUME_TOL,
                                    "s": time.perf_counter() - t0}}))
    check(res["rc_full"] == 0 and res["rc_resume"] == 0
          and res["rc_crash"] == train_check.FAILURE_EXIT,
          f"13c: mesh trainer exit codes {res}")
    check(res["restored"], "13c: the resumed mesh run did not restore step 5")
    check(abs(res["resumed_loss"] - res["final_loss"]) < MESH_RESUME_TOL,
          f"13c: resumed final loss {res['resumed_loss']} vs {res['final_loss']}")
    check(one["rc"] == 0 and one["restored"] and "losses" in res
          and abs(one["loss"] - res["losses"][train_check.RESUME_STEP]) < MESH_RESUME_TOL,
          f"13c: the one-process trainer from the mesh's step-5 checkpoint: {one}")


# phase 14: LM serving on a (data, model) mesh of ranks sharing the card
SERVE_SHAPES = ((2, 1), (1, 2))    # 14b runs on the last
SERVE_SMOKE_TOL = 1e-4             # 14a: logits and cache, mesh against one process
SERVE_FULL_TOL = 3e-2              # 14b: each step's logits in bfloat16, of the largest
                                   # |logit| (11b's bfloat16 bound; PERF.md, stated
                                   # before the first run)


def _sample_ids(out: str) -> str:
    return next(line for line in out.splitlines() if line.startswith("sample token ids:"))


def mesh_serve_phase(dev):
    """Phase 14: serving on a mesh of 2 ranks that share the card over gloo
    (the module docstring): (14a) the smoke architectures against the
    one-process decode, (14b) llama3.2-1b at full width against the
    one-process run made here first, (14c) ``launch/serve.py --decode
    --devices 2`` against one process."""
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import mesh_check

    BUILD.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    ref = mesh_check.full_reference(dev)
    ref_path = BUILD / "mesh_serve_ref.npz"
    np.savez(ref_path, **{k: v for k, v in ref.items() if k != "step_ms"})
    log(json.dumps({"mesh_serve_reference": {
        "arch": mesh_check.FULL_ARCH, **{k: v for k, v in mesh_check.FULL.items()},
        "step_ms": ref["step_ms"], "step_ms_p50": float(np.median(ref["step_ms"])),
        "s": time.perf_counter() - t0}}))

    t0 = time.perf_counter()
    out = BUILD / "mesh_serve.json"
    out.unlink(missing_ok=True)
    spawn(mesh_check.chip_rank, 2, args=(SERVE_SHAPES, str(ref_path), str(out),
                                         tuple(REPLACES)),
          device="cuda", backend="gloo", store=BUILD / "mesh_serve_store")
    res = json.loads(out.read_text())
    for key, cases in res["smoke"].items():
        log(json.dumps({"mesh_serve_models": {
            "mesh": key, "errors": {a: {k: c[k] for k in ("logits", "cache", "weight_moves")}
                                    for a, c in cases.items()},
            "bound": SERVE_SMOKE_TOL, "s": res["smoke_s"][key]}}))
        bad = {a: c for a, c in cases.items()
               if max(c["logits"], c["cache"]) >= SERVE_SMOKE_TOL or c["weight_moves"]}
        check(not bad, f"14a: serving at {key} against one process: {bad}")
    f = res["full"]
    log(json.dumps({"mesh_serve_full": {**f, "bound": SERVE_FULL_TOL,
                                        "launches": res["launches"],
                                        "s": time.perf_counter() - t0}}))
    check(len(f["errors"]) == mesh_check.FULL["steps"] + 1 and all(np.isfinite(f["errors"])),
          f"14b: {len(f['errors'])} logits errors: {f['errors']}")
    check(max(f["errors"]) < SERVE_FULL_TOL,
          f"14b: full-width logits on the mesh against one process: {f['errors']}")
    check(f["serve_step"]["weight_moves"]["calls"] == 0,
          f"14b: a serve-layout step moved weights: {f['serve_step']['weight_moves']}")
    check(f["train_step"]["weight_moves"]["calls"] > 0,
          "14b: the train-layout step moved no weight (its use sites gather them)")
    for layout in ("serve_step", "train_step"):
        got, meta = f[layout], f[layout]["meta_pass"]
        check((got["collective_bytes"], got["calls"]) == (meta["bytes"], meta["calls"]),
              f"14b: the {layout}'s collectives {got['collective_bytes']} B in "
              f"{got['calls']} calls, the dry run's meta pass {meta}")
    check(not any(res["launches"].values()),
          f"14: the serving mesh path launched a search kernel: {res['launches']}")

    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--decode", "--smoke"]
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    runs = [subprocess.run(cmd + extra, capture_output=True, text=True, timeout=300, env=env)
            for extra in ([], ["--devices", "2", "--backend", "gloo"])]
    for r in runs:
        check(r.returncode == 0, f"14c: launch/serve.py --decode: {r.stderr[-2000:]}")
    one, mesh = (_sample_ids(r.stdout) for r in runs)
    log(json.dumps({"mesh_serve_cli": {"one_process": one, "devices_2": mesh,
                                       "s": time.perf_counter() - t0}}))
    check(one == mesh, f"14c: --devices 2 printed {mesh!r}, one process {one!r}")


# phase 15: the compression baselines at the main path's width, and the twins
# of the examples
BASELINE_SUBS = (8, 16, 32, 64)    # benchmarks/fig20_memory_traffic.py:23's sweep
BASELINE_QUERIES = 24
PQ_FIT = dict(iters=4, sample=4000)
PQ_RERANK, RABITQ_RERANK = 40, 30
CPU_ROWS = 65_536                  # rows whose codes and signs the CPU recomputes


def _rerank_recall(rows_d, queries_d, cands, gt, k=10):
    """Exact l2 over each query's candidates, the k nearest against ``gt``."""
    from repro_torch.data.synthetic import recall_at_k

    d = ((rows_d[cands] - queries_d[:, None, :]) ** 2).sum(-1)
    top = torch.gather(cands, 1, d.topk(k, dim=1, largest=False).indices)
    return recall_at_k(top.cpu().numpy(), gt, k)


def _fit_timed(fn, dev):
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def baselines_phase(rows, queries, gt, dev, kernels):
    """Phase 15a: PQ at each n_sub of BASELINE_SUBS and RaBitQ, fitted on the
    card over every row of ``rows`` (phase 3's ``db_rot``); each fit twice
    (bit-equal), against the port's CPU fit (``core.baselines_check``: the
    CPU tests' bounds, codes and signs on the first CPU_ROWS rows), the ADC
    and the estimates over every row for BASELINE_QUERIES queries with an
    exact re-rank (recall@10), and from one state on both devices."""
    from repro_torch.core import baselines as bl
    from repro_torch.core import baselines_check as bc

    n, d = rows.shape
    rows_d = torch.from_numpy(rows).to(dev)
    q_host = queries[:BASELINE_QUERIES]
    q_d = torch.from_numpy(q_host).to(dev)
    gt = gt[:BASELINE_QUERIES, :10]
    ids = torch.arange(n, device=dev)
    prefix = rows[:CPU_ROWS]
    for fn in kernels.values():
        fn.launches = 0
    for n_sub in BASELINE_SUBS:
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        fit = lambda: bl.fit_pq(rows, n_sub, "l2", device=dev, **PQ_FIT)
        pq, fit_s = _fit_timed(fit, dev)
        codes, encode_s = _fit_timed(lambda: bl.pq_encode(pq.codebooks, rows), dev)
        adc = lambda: [bl.pq_distances(pq, q, ids) for q in q_d]
        dists = torch.stack(adc())
        peak = torch.cuda.max_memory_allocated() - held
        adc_ms = time_ms(adc, reps=3, warmup=1) / len(q_d)
        recall = _rerank_recall(rows_d, q_d, dists.topk(PQ_RERANK, dim=1, largest=False).indices,
                                gt)
        again = fit()
        check(bc.same_bits(again, pq) and torch.equal(codes, pq.codes),
              f"15a: two PQ fits (n_sub {n_sub}) from seed 0 differ on the card")
        del again, codes
        t0 = time.perf_counter()
        cpu_books = bl.pq_codebooks(rows, n_sub, device="cpu", **PQ_FIT)
        cpu = bc.compare_pq(pq, cpu_books, bl.pq_encode(cpu_books, prefix), prefix,
                            f"15a PQ n_sub {n_sub} card vs CPU")
        here = bl.PQ(pq.codebooks.cpu(), pq.codes[:CPU_ROWS].cpu(), pq.d_sub, pq.metric)
        adc_rel = max(bc.close(dists[i, :CPU_ROWS], bl.pq_distances(here, q, np.arange(CPU_ROWS)),
                               f"15a ADC n_sub {n_sub}, query {i}")
                      for i, q in enumerate(q_host))
        b_ms, b_by = bound(n * n_sub + n_sub * bl.K * 4 + n * 4, 0)
        log(json.dumps({"baseline_pq": {
            "n": n, "dim": d, "n_sub": n_sub, **PQ_FIT, "bits_per_vector": pq.bits_per_vector,
            "fit_s": fit_s, "encode_s": encode_s, "train_s": fit_s - encode_s,
            "adc_ms_per_query": adc_ms, "adc_bound_ms": b_ms, "adc_bound_by": b_by,
            "adc_bound_share": b_ms / adc_ms, "rerank": PQ_RERANK, "recall_at_10": recall,
            "peak_bytes": peak, "card_vs_cpu": {**cpu, "adc_rel": adc_rel},
            "cpu_check_s": time.perf_counter() - t0}}))
        del pq, dists, here

    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fit = lambda: bl.fit_rabitq(rows, "l2", device=dev)
    rq, fit_s = _fit_timed(fit, dev)
    est_fn = lambda: [bl.rabitq_estimate(rq, q, ids) for q in q_host]
    est = torch.stack(est_fn())
    peak = torch.cuda.max_memory_allocated() - held
    est_ms = time_ms(est_fn, reps=3, warmup=1) / len(q_host)
    recall = _rerank_recall(rows_d, q_d, est.topk(RABITQ_RERANK, dim=1, largest=False).indices,
                            gt)
    check(bc.same_bits(fit(), rq), "15a: two RaBitQ fits from seed 0 differ on the card")
    t0 = time.perf_counter()
    cpu = bc.compare_rabitq(rq, bl.fit_rabitq(rows, "l2", device="cpu"), prefix,
                            "15a RaBitQ card vs CPU")
    here = bl.RaBitQ(rq.rotation.cpu(), rq.center.cpu(), rq.signs[:CPU_ROWS].cpu(),
                     rq.norms[:CPU_ROWS].cpu(), rq.ip_unit[:CPU_ROWS].cpu(), rq.metric)
    est_rel = max(bc.close(est[i, :CPU_ROWS], bl.rabitq_estimate(here, q, np.arange(CPU_ROWS)),
                           f"15a RaBitQ estimate, query {i}")
                  for i, q in enumerate(q_host))
    b_ms, b_by = bound(n * (d // 8 + 4 + 4 + 8), 0)
    log(json.dumps({"baseline_rabitq": {
        "n": n, "dim": d, "bits_per_vector": rq.bits_per_vector, "fit_s": fit_s,
        "estimate_ms_per_query": est_ms, "estimate_bound_ms": b_ms, "estimate_bound_by": b_by,
        "rerank": RABITQ_RERANK, "recall_at_10": recall, "peak_bytes": peak,
        "card_vs_cpu": {**cpu, "estimate_rel": est_rel},
        "cpu_check_s": time.perf_counter() - t0}}))
    counts = launch_counts(kernels)
    check(not any(counts.values()), f"15a: the baselines launched a search kernel: {counts}")


def examples_phase(dev, kernels):
    """Phase 15b: ``launch/quickstart.py`` at its default ``sift`` (40,000 x
    128): packed ids == f32 ids, recall@10 >= 0.80, the f32, packed and
    decode kernels launched.  15c: ``launch/distributed_search.py`` (4 shards
    stacked on the card): one ``fee_distance`` launch a hop and no other FEE
    kernel, recall@10 between the local search's at ``compact=0.5`` and 1.0,
    +- 0.005 (phase 10b's check)."""
    from repro_torch.index import SearchParams
    from repro_torch.launch import distributed_search, quickstart

    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = quickstart.main(["--device", dev.type])
    counts = launch_counts(kernels)
    log(json.dumps({"quickstart": {**out, "launches": counts,
                                   "s": time.perf_counter() - t0}}))
    check(out["packed_ids_equal"], "15b: quickstart's packed ids differ from its f32 ids")
    check(out["recall_at_10"] >= 0.80, f"15b: quickstart recall@10 {out['recall_at_10']:.4f}")
    for k in ("fee_distance", "fee_distance_packed", "dfloat_unpack"):
        check(counts[k] > 0, f"15b: quickstart did not launch {k}")

    t0 = time.perf_counter()
    db, idx = distributed_search.build(dev)
    for fn in kernels.values():
        fn.launches = 0
    out = distributed_search.report(db, idx, 4, dev)
    counts = launch_counts(kernels)
    local = {c: idx.search(db.queries, SearchParams(ef=48, k=10, use_dfloat=False, compact=c),
                           device=dev).recall(db.gt, 10) for c in (0.5, 1.0)}
    log(json.dumps({"distributed_search": {**out, "launches": counts,
                                           "local_recall_at_10": local,
                                           "s": time.perf_counter() - t0}}))
    check(counts["fee_distance"] == out["hops_max"],
          f"15c: {counts['fee_distance']} fee_distance launches for {out['hops_max']} hops")
    others = {k: v for k, v in counts.items() if k != "fee_distance" and v}
    check(not others, f"15c: the sharded f32 search launched {others}")
    check(local[0.5] - 0.005 <= out["recall_at_10"] <= local[1.0] + 0.005,
          f"15c: recall@10 {out['recall_at_10']:.4f} outside [{local[0.5]:.4f}, "
          f"{local[1.0]:.4f}] (the local search at compact 0.5 and 1.0) +- 0.005")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="base vectors")
    ap.add_argument("--queries", type=int, default=10_000, help="evaluation queries")
    ap.add_argument("--churn-append", type=int, default=CHURN["append"],
                    help="phase 8: rows appended a round")
    ap.add_argument("--churn-delete", type=int, default=CHURN["delete"],
                    help="phase 8: rows deleted a round")
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
    logs = _build.build_logs()
    for stem, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {stem}: {line.strip()}")
    frames = {name: b for name, b in stack_frames(logs).items()
              if any(k in name for k in NO_FRAME_KERNELS)}
    missing = [k for k in NO_FRAME_KERNELS if not any(k in name for name in frames)]
    check(not missing, f"no ptxas output for {missing}")
    framed = {name: b for name, b in frames.items() if b}
    check(not framed, f"FEE kernels with a stack frame (local memory): {framed}")
    log(f"staged FEE kernels {', '.join(NO_FRAME_KERNELS)}: {len(frames)} instantiations, "
        "no stack frame")

    n_edge = edge_shape_checks(dev)
    log(f"edge shapes: {n_edge} cases match their plain versions")

    kernels = {name: getattr(fee_kernel, name) for name in REPLACES if name != "dfloat_unpack"}
    kernels["dfloat_unpack"] = unpack_kernel.dfloat_unpack
    index, db, res64, launches, rep = main_path(args, dev, kernels)
    rows = main_path_kernels(index, db, res64, dev, launches)
    frontier_phase(dev)
    descend_phase(dev)
    for storage in ("f32", "packed"):
        profile_search(index, db, dev, rep[storage]["p50_batch_ms"], storage)
    log(json.dumps({"reduced": {"ndpsim_queries": NDPSIM_QUERIES,
                                "from": NDPSIM_QUERIES_FULL,
                                "why": "room for phase 13: with it the script would run "
                                       "~820 s at the earlier depths"}}))
    t0 = time.perf_counter()
    if ndpsim_phase(index, db, dev, kernels) is None:
        check(ndpsim_phase(index, db, dev, kernels, NDPSIM_CUT_QUERIES) is not None,
              "ndpsim: a replay of 64 queries took longer than the limit too")
    log(f"ndpsim phase {time.perf_counter() - t0:.1f} s")
    churn = dict(append=args.churn_append, delete=args.churn_delete)
    if churn != CHURN_FULL:
        log(json.dumps({"reduced": {"churn": churn, "from": CHURN_FULL,
                                    "why": "phase 8 at full traffic took 283-311 s, over "
                                           "its 3-minute budget"}}))
    log(json.dumps({"reduced": {"churn_rounds": CHURN_ROUNDS, "from": CHURN_ROUNDS_FULL,
                                "why": "room for phases 11 and 13: the script ran "
                                       "519-564 s through phase 10, and phase 13 adds "
                                       "~250 s"}}))
    t0 = time.perf_counter()
    churn_phase(index, db, dev, kernels, rep["f32"]["recall_at_10"], **churn)
    log(json.dumps({"churn_phase_s": time.perf_counter() - t0}))
    log(json.dumps({"reduced": {"serve": {"load_s": SERVE_LOAD["seconds"],
                                          "swap_s": SERVE_SWAP["seconds"]},
                                "from": {"load_s": SERVE_LOAD_FULL, "swap_s": SERVE_SWAP_FULL},
                                "why": "with the full durations the script ran past 600 s"}}))
    t0 = time.perf_counter()
    serve_phase(index, db, dev, kernels)
    log(json.dumps({"serve_phase_s": time.perf_counter() - t0}))
    n_sharded = min(SHARDED_QUERIES, len(db.queries))
    if n_sharded < len(db.queries):
        log(json.dumps({"reduced": {"sharded_queries": n_sharded,
                                    "from": len(db.queries)}}))
    t0 = time.perf_counter()
    sharded_phase(index, db, dev, kernels, n_sharded)
    log(json.dumps({"sharded_phase_s": time.perf_counter() - t0}))
    t0 = time.perf_counter()
    lm_phase(index, db, dev, kernels)
    log(json.dumps({"lm_phase_s": time.perf_counter() - t0}))
    t0 = time.perf_counter()
    train_phase(dev)
    log(json.dumps({"train_phase_s": time.perf_counter() - t0}))
    t0 = time.perf_counter()
    mesh_phase(dev)
    log(json.dumps({"mesh_phase_s": time.perf_counter() - t0}))
    t0 = time.perf_counter()
    mesh_serve_phase(dev)
    log(json.dumps({"mesh_serve_phase_s": time.perf_counter() - t0}))
    t0 = time.perf_counter()
    baselines_phase(index.db_rot, index.transform_queries(db.queries), db.gt, dev, kernels)
    examples_phase(dev, kernels)
    log(json.dumps({"baselines_examples_phase_s": time.perf_counter() - t0}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
