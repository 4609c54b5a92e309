"""The CUDA kernels against their plain PyTorch versions on the same inputs.

These need an NVIDIA GPU and ``nvcc`` (the kernels are built at first use);
without a card they skip.  The file imports no JAX, so it runs on the machine
with the card:  ``python -m pytest -m cuda tests/test_torch_cuda.py``.
Tolerance as in ``repro_torch.kernels.check``; the decode and packed-vs-f32
scores are bit-exact, and so are the skip-DMA kernels against the kernels
whose contract they share and the tiered kernel at every split against the
packed kernel over the parent rows.  ``SCALAR_SHAPES`` (seg % 4 != 0) run the
f32 kernels' one-float-at-a-time loads and 4-byte copies, every other shape
their float4 loads and 16-byte copies.  The packed kernels read 16 B bursts
where the rows are 16 B aligned and 4 B words where they are not: both run
over row views at pitch W and W + 4, with the row base on and off 16 B, and
the tiered kernel takes each tier's path per tier, at every split.  The two
skip-DMA kernels share one warp loop over two 32-lane tiles: partial and
empty tiles, dead lanes and tiles that all exit at segment 0 give the bits
of the kernels whose contract they share.  The decode kernel is bit-exact
with its plain version on every route: whole matrices and row views (pitch
W and W + 4, base on and off 16 B), rows gathered by ids that repeat or name
no row, outputs written at a column offset whose runs are not 16 B aligned,
no rows and one row, the tiered pair written into one matrix, and layouts
that take its per-field path.  The sharded search on the card (shards
stacked on it) must equal the local search bit for bit at ``compact=1.0``,
and ``GroupShards`` over a one-rank NCCL group must equal ``LocalShards(1)``.
The LM stack's smoke models must give the CPU's logits on the card (TF32
off), and `launch/rag.py` and `launch/serve.py --decode` repeatable tokens;
their loss and gradients the CPU's, an AdamW step the CPU's weights, and the
trainer on the card must resume from a crash to the uninterrupted run's loss.
The mesh train step over 2 and 4 NCCL ranks (one card each) and over 2 gloo
ranks sharing one card must take the one-process step's losses and weights
(``repro_torch.training.mesh_check``), and the mesh trainer over NCCL must
resume from a crash to the uninterrupted run's loss.  Decode on a mesh in
serve mode over 2 and 4 NCCL ranks and over 2 gloo ranks sharing one card
must give the one-process decode's logits and cache
(``repro_torch.models.mesh_check``) with no collective on a weight.  The PQ
and RaBitQ baselines fitted on the card must repeat bit for bit and meet the
CPU's fit at the CPU tests' bounds; the twins of the quickstart and
distributed-search examples must run on the card through their kernels.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_beam_cases as beam_cases
from fee_cases import inputs
from repro_torch.core import dfloat as dfl
from repro_torch.kernels import dfloat_unpack as unpack_kernel
from repro_torch.kernels import fee_distance as fee_kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels.check import (SCALAR_SHAPES, SHAPES, compare_fee, near_threshold,
                                       random_layout)


# gist's shape, scored on the main path through one run of 12-bit fields
# (the layout Algorithm 1 picks there: 96 bursts, 384 words a row)
GIST = (97, 960, 16)


def gist_layout(x):
    return dfl.make_config(GIST[1], [(12, dfl.EXP_BITS[12], GIST[1])], x)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c,d,seg", SHAPES + SCALAR_SHAPES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_fee_kernels_match_plain(cuda, c, d, seg, metric):
    q, x, thr, alpha, beta, margin = inputs(c, d, seg, metric, c + d)
    rng = np.random.default_rng(c)
    n_q = 3
    ids = torch.from_numpy(rng.integers(0, c, (n_q, c)).astype(np.int32)).to(cuda)
    qs = torch.from_numpy(np.stack([q, -q, q * 0.5])).to(cuda)
    thrs = torch.full((n_q,), float(thr), device=cuda)
    xt, at, bt, mt = (torch.from_numpy(a).to(cuda) for a in (x, alpha, beta, margin))
    mask = torch.from_numpy(rng.random((n_q, c)) < 0.8).to(cuda)
    got = fee_kernel.fee_distance(xt, ids, qs, thrs, at, bt, mt, seg=seg,
                                  metric=metric, lane_mask=mask)
    want = ref.fee_distance_gather_ref(xt, ids, qs, thrs, at, bt, mt, seg=seg,
                                       metric=metric, lane_mask=mask)
    near = near_threshold(xt[ids.long()], qs, thrs, at, bt, mt, seg=seg, metric=metric)
    compare_fee(got, want, near)
    cfg = dfl.make_config(d, [(16, 5, d // 2), (12, 4, d - d // 2)], x)
    packed = torch.from_numpy(dfl.pack_db(x, cfg).view(np.int32)).to(cuda)
    pk = fee_kernel.fee_distance_packed(packed, ids, qs, thrs, at, bt, mt,
                                        dfloat_cfg=cfg, seg=seg, metric=metric,
                                        lane_mask=mask)
    xq = unpack_kernel.dfloat_unpack(packed, cfg)
    assert torch.equal(xq.cpu(), dfl.unpack_rows(packed.cpu(), cfg))
    f32 = fee_kernel.fee_distance(xq, ids, qs, thrs, at, bt, mt, seg=seg,
                                  metric=metric, lane_mask=mask)
    for a, b in zip(pk, f32):          # packed == f32 over the decoded rows
        assert torch.equal(a, b)


def _lanes(cuda, c, d, seg, metric):
    """Three queries over C lanes of random ids into (C, D) rows, 80% alive."""
    q, x, thr, alpha, beta, margin = inputs(c, d, seg, metric, c + d + 1)
    rng = np.random.default_rng(c + 1)
    ids = torch.from_numpy(rng.integers(0, c, (3, c)).astype(np.int32)).to(cuda)
    qs = torch.from_numpy(np.stack([q, -q, q * 0.5])).to(cuda)
    thrs = torch.full((3,), float(thr), device=cuda)
    fee = [torch.from_numpy(a).to(cuda) for a in (alpha, beta, margin)]
    mask = torch.from_numpy(rng.random((3, c)) < 0.8).to(cuda)
    return rng, x, (ids, qs, thrs, *fee), mask


@pytest.mark.cuda
@pytest.mark.parametrize("c,d,seg", SHAPES + SCALAR_SHAPES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_skipdma_kernels_match_plain(cuda, c, d, seg, metric):
    rng, x, args, mask = _lanes(cuda, c, d, seg, metric)
    kw = dict(seg=seg, metric=metric, lane_mask=mask)
    xt = torch.from_numpy(x).to(cuda)
    near = near_threshold(xt[args[0].long()], *args[1:], seg=seg, metric=metric)
    got = fee_kernel.fee_distance_skipdma(xt, *args, **kw)
    compare_fee(got, ref.fee_distance_gather_ref(xt, *args, **kw), near)
    for a, b in zip(got, fee_kernel.fee_distance(xt, *args, **kw)):
        assert torch.equal(a, b)
    cfg, _ = random_layout(rng, d, x)
    packed = torch.from_numpy(dfl.pack_db(x, cfg).view(np.int32)).to(cuda)
    xq = unpack_kernel.dfloat_unpack(packed, cfg)
    near_q = near_threshold(xq[args[0].long()], *args[1:], seg=seg, metric=metric)
    pk = fee_kernel.fee_distance_packed_skipdma(packed, *args, dfloat_cfg=cfg, **kw)
    compare_fee(pk, ref.fee_distance_packed_gather_ref(packed, *args, dfloat_cfg=cfg, **kw),
                near_q)
    for a, b in zip(pk, fee_kernel.fee_distance_packed(packed, *args, dfloat_cfg=cfg, **kw)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("c,d,seg", SHAPES + SCALAR_SHAPES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_tiered_kernel_every_split(cuda, c, d, seg, metric):
    rng, x, args, mask = _lanes(cuda, c, d, seg, metric)
    kw = dict(seg=seg, metric=metric, lane_mask=mask)
    cfg, _ = random_layout(rng, d, x)
    packed = torch.from_numpy(dfl.pack_db(x, cfg).view(np.int32)).to(cuda)
    xq = unpack_kernel.dfloat_unpack(packed, cfg)
    near = near_threshold(xq[args[0].long()], *args[1:], seg=seg, metric=metric)
    want_bits = fee_kernel.fee_distance_packed(packed, *args, dfloat_cfg=cfg, **kw)
    for split in range(d // seg + 1):
        ccfg, rcfg = dfl.split_config(cfg, split * seg)
        tiers = [torch.from_numpy(t.view(np.int32)).to(cuda)
                 for t in dfl.pack_tiers(x, cfg, split * seg)]
        tkw = dict(coarse_cfg=ccfg, resid_cfg=rcfg, **kw)
        got = fee_kernel.fee_distance_tiered(*tiers, *args, **tkw)
        compare_fee(got, ref.fee_distance_tiered_gather_ref(*tiers, *args, **tkw), near,
                    f"fee_distance_tiered split={split}")
        for a, b in zip(got, want_bits):
            assert torch.equal(a, b), split
        # each tier alone, then both, as a row view at pitch W + 4 whose base
        # lies 4 B off 16 B alignment: that tier's 4 B loads
        xc, xr = tiers
        for views in ((_row_view(xc, 4, 1), xr), (xc, _row_view(xr, 4, 1)),
                      (_row_view(xc, 4, 1), _row_view(xr, 4, 1))):
            got = fee_kernel.fee_distance_tiered(*views, *args, **tkw)
            for a, b in zip(got, want_bits):
                assert torch.equal(a, b), (split, [v.stride(0) for v in views])


@pytest.mark.cuda
def test_cuda_wrappers_reject_badinputs(cuda):
    x = torch.zeros((8, 32), device=cuda)
    ones = torch.ones(2, device=cuda)
    q = torch.zeros((1, 32), device=cuda)
    thr = torch.zeros(1, device=cuda)
    with pytest.raises(TypeError):
        fee_kernel.fee_distance(x, torch.zeros((1, 4), dtype=torch.int64, device=cuda),
                                q, thr, ones, ones, ones, seg=16)
    with pytest.raises(ValueError):
        fee_kernel.fee_distance(x, torch.zeros((1, 4), dtype=torch.int32, device=cuda),
                                q[:, :16], thr, ones, ones, ones, seg=16)
    # the tiered kernel splits on a segment boundary only
    x_np = np.random.default_rng(0).standard_normal((8, 32)).astype(np.float32)
    cfg = dfl.make_config(32, [(16, 5, 32)], x_np)
    ccfg, rcfg = dfl.split_config(cfg, 8)
    tiers = [torch.from_numpy(t.view(np.int32)).to(cuda) for t in dfl.pack_tiers(x_np, cfg, 8)]
    with pytest.raises(ValueError, match="segment boundary"):
        fee_kernel.fee_distance_tiered(*tiers, torch.zeros((1, 4), dtype=torch.int32,
                                                           device=cuda),
                                       q, thr, ones, ones, ones, coarse_cfg=ccfg,
                                       resid_cfg=rcfg, seg=16)


def _row_view(packed, pad, offset):
    """``packed`` (N, W) as a row view at pitch W + ``pad`` words whose base
    lies ``offset`` words into its buffer (offset 1: off 16 B alignment)."""
    n, w = packed.shape
    buf = torch.zeros(offset + n * (w + pad), dtype=packed.dtype, device=packed.device)
    rows = buf.as_strided((n, w), (w + pad, 1), offset)
    rows.copy_(packed)
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("c,d,seg", SHAPES + SCALAR_SHAPES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_packed_kernels_every_pitch_and_load_path(cuda, c, d, seg, metric):
    """Both packed kernels equal the f32 kernel over the decoded rows bit for
    bit at pitch W and W + 4, through the 16 B and the 4 B paths, with the
    queries on and off 16 B alignment; so does the tiered kernel with the
    whole row as its coarse tier."""
    rng, x, args, mask = _lanes(cuda, c, d, seg, metric)
    kw = dict(seg=seg, metric=metric, lane_mask=mask)
    cfg = gist_layout(x) if (c, d, seg) == GIST else random_layout(rng, d, x)[0]
    packed = torch.from_numpy(dfl.pack_db(x, cfg).view(np.int32)).to(cuda)
    xq = unpack_kernel.dfloat_unpack(packed, cfg)
    want = fee_kernel.fee_distance(xq, *args, **kw)
    full, none = dfl.split_config(cfg, d)
    for pad in (0, 4):
        for offset in (0, 1):
            rows = _row_view(packed, pad, offset)
            assert torch.equal(unpack_kernel.dfloat_unpack(rows, cfg), xq), (pad, offset)
            runs = {"packed": fee_kernel.fee_distance_packed(rows, *args, dfloat_cfg=cfg, **kw),
                    "packed_skipdma": fee_kernel.fee_distance_packed_skipdma(
                        rows, *args, dfloat_cfg=cfg, **kw),
                    "tiered": fee_kernel.fee_distance_tiered(
                        rows, rows[:, :0], *args, coarse_cfg=full, resid_cfg=none, **kw)}
            q_off = torch.zeros(args[1].numel() + 1, device=cuda)[1:].view_as(args[1])
            q_off.copy_(args[1])
            off = (args[0], q_off, *args[2:])
            runs["packed q+4B"] = fee_kernel.fee_distance_packed(rows, *off, dfloat_cfg=cfg, **kw)
            runs["packed_skipdma q+4B"] = fee_kernel.fee_distance_packed_skipdma(
                rows, *off, dfloat_cfg=cfg, **kw)
            for name, got in runs.items():
                for a, b in zip(got, want):
                    assert torch.equal(a, b), (name, pad, offset)


@pytest.mark.cuda
@pytest.mark.parametrize("n_q,lanes", [(1, 1), (1, 32), (1, 33), (1, 63), (3, 11), (3, 32),
                                       (5, 13), (1, 200), (2, 64), (3, 70)])
def test_cuda_packed_skipdma_partial_tiles(cuda, n_q, lanes):
    """A warp of either skip-DMA kernel owns two 32-lane tiles: lane counts
    that leave tile B partly or wholly empty, dead lanes (20% masked out),
    and a query whose lanes all exit at segment 0 (so do its first tiles)
    give the bits of the kernel whose contract they share: the packed
    kernel's, which are the f32 kernel's over the decoded rows, and the f32
    kernel's, on the 16 B and the 4 B path."""
    c, d, seg = 100, 128, 16
    q, x, thr, alpha, beta, margin = inputs(c, d, seg, "l2", n_q * lanes)
    rng = np.random.default_rng(lanes)
    ids = torch.from_numpy(rng.integers(0, c, (n_q, lanes)).astype(np.int32)).to(cuda)
    qs = torch.from_numpy(np.stack([q * (1 + 0.1 * i) for i in range(n_q)])).to(cuda)
    thrs = torch.full((n_q,), float(thr), device=cuda)
    thrs[0] = -1.0                      # query 0: every lane exits at segment 0
    args = (ids, qs, thrs, *(torch.from_numpy(a).to(cuda) for a in (alpha, beta, margin)))
    mask = torch.from_numpy(rng.random((n_q, lanes)) < 0.8).to(cuda)
    kw = dict(seg=seg, metric="l2", lane_mask=mask)
    xt = torch.from_numpy(x).to(cuda)
    f32 = fee_kernel.fee_distance(xt, *args, **kw)
    assert bool((f32[2][0][mask[0]] == 1).all())
    x_off = torch.zeros(xt.numel() + 1, device=cuda)[1:].view_as(xt)   # 4 B off 16 B
    x_off.copy_(xt)
    for rows in (xt, x_off):
        for a, b in zip(fee_kernel.fee_distance_skipdma(rows, *args, **kw), f32):
            assert torch.equal(a, b), rows.data_ptr() % 16
    cfg, _ = random_layout(rng, d, x)
    packed = torch.from_numpy(dfl.pack_db(x, cfg).view(np.int32)).to(cuda)
    xq = unpack_kernel.dfloat_unpack(packed, cfg)
    got = fee_kernel.fee_distance_packed_skipdma(packed, *args, dfloat_cfg=cfg, **kw)
    near = near_threshold(xq[ids.long()], *args[1:], seg=seg, metric="l2")
    compare_fee(got, ref.fee_distance_packed_gather_ref(packed, *args, dfloat_cfg=cfg, **kw),
                near)
    for want in (fee_kernel.fee_distance_packed(packed, *args, dfloat_cfg=cfg, **kw),
                 fee_kernel.fee_distance(xq, *args, **kw)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _unpack_routes(cuda, packed, cfg, seed):
    """The decode kernel against its plain version over ``packed`` (CUDA)
    on every route: pitch W and W + 4 with the base on and off 16 B, whole
    and gathered by ids (repeats, and two that name no row), into a new
    matrix and at columns 0-3 of a wider one."""
    host = packed.cpu()
    n = packed.shape[0]
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, max(n, 1), 2 * n + 3)
    ids[[0, -1]] = (-1, n)
    ids_t = torch.from_numpy(ids)
    want_all = ref.dfloat_unpack_ref(host, cfg)
    want_ids = ref.dfloat_unpack_ref(host, cfg, ids_t)
    d = cfg.dim
    for pad, offset in ((0, 0), (4, 0), (0, 1), (4, 1)):
        rows = _row_view(packed, pad, offset)
        assert torch.equal(unpack_kernel.dfloat_unpack(rows, cfg).cpu(), want_all), (pad, offset)
        got = unpack_kernel.dfloat_unpack(rows, cfg, ids=ids_t.to(cuda))
        assert torch.equal(got.cpu(), want_ids), (pad, offset)
        for col in range(4):
            out = torch.full((len(ids), d + 3), -7.0, device=cuda)
            unpack_kernel.dfloat_unpack(rows, cfg, ids=ids_t.to(cuda), out=out, col=col)
            out = out.cpu()
            assert torch.equal(out[:, col:col + d], want_ids), (pad, offset, col)
            assert bool((out[:, :col] == -7).all() and (out[:, col + d:] == -7).all())


@pytest.mark.cuda
@pytest.mark.parametrize("c,d,seg", SHAPES + SCALAR_SHAPES + [(100, 128, 16)])
def test_cuda_unpack_every_route(cuda, c, d, seg):
    """Random layouts at the kernel tests' shapes (D = 960 included), the
    main path's one 16-bit run (W = 64 words, so pitch W + 4 is 68), and
    gist's one 12-bit run (W = 384)."""
    rng = np.random.default_rng(c + d + seg)
    x = rng.standard_normal((c, d)).astype(np.float32)
    if (c, d, seg) == (100, 128, 16):
        cfg = dfl.make_config(d, [(16, 5, d)], x)
        assert dfl.packed_words(cfg) == 64
    elif (c, d, seg) == GIST:
        cfg = gist_layout(x)
        assert dfl.packed_words(cfg) == 384
    else:
        cfg, _ = random_layout(rng, d, x)
    assert unpack_kernel.by_burst(cfg)
    packed = torch.from_numpy(dfl.pack_db(x, cfg).view(np.int32)).to(cuda)
    _unpack_routes(cuda, packed, cfg, c)
    # no rows and one row, whole and gathered
    for rows in (packed[:0], packed[:1]):
        host = rows.cpu()
        assert torch.equal(unpack_kernel.dfloat_unpack(rows, cfg).cpu(),
                           ref.dfloat_unpack_ref(host, cfg))
        for ids in (torch.zeros(0, dtype=torch.int64), torch.tensor([0]), torch.tensor([3])):
            got = unpack_kernel.dfloat_unpack(rows, cfg, ids=ids.to(cuda))
            assert torch.equal(got.cpu(), ref.dfloat_unpack_ref(host, cfg, ids))


@pytest.mark.cuda
@pytest.mark.parametrize("runs", [None, [(21, 6, 333), (14, 5, 400), (12, 4, 227)]])
def test_cuda_pack_and_emulate_in_row_chunks(cuda, monkeypatch, runs):
    """``pack_db`` and ``emulate_db`` of a tensor on the card, in row chunks
    of 8 rows (the last one short), at gist's width: gist's one 12-bit run,
    and three runs whose fields straddle words and whose last bursts are
    partial.  The card's words are the CPU's, which the CPU tests hold to the
    JAX package's words; the host layer decodes them to the host emulation,
    and the card's emulation is that too, bit for bit."""
    c, d, _ = GIST
    x = (np.random.default_rng(11).standard_normal((c, d)) * 2).astype(np.float32)
    cfg = gist_layout(x) if runs is None else dfl.make_config(d, runs, x)
    want = dfl.pack_db(x, cfg)                           # one chunk, on the CPU
    host_em = dfl.emulate_db(x, cfg).view(np.uint32)
    monkeypatch.setattr(dfl, "CHUNK_BYTES", 4 * d * 8)
    xt = torch.from_numpy(x).to(cuda)
    words = dfl.pack_db(xt, cfg)
    assert np.array_equal(words, want)
    assert np.array_equal(dfl.unpack_db(words, cfg).view(np.uint32), host_em)
    assert np.array_equal(dfl.emulate_db(xt, cfg).cpu().numpy().view(np.uint32), host_em)


@pytest.mark.cuda
@pytest.mark.parametrize("burst_bits,runs", [(64, [(16, 5, 40), (12, 4, 24)]),
                                             (256, [(21, 6, 50), (14, 5, 14)]),
                                             (128, [(20, 6, 30), (16, 5, 34)])])
def test_cuda_unpack_field_path(cuda, burst_bits, runs):
    """Bursts of other than 128 bits, or a width outside the palette, take
    the per-field path of the same kernel source: exact on every route."""
    x = np.random.default_rng(burst_bits).standard_normal((77, 64)).astype(np.float32)
    cfg = dfl.make_config(64, runs, x, burst_bits=burst_bits)
    assert not unpack_kernel.by_burst(cfg)
    packed = torch.from_numpy(dfl.pack_db(x, cfg).view(np.int32)).to(cuda)
    _unpack_routes(cuda, packed, cfg, burst_bits)


@pytest.mark.cuda
@pytest.mark.parametrize("c,d,seg", SHAPES)
def test_cuda_unpack_tiered_pair_every_split(cuda, c, d, seg):
    """The tiered decode writes each tier at its columns of one matrix (two
    launches): bit-exact with the parent layout's decode at every split,
    whole and gathered by id."""
    rng = np.random.default_rng(c + 2 * d)
    x = rng.standard_normal((c, d)).astype(np.float32)
    cfg, _ = random_layout(rng, d, x)
    packed = torch.from_numpy(dfl.pack_db(x, cfg).view(np.int32))
    ids = torch.from_numpy(rng.integers(-1, c + 1, 3 * c))
    whole = ref.dfloat_unpack_ref(packed, cfg)
    gathered = ref.dfloat_unpack_ref(packed, cfg, ids)
    for split in range(d // seg + 1):
        ccfg, rcfg = dfl.split_config(cfg, split * seg)
        tiers = [torch.from_numpy(t.view(np.int32)).to(cuda)
                 for t in dfl.pack_tiers(x, cfg, split * seg)]
        before = unpack_kernel.dfloat_unpack.launches
        got = ops.dfloat_unpack_tiered_rows(*tiers, ccfg, rcfg)
        assert unpack_kernel.dfloat_unpack.launches - before == (ccfg.dim > 0) + (rcfg.dim > 0)
        assert torch.equal(got.cpu(), whole), split
        got = ops.dfloat_unpack_tiered_rows(*tiers, ccfg, rcfg, ids=ids.to(cuda))
        assert torch.equal(got.cpu(), gathered), split


@pytest.mark.cuda
@pytest.mark.parametrize("tier_split", [None, 2])
def test_cuda_churn_wal_replay_bit_identical(cuda, tmp_path, tier_split):
    """A unit index churned on the card (candidate search on the device
    mirrors): no tombstone in any storage's results, and its WAL replays on
    the card to the same arrays and the same ids and distances."""
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.index import Index, IndexSpec, SearchParams
    from repro_torch.streaming import MutableIndex

    db = make_dataset("unit", device=cuda, cache=False)
    idx = Index.build(db, IndexSpec.for_db(db, m=8, dfloat_recall_target=0.8,
                                           tier_split=tier_split), device=cuda)
    mi = MutableIndex(idx, ef_build=32, sub_batch=64)
    assert mi.device.type == "cuda" and mi._rot_d.is_cuda
    rng = np.random.default_rng(4)
    for _ in range(2):
        src = rng.integers(0, db.n, 256)
        mi.append(db.vectors[src] + 0.05 * rng.standard_normal(
            (256, db.dim)).astype(np.float32))
        mi.delete(rng.choice(mi.alive_ids(), 128, replace=False))
        mi.freeze()
    dead = np.nonzero(mi._dead)[0]
    results = {}
    for storage in ("f32", "packed", "tiered"):
        res = mi.search(db.queries, SearchParams(ef=48, k=10, storage=storage))
        assert not np.isin(res.ids, dead).any(), storage
        results[storage] = res
    assert np.array_equal(results["f32"].ids, results["packed"].ids)
    assert np.array_equal(results["tiered"].dists, results["packed"].dists)
    path = mi.save_delta(tmp_path / "wal.naszip")
    m2 = MutableIndex.load(path, device=cuda)
    for f in ("_rot", "_packed", "_adj", "_dead", "_coarse", "_resid"):
        a, b = getattr(mi, f), getattr(m2, f)
        assert (a is None and b is None) or np.array_equal(a, b), f
    params = SearchParams(ef=48, k=10, storage="f32")
    a, b = mi.search(db.queries, params), m2.search(db.queries, params)
    assert np.array_equal(a.ids, b.ids) and np.array_equal(a.dists, b.dists)


@pytest.fixture(scope="module")
def cuda_unit():
    """The unit data and a Dfloat index built on the card (every storage)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.index import Index, IndexSpec

    dev = torch.device("cuda")
    db = make_dataset("unit", device=dev, cache=False)
    return db, Index.build(db, IndexSpec.for_db(db, m=8, dfloat_recall_target=0.8),
                           device=dev)


@pytest.mark.cuda
def test_cuda_serve_mixed_traffic_replays_bit_identical(cuda_unit):
    """Mixed k / ef / storage traffic through the batcher on the card: every
    response equals its query replayed alone at the batch bucket that served
    it, ids and distances bit for bit."""
    from repro_torch.serve import ServeConfig, Server
    from repro_torch.serve.batcher import run_bucketed

    db, idx = cuda_unit
    storages = ("f32", "packed", "tiered")
    cfg = ServeConfig(ef_buckets=(16, 32), batch_buckets=(1, 4, 8), k_max=10,
                      storages=storages, use_dfloat=True, slo_ms=60_000.0)
    cases = [(db.queries[i % len(db.queries)], [16, 32, 48][i % 3],
              [3, 7, 10][i % 3], storages[(i // 3) % 3]) for i in range(72)]
    srv = Server(idx, cfg).start()
    try:
        futs = [srv.submit(q, k=k, ef=ef, storage=st) for q, ef, k, st in cases]
        resps = [f.result(timeout=120) for f in futs]
    finally:
        srv.stop()
    for (q, ef, k, st), r in zip(cases, resps):
        assert r.status == "ok"
        ids, dists, *_ = run_bucketed(idx, cfg, q[None], cfg.ef_bucket(ef),
                                      cfg.expand, st, bucket=r.batch_bucket)
        assert np.array_equal(r.ids, ids[0, :k])
        assert np.array_equal(r.dists, dists[0, :k])


@pytest.mark.cuda
@pytest.mark.parametrize("donate", [True, False])
@pytest.mark.parametrize("storage", ["f32", "packed", "tiered"])
def test_cuda_delta_splice_equals_cold_install(cuda_unit, storage, donate):
    """Two delta installs spliced into the card's tensors equal a cold
    install of the last snapshot (``torch.equal``)."""
    import copy

    from repro_torch.index import DeviceCache
    from repro_torch.streaming import MutableIndex

    db, idx = cuda_unit
    mi = MutableIndex(idx, ef_build=32, sub_batch=64)
    cache = DeviceCache(storage=storage, use_dfloat=True, donate=donate)
    cache.install(mi.freeze())
    rng = np.random.default_rng(3)
    for _ in range(2):
        mi.append(db.vectors[rng.integers(0, db.n, 48)] + 0.05 * rng.standard_normal(
            (48, db.dim)).astype(np.float32))
        mi.delete(rng.choice(mi.alive_ids(), 16, replace=False))
        snap = mi.freeze()
        assert cache.install(snap).mode == "delta"
    bare = copy.copy(snap)
    bare._device, bare._searchers = {}, {}
    cold = DeviceCache(storage=storage, use_dfloat=True, donate=False)
    cold.install(bare)
    for name in ("_db", "_db_res", "_adj", "_tomb"):
        a, b = getattr(cache, name), getattr(cold, name)
        assert (a is None and b is None) or (a.is_cuda and torch.equal(a, b)), name


@pytest.mark.cuda
def test_cuda_swap_rollback_serves_previous_generation(cuda_unit):
    """A failing install on the card rolls back: the previous generation
    serves again with its own results, and a retry lands."""
    from repro_torch.resilience import FaultPlan, FaultSpec, active_plan
    from repro_torch.serve import ServeConfig
    from repro_torch.serve.batcher import run_bucketed
    from repro_torch.serve.swap import GenerationInstaller
    from repro_torch.streaming import MutableIndex

    db, idx = cuda_unit
    cfg = ServeConfig(ef_buckets=(32,), batch_buckets=(8,), k_max=10,
                      storages=("f32", "packed"), use_dfloat=True)
    mi = MutableIndex(idx, ef_build=32, sub_batch=64)
    inst = GenerationInstaller(cfg)
    s0 = mi.freeze()
    inst.install(s0)
    q = db.queries[:8]
    want = {st: run_bucketed(s0, cfg, q, 32, cfg.expand, st)[:2] for st in cfg.storages}
    mi.append(db.vectors[:64] + 0.01)
    mi.delete(np.arange(32))
    s1 = mi.freeze()
    with active_plan(FaultPlan({"serve.swap.install": FaultSpec("raise", at=(0,))})):
        assert inst.install(s1) is None
    assert inst.serving is s0 and inst.rollbacks == 1
    for st in cfg.storages:
        ids, dists = run_bucketed(s0, cfg, q, 32, cfg.expand, st)[:2]
        assert np.array_equal(ids, want[st][0]) and np.array_equal(dists, want[st][1])
    assert inst.install(s1) is not None and inst.serving is s1
    ids = run_bucketed(s1, cfg, q, 32, cfg.expand, "f32")[0]
    assert not np.isin(ids, np.arange(32)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["f32", "packed", "tiered"])
def test_cuda_sharded_matches_local_bit_for_bit(cuda_unit, storage):
    """The sharded search on the card (1, 4 and 8 shards stacked) gives the
    local search's ids, distances and hops at ``compact=1.0``, with one
    launch of its storage's FEE kernel a hop."""
    from repro_torch.index import SearchParams

    db, idx = cuda_unit
    fee = {"f32": fee_kernel.fee_distance, "packed": fee_kernel.fee_distance_packed,
           "tiered": fee_kernel.fee_distance_tiered}[storage]
    params = SearchParams(ef=48, k=10, compact=1.0, storage=storage)
    want = idx.searcher("local", params)(db.queries)
    for c in (1, 4, 8):
        run = idx.searcher("sharded", params, n_shards=c)
        before = fee.launches
        got = run(db.queries)
        assert fee.launches - before == int(got.hops.max()), c
        assert np.array_equal(got.ids, want.ids), c
        assert np.array_equal(got.dists, want.dists), c
        assert np.array_equal(got.hops, want.hops), c


@pytest.mark.cuda
def test_cuda_sharded_mutable_tombstones(cuda_unit):
    """A churned ``ShardedMutableIndex`` on the card: its sharded search
    equals the local search of its snapshot, with no tombstoned id."""
    from repro_torch.index import SearchParams
    from repro_torch.streaming import ShardedMutableIndex

    db, idx = cuda_unit
    sm = ShardedMutableIndex(idx, 4, ef_build=32, sub_batch=64)
    rng = np.random.default_rng(5)
    sm.append(db.vectors[rng.integers(0, db.n, 64)] + 0.05 * rng.standard_normal(
        (64, db.dim)).astype(np.float32))
    dead = rng.choice(db.n, 150, replace=False)
    sm.delete(dead)
    for storage in ("f32", "packed"):
        params = SearchParams(ef=48, k=10, compact=1.0, storage=storage)
        want = sm.freeze().searcher("local", params)(db.queries)
        got = sm.search(db.queries, params)
        assert np.array_equal(got.ids, want.ids) and np.array_equal(got.dists, want.dists)
        assert not np.isin(got.ids, dead).any()


@pytest.fixture(scope="module")
def cuda_units():
    """{metric: (data, a Dfloat index built on the card)} for both unit
    data sets, l2 and ip."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.index import Index, IndexSpec

    dev = torch.device("cuda")
    out = {}
    for metric, name in (("l2", "unit"), ("ip", "unit_ip")):
        db = make_dataset(name, device=dev, cache=False)
        out[metric] = db, Index.build(
            db, IndexSpec.for_db(db, m=8, dfloat_recall_target=0.8), device=dev)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("tomb", [False, True])
@pytest.mark.parametrize("storage", beam_cases.STORAGES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_graph_loop_equals_eager_loop(cuda_units, metric, storage, tomb):
    """The beam loop replayed as a CUDA graph (``HopGraph.loop``) against
    the eager loop on the same inputs, at Q = 0, 1, 4, 32 and 1000: ids,
    distances and every counter bit for bit, each kernel's launch count the
    same (one FEE and one frontier launch a hop), and the ``search.beam``
    span's ``graph_hops`` equal to its ``hops`` (0 on the eager loop), its
    ``frontier_hops`` equal to its ``hops`` on both loops and its
    ``visited_bytes`` the chunk's bitmap."""
    from repro_torch import obs
    from repro_torch.core import search
    from repro_torch.index import SearchParams
    from repro_torch.kernels import frontier as frontier_kernel

    db, idx = cuda_units[metric]
    fee = {"f32": fee_kernel.fee_distance, "packed": fee_kernel.fee_distance_packed,
           "tiered": fee_kernel.fee_distance_tiered}[storage]
    params = SearchParams(ef=48, k=10, storage=storage)
    words = beam_cases.dead_words(db.n, 7) if tomb else None
    rng = np.random.default_rng(11)
    graph = search.HopGraph(torch.device("cuda"))
    obs.enable_tracing()
    try:
        for n_q in (0, 1, 4, 32, 1000):
            q = db.queries[np.arange(n_q) % len(db.queries)]
            q = q + 0.01 * rng.standard_normal(q.shape).astype(np.float32)
            args, kw = beam_cases.beam_inputs(idx, q, params, torch.device("cuda"),
                                              tombstone=words)
            runs, spans = {}, {}
            # eager first: it builds the kernels' device tables, which a
            # searcher builds before its capture
            for name, loop in (("eager", search._eager_loop), ("graph", graph.loop)):
                obs.tracer.clear()
                before = ops.launch_counts()
                out = search._search_batch(*args, **kw, loop=loop)
                torch.cuda.synchronize()
                runs[name] = out, [a - b for a, b in zip(ops.launch_counts(), before)]
                spans[name], = [s.attrs for s in obs.tracer.spans()
                                if s.name == "search.beam"]
            (want, eager_n), (got, graph_n) = runs["eager"], runs["graph"]
            beam_cases.assert_same(got, want, f"Q={n_q}")
            assert graph_n == eager_n, n_q
            hops = int(want["hops"].max()) if n_q else 0
            assert eager_n[ops.COUNTED.index(fee)] == hops, n_q
            assert eager_n[ops.COUNTED.index(frontier_kernel.frontier)] == hops, n_q
            bitmap = 4 * -(-db.n // 32) * n_q
            assert spans["graph"] == dict(q=n_q, hops=hops, graph_hops=hops,
                                          frontier_hops=hops, visited_bytes=bitmap), n_q
            assert spans["eager"] == dict(q=n_q, hops=hops, graph_hops=0,
                                          frontier_hops=hops, visited_bytes=bitmap), n_q
            if tomb and n_q:
                dead = np.flatnonzero(np.unpackbits(
                    words.view(np.uint8), bitorder="little")[:db.n])
                assert not np.isin(got["ids"].cpu().numpy(), dead).any()
    finally:
        obs.disable_tracing()
        obs.tracer.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("storage", beam_cases.STORAGES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_query_chunks_equal_one_chunk(cuda_units, metric, storage, monkeypatch):
    """On the card, under the CUDA-graph loop: a visited-bitmap budget of
    333 queries splits a call of 1,000 into four chunks (333, 333, 333, 1),
    each captured and replayed on its own state; ids, distances and every
    counter equal one chunk's bit for bit, the ``search.call`` span holds
    four ``search.beam`` spans, each with its chunk's bitmap in
    ``visited_bytes`` and a replay for every hop."""
    from repro_torch import obs
    from repro_torch.core import search
    from repro_torch.index import SearchParams, backends

    cuda = torch.device("cuda")
    db, idx = cuda_units[metric]
    params = SearchParams(ef=48, k=10, storage=storage)
    rng = np.random.default_rng(3)
    q = db.queries[np.arange(1000) % len(db.queries)]
    q = q + 0.01 * rng.standard_normal(q.shape).astype(np.float32)
    n_words = -(-idx.n // 32)
    want = backends.local_searcher(idx, params, device=cuda)(q)
    monkeypatch.setattr(search, "_VISITED_BYTES", 4 * n_words * 333)
    obs.enable_tracing()
    obs.tracer.clear()
    try:
        got = backends.local_searcher(idx, params, device=cuda)(q)
        spans = obs.tracer.spans()
    finally:
        obs.disable_tracing()
        obs.tracer.clear()
    for f in ("ids", "dists", "hops", "n_eval", "dims", "n_resid"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None) and (a is None or (
            a.dtype == b.dtype and np.array_equal(a, b))), f
    call, = [s for s in spans if s.name == "search.call"]
    beams = [s.attrs for s in spans if s.name == "search.beam"
             and call.t0_ns <= s.t0_ns <= call.t0_ns + call.dur_ns]
    assert [b["q"] for b in beams] == [333, 333, 333, 1]
    assert [b["visited_bytes"] for b in beams] == [4 * n_words * b["q"] for b in beams]
    assert all(b["graph_hops"] == b["hops"] > 0 for b in beams)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_f32_rows_past_2_gib(cuda, metric):
    """6,000,000 x 96 f32 rows (2.3 GB): lanes on the last 100,000 rows,
    whose bytes lie past 2^31, score in the f32 FEE kernel as in its plain
    version and bit for bit in the skip-DMA kernel; the ``descend`` kernel
    walks upper levels over those rows to the plain version's entries (at
    least 99%, each a greedy fixed point) and reads each of their rows as
    the row rule does."""
    from repro_torch.core import graph as graph_mod
    from repro_torch.core import search
    from repro_torch.kernels import descend as descend_kernel

    n, d, seg, tail = 6_000_000, 96, 16, 100_000
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn((n, d), generator=g, device=cuda)
    if metric == "ip":
        x /= x.norm(dim=1, keepdim=True)
    assert (n - tail) * d * 4 > 2**31
    ids = torch.randint(n - tail, n, (3, 512), generator=g, device=cuda).to(torch.int32)
    qs = x[ids[:, 0].long()] + 0.3 * torch.randn((3, d), generator=g, device=cuda)
    rows = x[ids.long()]
    score = ((rows - qs[:, None]) ** 2).sum(-1) if metric == "l2" else -(rows * qs[:, None]).sum(-1)
    thrs = score.median(1).values
    _, _, _, alpha, beta, margin = inputs(8, d, seg, metric, 9)
    fee = [torch.from_numpy(a).to(cuda) for a in (alpha, beta, margin)]
    mask = torch.rand((3, 512), generator=g, device=cuda) < 0.8
    kw = dict(seg=seg, metric=metric, lane_mask=mask)
    got = fee_kernel.fee_distance(x, ids, qs, thrs, *fee, **kw)
    want = ref.fee_distance_gather_ref(x, ids, qs, thrs, *fee, **kw)
    compare_fee(got, want, near_threshold(rows, qs, thrs, *fee, seg=seg, metric=metric))
    for a, b in zip(fee_kernel.fee_distance_skipdma(x, ids, qs, thrs, *fee, **kw), got):
        assert torch.equal(a, b)

    ups = graph_mod.upper_levels(x[n - tail:], 16, metric, np.random.default_rng(9), n_long=4)
    ups = [((i + (n - tail)).astype(np.int32), a) for i, a in ups]
    base = (np.arange(n, dtype=np.int32), np.zeros((n, 1), np.int32))
    levels = search.DeviceLevels.of(
        graph_mod.GraphIndex(levels=[base] + ups, entry=int(ups[-1][0][0]), m=16), cuda)
    lv = levels.ids.long()
    assert int(lv.min()) >= n - tail
    assert torch.equal(descend_kernel.decode_rows(x, "f32", None, lv),
                       search.row_reader(x, "f32")(lv))
    q = x[torch.randint(n - tail, n, (500,), generator=g, device=cuda)]
    q = q + 0.1 * torch.randn(q.shape, generator=g, device=cuda)
    (entries, moves), (want_e, want_m), _ = _descend_both(levels, x, "f32", None, q, metric)
    # its f32 sums are not torch's: a near tie may walk another way
    agree = float((entries == want_e).float().mean())
    assert agree >= 0.99, agree
    if agree == 1.0:
        assert torch.equal(moves, want_m)
    _assert_level_one_fixed_point(levels, search.row_reader(x, "f32"), q, entries, metric)
    assert int(entries.min()) >= n - tail


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_partitioned_knn_repeats_and_finds_the_exact_lists(cuda, metric):
    """The partitioned kNN build on the card over 300,000 x 96 clustered
    rows (147 lists): two builds, and a build of the rows with three axes'
    signs flipped, give the same lists bit for bit; they hold at least 95%
    of the exact lists on a 2,000-row sample, nearest first, without self
    loops or repeats."""
    from repro_torch.core import graph as graph_mod

    g = torch.Generator(device=cuda).manual_seed(13)
    n, d = 300_000, 96
    scale = torch.arange(1, d + 1, device=cuda, dtype=torch.float32).pow(-0.5)
    centers = torch.randn((256, d), generator=g, device=cuda) * scale
    x = centers[torch.randint(0, 256, (n,), generator=g, device=cuda)]
    x = x + 0.5 * torch.randn((n, d), generator=g, device=cuda) * scale
    if metric == "ip":
        x /= x.norm(dim=1, keepdim=True)
    ids = graph_mod._partitioned_knn(x, 32, metric, seed=0)
    assert torch.equal(graph_mod._partitioned_knn(x, 32, metric, seed=0), ids)
    flip = x.clone()
    flip[:, [1, 40, 95]] *= -1
    assert torch.equal(graph_mod._partitioned_knn(flip, 32, metric, seed=0), ids)
    assert graph_mod.knn_recall(x, ids, metric, seed=1, n_rows=2_000) >= 0.95
    assert int(ids.min()) >= 0 and int(ids.max()) < n
    assert not (ids == torch.arange(n, device=cuda)[:, None]).any()
    srt = ids.sort(1).values
    assert not (srt[:, 1:] == srt[:, :-1]).any()


FRONTIER_SHAPES = [(1, 20), (4, 20), (8, 16), (16, 20)]   # E*M 20, 80, 128, 320


@pytest.mark.cuda
@pytest.mark.parametrize("n_q", [1, 37, 10_000])
@pytest.mark.parametrize("e,m", FRONTIER_SHAPES)
def test_cuda_frontier_kernel_matches_plain(cuda, e, m, n_q):
    """The ``frontier`` kernel against its plain version on the card, bit
    for bit: the compacted ids, clamped ids, fresh lanes, pop slots and the
    visited words after the call, at E*M = 20 (E = 1: slot order), 80, 128
    (``first_occurrence_mask``'s pairwise arm) and 320 (its sort arm), at
    compact 0.5 and 1.0, over ids repeated within and across pops, -1 pads,
    unselected pops and visited bits set beforehand; with Q <= 37 also over
    ids of a 2^20-row pool (visited words far into the row)."""
    from repro_torch.core.search import compact_width
    from repro_torch.kernels import frontier as frontier_kernel

    pools = [None] if n_q > 37 else [None, 1 << 20]
    for n in pools:
        nodes, sel, adj, visited = (torch.from_numpy(a).to(cuda) for a in
                                    beam_cases.frontier_inputs(n_q, e, m, n_q + e * m, n))
        for compact in (0.5, 1.0):
            width = compact_width(m, e, compact)
            vis_k, vis_p = visited.clone(), visited.clone()
            before = frontier_kernel.frontier.launches
            got = frontier_kernel.frontier(nodes, sel, adj, vis_k, width)
            want = ref.frontier_ref(nodes, sel, adj, vis_p, width)
            torch.cuda.synchronize()
            assert frontier_kernel.frontier.launches == before + 1
            for name, a, b in zip(("nbrs", "safe", "fresh", "src"), got, want):
                assert a.dtype == b.dtype and torch.equal(a, b), (name, n, compact)
            assert torch.equal(vis_k, vis_p), (n, compact)
            assert n_q == 1 or int(got[2].sum()) > 0


@pytest.mark.cuda
def test_cuda_frontier_rejects_bad_inputs(cuda):
    """The kernel's wrapper raises on what the kernel does not take, and
    never falls back to the plain version on the card."""
    from repro_torch.kernels import frontier as frontier_kernel

    nodes, sel, adj, visited = (torch.from_numpy(a).to(cuda)
                                for a in beam_cases.frontier_inputs(4, 4, 20, 0))
    fn = frontier_kernel.frontier
    with pytest.raises(TypeError, match="nodes"):
        fn(nodes.long(), sel, adj, visited, 40)
    with pytest.raises(TypeError, match="adj"):
        fn(nodes, sel, torch.cat([adj, adj], 1)[:, :20], visited, 40)
    with pytest.raises(ValueError, match="slots"):
        fn(nodes, sel, torch.zeros((adj.shape[0], 300), dtype=torch.int32, device=cuda),
           visited, 600)
    for width in (0, 81):
        with pytest.raises(ValueError, match="width"):
            fn(nodes, sel, adj, visited, width)
    with pytest.raises(ValueError, match="width"):
        fn(nodes[:, :1].contiguous(), sel[:, :1].contiguous(), adj, visited, 10)
    with pytest.raises(ValueError, match="queries"):
        fn(nodes, sel, adj, visited[:2], 40)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("expand", [1, 4, 16])
def test_cuda_frontier_search_equals_cpu_on_exact_data(cuda, expand, trace):
    """A search on the card, its hop captured (untraced) or eager (traced),
    with the frontier and FEE kernels, against the same search on the CPU
    (every step's plain version): ids, distances, counters and the trace bit
    for bit.  Rows and queries are small integers and the FEE parameters
    the identity, so every distance and partial sum is exact in float32
    whatever the order of the sums; E*M = 20, 80 and 320 over a random
    graph with -1 pads.  The card's ``search.beam`` span reports every hop
    in ``frontier_hops``, the CPU's none."""
    from repro_torch import obs
    from repro_torch.core import search
    from repro_torch.core.fee import FeeParams
    from repro_torch.kernels import frontier as frontier_kernel

    rng = np.random.default_rng(expand)
    n, d, m, n_q = 4096, 32, 20, 300
    x = rng.integers(-8, 9, (n, d)).astype(np.float32)
    q = rng.integers(-8, 9, (n_q, d)).astype(np.float32)
    adj = rng.integers(0, n, (n, m)).astype(np.int32)
    adj[rng.random((n, m)) < 0.05] = -1
    entries = rng.integers(0, n, n_q).astype(np.int32)
    cfg = search.SearchConfig(ef=32, k=10, seg=8, use_fee=True, expand=expand)
    out, beams = {}, {}
    obs.enable_tracing()
    try:
        for dev in ("cpu", "cuda"):
            obs.tracer.clear()
            before = frontier_kernel.frontier.launches
            run = search.make_searcher(torch.from_numpy(x).to(dev),
                                       torch.from_numpy(adj).to(dev), cfg, trace=trace,
                                       fee=FeeParams.identity(d // 8, device=dev))
            res = run(torch.from_numpy(q).to(dev), torch.from_numpy(entries).to(dev))
            out[dev] = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict)
                            else v.cpu()) for k, v in res.items()}
            beams[dev], = [s.attrs for s in obs.tracer.spans() if s.name == "search.beam"]
            launched = frontier_kernel.frontier.launches - before
            assert launched == (beams[dev]["hops"] if dev == "cuda" else 0), dev
    finally:
        obs.disable_tracing()
        obs.tracer.clear()
    got, want = out["cuda"], out["cpu"]
    if trace:
        beam_cases.assert_same(got.pop("trace"), want.pop("trace"), "trace")
    beam_cases.assert_same(got, want)
    hops = beams["cuda"]["hops"]
    assert hops > 0 and beams["cuda"]["frontier_hops"] == hops
    assert beams["cuda"]["graph_hops"] == (0 if trace else hops)
    assert beams["cpu"]["frontier_hops"] == 0


# ---------------------------------------------------------------------------
# the descent through the upper levels: one ``descend`` kernel a call
# ---------------------------------------------------------------------------


def _upper_graph(x, metric, seed):
    """A graph of the upper levels ``build_graph`` makes at m = 16 over the
    rows ``x`` (a CUDA tensor); level 0 is a placeholder (the descent never
    reads it), so no base-level kNN is computed."""
    from repro_torch.core import graph as graph_mod

    ups = graph_mod.upper_levels(x, 16, metric, np.random.default_rng(seed), n_long=4)
    base = (np.arange(x.shape[0], dtype=np.int32), np.zeros((x.shape[0], 1), np.int32))
    return graph_mod.GraphIndex(levels=[base] + ups, entry=int(ups[-1][0][0]), m=16)


def _dist64(q, x, metric):
    """Float64 distances of rows ``x`` (Q, C, D) to queries ``q`` (Q, D)."""
    q, x = q.double()[:, None, :], x.double()
    return ((x - q) ** 2).sum(-1) if metric == "l2" else -(x * q).sum(-1)


def _assert_level_one_fixed_point(levels, rows, q, entries, metric):
    """Every entry is a level-1 node none of whose neighbours is nearer in
    float64 by more than 1e-6 of its own distance: the greedy walk's end."""
    ids1, adj1 = levels.levels[0]
    pos = torch.searchsorted(ids1, entries)
    assert torch.equal(ids1[pos.clamp(max=len(ids1) - 1)], entries)
    d_e = _dist64(q, rows(entries)[:, None, :], metric)[:, 0]
    d_nb = _dist64(q, rows(ids1[adj1[pos].long()]), metric)
    assert bool((d_nb.min(1).values >= d_e - 1e-6 * d_e.abs()).all())


def _descend_both(levels, vectors, storage, cfg, q, metric):
    """The kernel's and the plain version's (entries, moves) on the card,
    and the ``search.descend`` span of a traced ``descend_entry`` call.  The
    wrapper launches once and reports every level walked, or, at Q = 0,
    launches nothing and reports none."""
    from repro_torch import obs
    from repro_torch.core import search
    from repro_torch.kernels import descend as descend_kernel

    before = descend_kernel.descend.launches
    *got, walked = descend_kernel.descend(levels, vectors, storage, cfg, q, metric)
    launched = q.shape[0] > 0
    assert descend_kernel.descend.launches == before + launched
    assert walked == (len(levels.spans) if launched else 0)
    want = ref.descend_ref(levels, vectors, storage, cfg, q, metric)
    obs.enable_tracing()
    obs.tracer.clear()
    try:
        entries = search.descend_entry(levels, vectors, storage, cfg, q, metric)
        span, = [s.attrs for s in obs.tracer.spans() if s.name == "search.descend"]
    finally:
        obs.disable_tracing()
        obs.tracer.clear()
    assert torch.equal(entries, got[0])
    return got, want, span


@pytest.mark.cuda
@pytest.mark.parametrize("storage", beam_cases.STORAGES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_descend_kernel_matches_plain_on_unit_indexes(cuda_units, metric, storage):
    """On the tests' small indexes (unit l2 and unit_ip, Dfloat, built on
    the card) the ``descend`` kernel gives the plain version's entries for
    every query and its moves on every level, at Q = 0, 1, 4 and 1,000; the
    ``search.descend`` span's steps equal the plain loop's and
    ``kernel_levels`` every level (none at Q = 0); each entry is a greedy fixed point at
    level 1; and the kernel's read of every upper-level row is bit-equal to
    the storage's row rule."""
    from repro_torch.core import search
    from repro_torch.index import SearchParams
    from repro_torch.index.backends import _dfloat_cfg
    from repro_torch.kernels import descend as descend_kernel

    cuda = torch.device("cuda")
    db, idx = cuda_units[metric]
    params = SearchParams(ef=48, k=10, storage=storage)
    vectors = idx.device_db(params.use_dfloat, storage, cuda)
    cfg = _dfloat_cfg(idx, params)
    levels = idx.device_levels(cuda)
    n_levels = len(levels.spans)
    assert n_levels >= 1
    rows = search.row_reader(vectors, storage, cfg)
    ids = levels.ids.long()
    assert torch.equal(descend_kernel.decode_rows(vectors, storage, cfg, ids), rows(ids))
    rng = np.random.default_rng(5)
    for n_q in (0, 1, 4, 1000):
        q = db.queries[np.arange(n_q) % len(db.queries)]
        q = q + 0.05 * rng.standard_normal(q.shape).astype(np.float32)
        qt = torch.from_numpy(idx.transform_queries(q.reshape(-1, idx.dim))).to(cuda)
        (entries, moves), (want_e, want_m), span = _descend_both(
            levels, vectors, storage, cfg, qt, idx.metric)
        assert entries.dtype == moves.dtype == torch.int32 and entries.shape == (n_q,)
        assert torch.equal(entries, want_e), n_q
        assert torch.equal(moves, want_m), n_q
        assert span == dict(levels=n_levels, steps=n_levels + int(want_m.sum()),
                            kernel_levels=n_levels if n_q else 0), n_q
        if n_q:
            _assert_level_one_fixed_point(levels, rows, qt, entries, idx.metric)
    assert n_q > 1 and len(torch.unique(entries)) > 1


def _layouts(x):
    """Packed layouts of the rows ``x`` (numpy) that the descent reads: sift's
    one 16-bit run, gist's one 12-bit run (at D = 960), three runs, and
    bursts of 64 bits (the per-field units)."""
    d = x.shape[1]
    out = {"one run": dfl.make_config(d, [(16 if d < 960 else 12,
                                           dfl.EXP_BITS[16 if d < 960 else 12], d)], x)}
    if d == 64:
        out["three runs"] = dfl.make_config(d, [(21, 6, 20), (14, 5, 30), (12, 4, 14)], x)
        out["64-bit bursts"] = dfl.make_config(d, [(16, 5, 40), (12, 4, 24)], x,
                                               burst_bits=64)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 960])
def test_cuda_descend_rows_equal_the_row_rule(cuda, d):
    """The kernel's read and decode of a row (``descend.decode_rows``, its
    units through the kernel's own load and decode) against
    ``search.row_reader``, bit for bit: f32 rows (16 B and 4 B units, and
    D = 30, whose last unit is short), packed rows at sift's 16-bit and
    gist's 12-bit layout, three runs and 64-bit bursts (field units), at
    pitch W and W + 4 with the base on and off 16 B, and tier pairs at every
    split."""
    from repro_torch.core import search
    from repro_torch.kernels import descend as descend_kernel

    rng = np.random.default_rng(d)
    n = 300
    x = rng.standard_normal((n, d)).astype(np.float32)
    ids = torch.from_numpy(rng.integers(0, n, 2 * n)).to(cuda)
    same = lambda v, s, c: torch.equal(descend_kernel.decode_rows(v, s, c, ids),
                                       search.row_reader(v, s, c)(ids))
    xf = torch.from_numpy(x).to(cuda)
    assert same(xf, "f32", None)
    assert same(_row_view(xf, 0, 1), "f32", None)          # off 16 B: 4 B units
    assert same(xf[:, :30].contiguous(), "f32", None)     # a short last unit
    for name, cfg in _layouts(x).items():
        packed = torch.from_numpy(dfl.pack_db(x, cfg).view(np.int32)).to(cuda)
        for pad, offset in ((0, 0), (4, 0), (0, 1), (4, 1)):
            assert same(_row_view(packed, pad, offset), "packed", cfg), (name, pad, offset)
        seg = 16
        for split in range(0, d // seg + 1, max(1, d // seg // 4)):
            tcfg = dfl.split_config(cfg, split * seg)
            tiers = tuple(torch.from_numpy(t.view(np.int32)).to(cuda)
                          for t in dfl.pack_tiers(x, cfg, split * seg))
            assert same(tiers, "tiered", tcfg), (name, split)


@pytest.fixture(scope="module")
def sift_shape():
    """Clustered rows at SIFT1M's shape (1,000,000 x 128, L2) made on the
    card, 10,000 queries near them, the upper levels ``build_graph`` makes
    at m = 16 (62,500 / 3,906 / 244 / 24 nodes, 20 neighbours a node) and
    the rows packed at sift's 16-bit layout."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.core import search

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    n, d, n_q = 1_000_000, 128, 10_000
    centers = 3.0 * torch.randn((64, d), generator=g, device=dev)
    x = centers[torch.randint(0, 64, (n,), generator=g, device=dev)] + torch.randn(
        (n, d), generator=g, device=dev)
    q = x[torch.randint(0, n, (n_q,), generator=g, device=dev)] + 0.5 * torch.randn(
        (n_q, d), generator=g, device=dev)
    graph = _upper_graph(x, "l2", 31)
    cfg = dfl.make_config(d, [(16, dfl.EXP_BITS[16], d)], x)
    packed = torch.from_numpy(dfl.pack_db(x, cfg).view(np.int32)).to(dev)
    return dict(levels=search.DeviceLevels.of(graph, dev), q=q,
                storage={"f32": (x, None), "packed": (packed, cfg)})


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["f32", "packed"])
def test_cuda_descend_kernel_at_sift_shape(sift_shape, storage):
    """At sift's shape (10,000 queries, four upper levels of 20 neighbours)
    the kernel's entries equal the plain version's for at least 99.9% of the
    queries (its f32 sums are not torch's: a near tie may walk another
    way), every kernel entry is a greedy fixed point at level 1 in float64,
    and where all entries agree so do the moves of every level."""
    from repro_torch.core import search

    levels, q = sift_shape["levels"], sift_shape["q"]
    assert [s[1] for s in levels.spans] == [62_500, 3_906, 244, 24]
    vectors, cfg = sift_shape["storage"][storage]
    (entries, moves), (want_e, want_m), span = _descend_both(levels, vectors, storage,
                                                            cfg, q, "l2")
    agree = float((entries == want_e).float().mean())
    assert agree >= 0.999, agree
    _assert_level_one_fixed_point(levels, search.row_reader(vectors, storage, cfg), q,
                                  entries, "l2")
    if agree == 1.0:
        assert torch.equal(moves, want_m)
    assert span["kernel_levels"] == 4 and span["steps"] == 4 + int(moves.sum())
    assert int(moves.min()) >= 1 and len(torch.unique(entries)) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_descend_single_upper_level(cuda, metric):
    """An index of one upper level (400 rows: 25 nodes above the base):
    the kernel equals the plain version at Q = 0, 1 and 300."""
    from repro_torch.core import search

    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((400, 48), generator=g, device=cuda)
    graph = _upper_graph(x, metric, 7)
    levels = search.DeviceLevels.of(graph, cuda)
    assert len(levels.spans) == 1 and levels.spans[0][1] == 25
    for n_q in (0, 1, 300):
        q = torch.randn((n_q, 48), generator=g, device=cuda)
        (entries, moves), (want_e, want_m), span = _descend_both(levels, x, "f32", None,
                                                                q, metric)
        assert torch.equal(entries, want_e) and torch.equal(moves, want_m), n_q
        assert span == dict(levels=1, steps=1 + int(want_m.sum()),
                            kernel_levels=1 if n_q else 0)
    assert int(moves[0]) >= 1


def _probe_positions(n):
    """The positions a level of ``n`` sorted ids ends a warp search's first
    round at, with a probe step of ceil(n / 32) and of n // 32 + 1: an entry
    there leaves a range of a multiple of 32 whose answer is its upper end
    when the step is ceil(n / 32) and n is in 2,049-2,080, 3,073-3,104,
    ...  Also the first two and the last position."""
    at = {(k + 1) * step - 1 for step in (-(-n // 32), n // 32 + 1) for k in range(32)}
    return sorted(p for p in at | {0, 1, n - 1} if p < n)


@pytest.mark.cuda
@pytest.mark.parametrize("n1", [33, 64, 96, 2050, 2080, 3073, 3104])
def test_cuda_descend_finds_entries_at_every_probe_position(cuda, n1):
    """The kernel's binary search of a level's sorted ids, at level sizes
    whose first round leaves a range of a multiple of 32 whose answer is its
    upper end: a level 1 of ``n1`` ids under a complete top level of the ids
    at every first-round probe position (and two ids the level lacks, one
    past its last, which restart the walk at position 0 as the plain
    version does).  Each query sits on one top node's row, so it walks
    there and enters level 1 at that node's position.  Entries and moves
    equal the plain version's query for query, and a query on a node that
    level 1 holds stays there."""
    from repro_torch.core import graph as graph_mod
    from repro_torch.core import search

    rng = np.random.default_rng(n1)
    n, d, m1 = 4 * n1, 32, 8
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda)
    ids1 = np.sort(rng.choice(np.arange(1, n - 1, 2), n1, replace=False)).astype(np.int32)
    adj1 = rng.integers(0, n1, (n1, m1)).astype(np.int32)
    held = ids1[_probe_positions(n1)]
    lacked = np.array([ids1[n1 // 2] + 1, n - 1], np.int32)     # an even id, one past the last
    ids2 = np.sort(np.concatenate([held, lacked]))
    n2 = len(ids2)
    adj2 = np.array([[j for j in range(n2) if j != i] for i in range(n2)], np.int32)
    base = (np.arange(n, dtype=np.int32), np.zeros((n, 1), np.int32))
    graph = graph_mod.GraphIndex(levels=[base, (ids1, adj1), (ids2, adj2)],
                                 entry=int(ids2[0]), m=m1)
    levels = search.DeviceLevels.of(graph, cuda)
    on = torch.from_numpy(np.repeat(ids2, 3)).to(cuda).long()
    q = x[on] + 1e-3 * torch.randn((len(on), d), device=cuda,
                                   generator=torch.Generator(device=cuda).manual_seed(n1))
    (entries, moves), (want_e, want_m), span = _descend_both(levels, x, "f32", None, q, "l2")
    assert torch.equal(entries, want_e) and torch.equal(moves, want_m)
    assert span == dict(levels=2, steps=2 + int(want_m.sum()), kernel_levels=2)
    kept = torch.from_numpy(np.isin(np.repeat(ids2, 3), ids1)).to(cuda)
    assert torch.equal(entries.long()[kept], on[kept])
    assert int(kept.sum()) == 3 * len(held) and not bool(kept.all())


@pytest.mark.cuda
def test_cuda_descend_rejects_bad_inputs(cuda):
    """The kernel's wrapper raises on what the kernel does not take (a
    wrong dtype, device or shape of the queries, rows or levels, a level
    wider than ``MAX_M``, an unknown metric), and never falls back to the
    plain version on the card."""
    from repro_torch.core import search
    from repro_torch.kernels import descend as descend_kernel

    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((400, 32), generator=g, device=cuda)
    levels = search.DeviceLevels.of(_upper_graph(x, "l2", 3), cuda)
    q = torch.randn((5, 32), generator=g, device=cuda)
    fn = lambda **kw: descend_kernel.descend(**{**dict(
        levels=levels, vectors=x, storage="f32", dfloat_cfg=None, queries=q,
        metric="l2"), **kw})
    before = descend_kernel.descend.launches
    with pytest.raises(TypeError, match="queries"):
        fn(queries=q.double())
    with pytest.raises(TypeError, match="queries"):
        fn(queries=q.t().contiguous().t())
    with pytest.raises(TypeError, match="f32 rows"):
        fn(queries=q[:, :16].contiguous())
    with pytest.raises(TypeError, match="f32 rows"):
        fn(vectors=x.double())
    with pytest.raises(ValueError, match="rows on cpu"):
        fn(vectors=x.cpu())
    with pytest.raises(TypeError, match="level ids"):
        fn(levels=dataclasses.replace(levels, ids=levels.ids.long()))
    with pytest.raises(TypeError, match="level table"):
        fn(levels=dataclasses.replace(levels, table=levels.table.int()))
    with pytest.raises(ValueError, match="levels on cpu"):
        fn(levels=dataclasses.replace(levels, adj=levels.adj.cpu()))
    wide = dataclasses.replace(levels, spans=((0, 25, 0, 300),))
    with pytest.raises(ValueError, match="neighbours a node"):
        fn(levels=wide)
    with pytest.raises(ValueError, match="metric"):
        fn(metric="cosine")
    cfg = dfl.make_config(32, [(16, 5, 32)], x)
    packed = torch.from_numpy(dfl.pack_db(x, cfg).view(np.int32)).to(cuda)
    with pytest.raises(ValueError, match="words per row"):
        fn(vectors=packed[:, :-4], storage="packed", dfloat_cfg=cfg)
    assert descend_kernel.descend.launches == before


@pytest.mark.cuda
def test_cuda_searchers_capture_where_they_should(cuda_units):
    """A local searcher on the card replays its hop (``graph_hops`` equal to
    ``hops`` in every ``search.beam`` span); a traced one (the ndpsim path)
    and one on the plain ``"jnp"`` backend run eagerly (``graph_hops`` 0).
    The replayed and the traced one run the frontier kernel
    (``frontier_hops`` equal to ``hops``), the plain one does not."""
    import dataclasses

    from repro_torch import obs
    from repro_torch.index import SearchParams

    db, idx = cuda_units["l2"]
    base = SearchParams(ef=48, k=10, storage="packed")
    cases = {"auto": base, "trace": dataclasses.replace(base, trace=True),
             "jnp": dataclasses.replace(base, fee_backend="jnp")}
    obs.enable_tracing()
    try:
        beams = {}
        for name, params in cases.items():
            obs.tracer.clear()
            idx.searcher("local", params)(db.queries)
            beams[name] = [s.attrs for s in obs.tracer.spans() if s.name == "search.beam"]
    finally:
        obs.disable_tracing()
        obs.tracer.clear()
    assert beams["auto"] and all(b["graph_hops"] == b["hops"] > 0 for b in beams["auto"])
    assert beams["trace"] and beams["jnp"]
    assert all(b["graph_hops"] == 0 for b in beams["trace"] + beams["jnp"])
    # the frontier kernel runs traced or not, and not on the plain backend
    assert all(b["frontier_hops"] == b["hops"] for b in beams["auto"] + beams["trace"])
    assert all(b["frontier_hops"] == 0 for b in beams["jnp"])


@pytest.mark.cuda
def test_cuda_capture_survives_eager_collections(cuda_units, monkeypatch):
    """A searcher dropped in a reference cycle keeps its captured graph until
    the collector frees it.  Here it becomes garbage inside another
    searcher's capture, with the collector at its most eager: it must not be
    freed there (a graph destroyed in the capturing thread fails the
    capture), and the search gives the results of one run before."""
    import gc

    from repro_torch.core import search
    from repro_torch.index import SearchParams, backends

    db, idx = cuda_units["l2"]
    params = SearchParams(ef=48, k=10, storage="packed")
    dev = torch.device("cuda")
    old = backends.local_searcher(idx, params, device=dev)
    held = [old]
    want = old(db.queries)                   # it now holds a captured graph
    del old
    body = search._hop_body

    def dropping(*a, **k):
        if held and torch.cuda.is_current_stream_capturing():
            cycle = [held.pop()]
            cycle.append(cycle)              # the old searcher's last holder
            del cycle
            [[] for _ in range(100)]         # allocations that start collections
        return body(*a, **k)

    monkeypatch.setattr(search, "_hop_body", dropping)
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        res = backends.local_searcher(idx, params, device=dev)(db.queries)
    finally:
        gc.set_threshold(*threshold)
        gc.collect()
    assert not held
    assert np.array_equal(res.ids, want.ids)
    assert np.array_equal(res.dists, want.dists)


@pytest.mark.cuda
def test_cuda_searcher_shared_by_threads(cuda_units):
    """Eight threads (more than the machine's cores) call one capturing
    searcher at once, with a short switch interval: they take turns on its
    graph's stream and pool, and every result equals the serial one."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.index import SearchParams

    db, idx = cuda_units["l2"]
    run = idx.searcher("local", SearchParams(ef=48, k=10, storage="packed"))
    sizes = [1, 4, 32, 64, 7, 16, 2, 48]
    want = {n: run(db.queries[:n]) for n in sizes}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(len(sizes)) as pool:
            futs = [(n, pool.submit(run, db.queries[:n])) for n in sizes * 3]
            got = [(n, f.result(timeout=120)) for n, f in futs]
    finally:
        sys.setswitchinterval(old)
    for n, res in got:
        assert np.array_equal(res.ids, want[n].ids), n
        assert np.array_equal(res.dists, want[n].dists), n
        assert np.array_equal(res.hops, want[n].hops), n


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [False, True])
def test_cuda_group_shards_one_nccl_rank_equals_local_shards(cuda_unit, tmp_path, overlap):
    """``GroupShards`` over a one-rank NCCL group on the card equals
    ``LocalShards(1)`` bit for bit (NCCL takes one rank a card, so more
    ranks need more cards; the gloo test on the CPU runs four)."""
    import torch.distributed as dist

    from repro_torch.index import SearchParams

    db, idx = cuda_unit
    params = SearchParams(ef=48, k=10, storage="packed")
    want = idx.searcher("sharded", params, n_shards=1, overlap=overlap)(db.queries)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    try:
        got = idx.searcher("sharded", params, group=dist.group.WORLD,
                           overlap=overlap)(db.queries)
    finally:
        dist.destroy_process_group()
    assert np.array_equal(got.ids, want.ids) and np.array_equal(got.dists, want.dists)


@pytest.mark.cuda
def test_cuda_group_shards_four_nccl_ranks(cuda_unit, tmp_path):
    """``GroupShards`` over four NCCL ranks, one card each
    (``tests/torch_sharded_ranks.py``), equals ``LocalShards(4)`` on one
    card bit for bit, every rank holding the whole result, over a
    tombstoned index in sync and overlap mode.  Needs four cards."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.index import Index, SearchParams

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: NCCL takes one card a rank")
    db, idx = cuda_unit
    rng = np.random.default_rng(8)
    dead = rng.choice(db.n, db.n // 20, replace=False)
    words = np.zeros(-(-db.n // 32), np.uint32)
    np.bitwise_or.at(words, dead >> 5, np.uint32(1) << (dead & 31).astype(np.uint32))
    path = idx.save(tmp_path / "plain.naszip")
    np.save(path / "queries.npy", db.queries)
    dead_idx = Index.load(path, device="cuda")
    dead_idx.tombstone = words
    dead_path = dead_idx.save(tmp_path / "dead.naszip")
    cases = {"f32-sync": [0, dict(ef=48, k=10), False],
             "packed-overlap-tomb": [1, dict(ef=48, k=10, storage="packed"), True],
             "tiered-sync-compact1-tomb": [1, dict(ef=48, k=10, storage="tiered",
                                                   compact=1.0), False]}
    out = tmp_path / "out"
    out.mkdir()
    here = Path(__file__).parent
    r = subprocess.run([sys.executable, str(here / "torch_sharded_ranks.py"),
                        f"{path},{dead_path}", str(out), "4", json.dumps(cases), "nccl"],
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": str(here.parent / "src")})
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-2500:])
    for name, (which, fields, overlap) in cases.items():
        want = (idx, dead_idx)[which].searcher(
            "sharded", SearchParams(**fields), n_shards=4, overlap=overlap)(db.queries)
        for rank in range(4):
            with np.load(out / f"rank{rank}.npz") as z:
                assert np.array_equal(z[name + "/ids"], want.ids), (name, rank)
                assert np.array_equal(z[name + "/dists"], want.dists), (name, rank)


@pytest.fixture
def no_tf32(cuda):
    """Float32 products in full float32 for the LM checks (restored after)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield cuda
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["arctic-480b", "qwen2-moe-a2.7b", "llama3.2-1b", "qwen2-72b",
                                  "qwen3-8b", "yi-9b", "mamba2-780m", "llava-next-34b",
                                  "whisper-base", "jamba-1.5-large-398b"])
def test_cuda_models_match_cpu(no_tf32, arch):
    """One set of smoke weights on the CPU and on the card: forward, prefill
    and 6 decode steps within 1e-4 of the largest |logit|."""
    from repro_torch import configs as C
    from repro_torch.models.check import card_against_cpu

    errs = card_against_cpu(C.get_smoke(arch), no_tf32)
    assert max(errs.values()) < 1e-4, errs


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-base"])
def test_cuda_serve_decode_smoke(no_tf32, arch, capsys):
    from repro_torch.launch import serve

    argv = ["--decode", "--smoke", "--arch", arch, "--batch", "2", "--prompt-len", "16",
            "--gen", "8"]
    assert serve.main(argv) == 0
    first = capsys.readouterr().out.splitlines()
    assert first[0].endswith("ms for 2x16") and "for 7 steps" in first[1]
    assert serve.main(argv) == 0
    assert capsys.readouterr().out.splitlines()[2] == first[2]


@pytest.mark.cuda
def test_cuda_rag_unit_packed_repeatable(no_tf32):
    """``launch/rag.py``'s steps on the card over the unit index with packed
    storage: the packed FEE kernel and the decode kernel launched, ids and
    greedy tokens equal to a second run's and to the CPU's."""
    from repro_torch import configs as C
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.index import Index, IndexSpec, SearchParams
    from repro_torch.launch import rag
    from repro_torch.models import get_model

    db = make_dataset("unit", device=no_tf32)
    idx = Index.build(db, IndexSpec.for_db(db, m=8, dfloat_recall_target=0.9), device=no_tf32)
    run = idx.searcher("local", SearchParams(ef=64, k=rag.TOP_K, storage="packed"))
    fee_kernel.fee_distance_packed.launches = unpack_kernel.dfloat_unpack.launches = 0
    ids, _ = rag.retrieve(run, db.queries[:4])
    assert fee_kernel.fee_distance_packed.launches > 0 and unpack_kernel.dfloat_unpack.launches > 0
    assert np.array_equal(ids, rag.retrieve(run, db.queries[:4])[0])
    cfg = C.get_smoke("llama3.2-1b")
    api, cpu_api = get_model(cfg, no_tf32), get_model(cfg, "cpu")
    params = cpu_api.init(torch.Generator().manual_seed(0))
    prompt = rag.rag_prompt(ids, cfg.vocab)
    want, _, _ = rag.generate(cpu_api, params, prompt)
    got, _, _ = rag.generate(api, params.to(no_tf32), prompt)
    assert np.array_equal(got, rag.generate(api, params, prompt)[0])
    assert np.array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "jamba-1.5-large-398b"])
def test_cuda_train_grads_match_cpu(no_tf32, arch):
    """One set of smoke weights on the CPU and on the card: the loss and
    every gradient leaf within 1e-4 of the largest |value| (phase 12a)."""
    from repro_torch import configs as C
    from repro_torch.training.check import card_against_cpu

    errs = card_against_cpu(C.get_smoke(arch), no_tf32, optimizers=())
    assert errs["loss"] < 1e-4 and errs["grads"] < 1e-4, errs


@pytest.mark.cuda
def test_cuda_adamw_step_matches_cpu(no_tf32):
    """One AdamW step from the same gradients on the card and on the CPU: at
    most 1e-4 of the weights outside rtol 2e-4 / atol 2e-5."""
    from repro_torch import configs as C
    from repro_torch.training.check import card_against_cpu

    errs = card_against_cpu(C.get_smoke("llama3.2-1b"), no_tf32, optimizers=("adamw",))
    assert errs["adamw"]["share"] <= 1e-4, errs


@pytest.mark.cuda
def test_cuda_trainer_crash_and_resume(no_tf32, tmp_path):
    """``launch.train --device cuda``: a crash at step 7 exits 17, the resume
    restores step 5 and ends within 1e-4 of the uninterrupted run."""
    from pathlib import Path

    from repro_torch.training.check import FAILURE_EXIT, crash_and_resume

    res = crash_and_resume("cuda", tmp_path, Path(__file__).parent.parent / "src")
    assert res["rc_full"] == 0 and res["rc_resume"] == 0, res
    assert res["rc_crash"] == FAILURE_EXIT and res["restored"], res
    assert abs(res["resumed_loss"] - res["final_loss"]) < 1e-4, res


def _mesh_steps(tmp_path, shape, cases, backend):
    """``tests/torch_mesh_ranks.py steps`` on the cards: rank 0's results."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).parent
    out = tmp_path / "res.json"
    r = subprocess.run([sys.executable, str(here / "torch_mesh_ranks.py"), "steps", str(out),
                        json.dumps({shape: cases}), "cuda", backend],
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": str(here.parent / "src")})
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-2500:])
    return json.loads(out.read_text())[shape]


def _held(res):
    """``tests/test_torch_mesh_train.py``'s bounds."""
    for r in res:
        assert r["loss"] <= 1e-5 and r["grad_norm"] <= 1e-3, r
        assert r["share"] <= 1e-4 and r["over_lr"] <= 0.25, r


MESH_CASES = [dict(arch="llama3.2-1b"), dict(arch="llama3.2-1b", optimizer="adafactor"),
              dict(arch="qwen2-moe-a2.7b")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["1x2", "2x1"])
def test_cuda_mesh_two_nccl_ranks(no_tf32, tmp_path, shape):
    """The mesh train step over 2 NCCL ranks, one card each, takes the
    one-process step's losses and weights for 3 steps.  Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: NCCL takes one card a rank")
    _held(_mesh_steps(tmp_path, shape, MESH_CASES, "nccl"))


@pytest.mark.cuda
def test_cuda_mesh_four_nccl_ranks(no_tf32, tmp_path):
    """The mesh train step over 4 NCCL ranks at (2, 2).  Needs four cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: NCCL takes one card a rank")
    _held(_mesh_steps(tmp_path, "2x2", MESH_CASES, "nccl"))


@pytest.mark.cuda
def test_cuda_mesh_gloo_ranks_share_a_card(no_tf32, tmp_path):
    """2 gloo ranks on one card (buffers through the host) at (1, 2)."""
    _held(_mesh_steps(tmp_path, "1x2", MESH_CASES[:1], "gloo"))


@pytest.mark.cuda
def test_cuda_mesh_trainer_nccl_crash_and_resume(no_tf32, tmp_path):
    """``launch.train --devices 2`` over NCCL: a crash at step 7 exits 17
    and the resume ends within 1e-4 of the uninterrupted run.  Needs two
    cards."""
    from pathlib import Path

    from repro_torch.training.check import FAILURE_EXIT, crash_and_resume

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: NCCL takes one card a rank")
    res = crash_and_resume("cuda", tmp_path, Path(__file__).parent.parent / "src",
                           extra=("--devices", "2"))
    assert res["rc_full"] == 0 and res["rc_resume"] == 0, res
    assert res["rc_crash"] == FAILURE_EXIT and res["restored"], res
    assert abs(res["resumed_loss"] - res["final_loss"]) < 1e-4, res


@pytest.mark.cuda
def test_cuda_mesh_trainer_refuses_more_nccl_ranks_than_cards():
    """``--devices N`` over NCCL with fewer than N cards raises."""
    from repro_torch.launch import train

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match="NCCL ranks need"):
        train.main(["--smoke", "--steps", "1", "--devices", str(n)])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rank", [((2, 2), 3), ((1, 4), 1)])
def test_cuda_sharded_init_holds_its_blocks_and_one_weight(cuda, shape, rank):
    """llama3.2-1b at full width drawn for one rank of a 4-rank mesh
    (``models.convert.init_sharded``, which needs no process group): the
    peak while drawing stays within the rank's blocks and the largest
    weight's float32 draw and cast, and the blocks are those cut from the
    whole model drawn from the same seed."""
    import types

    from repro_torch import configs as C
    from repro_torch.models import get_model
    from repro_torch.models.convert import init_sharded, shard_params

    dev = cuda
    cfg = C.get_config("llama3.2-1b")
    api = get_model(cfg, dev)
    shapes = list(api.abstract_params().parameters())
    largest = max(t.numel() for t in shapes) * (4 + cfg.dtype.itemsize)
    whole = sum(t.numel() * t.element_size() for t in shapes)
    mesh = types.SimpleNamespace(shape=shape, axis_names=("data", "model"), rank=rank)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_sharded(api, api.generator(0), mesh)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    blocks = torch.cuda.memory_allocated(dev) - base
    assert blocks < 0.26 * whole, (blocks, whole)
    assert peak <= blocks + largest + 100e6, (peak, blocks, largest)
    want = shard_params(cfg, api.init(api.generator(0)), mesh)
    for (k, a), (k2, b) in zip(params.named_parameters(), want.named_parameters()):
        assert k == k2 and a.mesh_spec == b.mesh_spec and torch.equal(a, b), k


def _serve_cases(tmp_path, shape, backend):
    """``tests/torch_mesh_serve_ranks.py decode`` of the smoke llama and
    qwen2-moe (the port's seeded weights) on the cards: rank 0's results."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).parent
    out = tmp_path / "res.json"
    cases = [dict(arch="llama3.2-1b"), dict(arch="qwen2-moe-a2.7b")]
    r = subprocess.run([sys.executable, str(here / "torch_mesh_serve_ranks.py"), "decode",
                        str(out), json.dumps({shape: cases}), "-", "cuda", backend],
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": str(here.parent / "src")})
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-2500:])
    res = json.loads(out.read_text())[shape]
    for c in res:
        assert c["logits"] < 2e-4 and c["cache"] < 2e-4, c
        assert c["weight_moves"] == 0 and c["steps"] == 6, c
    return res


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["1x2", "2x1"])
def test_cuda_mesh_serve_two_nccl_ranks(no_tf32, tmp_path, shape):
    """Decode in serve mode over 2 NCCL ranks, one card each, gives the
    one-process decode's logits.  Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: NCCL takes one card a rank")
    _serve_cases(tmp_path, shape, "nccl")


@pytest.mark.cuda
def test_cuda_mesh_serve_four_nccl_ranks(no_tf32, tmp_path):
    """Decode in serve mode over 4 NCCL ranks at (2, 2).  Needs four cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: NCCL takes one card a rank")
    _serve_cases(tmp_path, "2x2", "nccl")


@pytest.mark.cuda
def test_cuda_mesh_serve_gloo_ranks_share_a_card(no_tf32, tmp_path):
    """Decode in serve mode over 2 gloo ranks on one card at (1, 2)."""
    _serve_cases(tmp_path, "1x2", "gloo")


@pytest.mark.cuda
def test_cuda_baselines_match_cpu_and_repeat(cuda):
    """PQ (n_sub 4, 8, 16) and RaBitQ (l2, ip) on the card over the unit
    rows: two fits from one seed equal bit for bit, the fit against the CPU's
    at the CPU tests' bounds (``repro_torch.core.baselines_check``), and ADC
    distances and estimates from one state within rtol 1e-5 on both."""
    from repro_torch.core import baselines as bl
    from repro_torch.core import baselines_check as bc
    from repro_torch.data.synthetic import make_dataset

    db = make_dataset("unit", device="cpu", cache=False)
    x, ids = db.vectors, np.arange(db.n)
    for n_sub in (4, 8, 16):
        pq = bl.fit_pq(x, n_sub, iters=4, device=cuda)
        assert bc.same_bits(pq, bl.fit_pq(x, n_sub, iters=4, device=cuda))
        cpu = bl.fit_pq(x, n_sub, iters=4, device="cpu")
        bc.compare_pq(pq, cpu.codebooks, cpu.codes, x)
        here = bl.PQ(pq.codebooks.cpu(), pq.codes.cpu(), pq.d_sub, pq.metric)
        for metric in ("l2", "ip"):
            pq.metric = here.metric = metric
            for q in db.queries[:4]:
                bc.close(bl.pq_distances(pq, q, ids), bl.pq_distances(here, q, ids), "adc")
    for metric in ("l2", "ip"):
        rq = bl.fit_rabitq(x, metric, device=cuda)
        assert bc.same_bits(rq, bl.fit_rabitq(x, metric, device=cuda))
        bc.compare_rabitq(rq, bl.fit_rabitq(x, metric, device="cpu"), x)
        here = bl.RaBitQ(*(getattr(rq, f).cpu() for f in ("rotation", "center", "signs",
                                                           "norms", "ip_unit")), metric)
        for q in db.queries[:4]:
            bc.close(bl.rabitq_estimate(rq, q, ids), bl.rabitq_estimate(here, q, ids),
                     "estimate")


@pytest.mark.cuda
def test_cuda_quickstart_tiny(cuda, capsys):
    """``launch/quickstart.py --tiny`` on the card: packed ids == f32 ids, the
    f32, packed and decode kernels launched."""
    from repro_torch.launch import quickstart

    fee_kernel.fee_distance.launches = fee_kernel.fee_distance_packed.launches = 0
    unpack_kernel.dfloat_unpack.launches = 0
    out = quickstart.main(["--tiny"])
    assert out["packed_ids_equal"] and out["recall_at_10"] >= 0.80
    assert fee_kernel.fee_distance.launches > 0 and fee_kernel.fee_distance_packed.launches > 0
    assert unpack_kernel.dfloat_unpack.launches > 0
    assert "neighbor ids bit-identical: True" in capsys.readouterr().out


@pytest.mark.cuda
def test_cuda_distributed_search(cuda):
    """``launch/distributed_search.py`` on the card (4 shards stacked): one
    ``fee_distance`` launch a hop, recall@10 equal to the CPU's run."""
    from repro_torch.launch import distributed_search

    fee_kernel.fee_distance.launches = 0
    db, idx = distributed_search.build(cuda)
    out = distributed_search.report(db, idx, 4, cuda)
    assert fee_kernel.fee_distance.launches == out["hops_max"]
    assert out == distributed_search.main(["--device", "cuda"])
    assert out["recall_at_10"] >= 0.80
