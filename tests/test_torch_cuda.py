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
(``repro_torch.models.mesh_check``) with no collective on a weight.
"""
import numpy as np
import pytest
import torch

from fee_cases import inputs
from repro_torch.core import dfloat as dfl
from repro_torch.kernels import dfloat_unpack as unpack_kernel
from repro_torch.kernels import fee_distance as fee_kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels.check import (SCALAR_SHAPES, SHAPES, compare_fee, near_threshold,
                                       random_layout)


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
    cfg, _ = random_layout(rng, d, x)
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
    """Random layouts at the kernel tests' shapes (D = 960 included), and
    the main path's one 16-bit run (W = 64 words, so pitch W + 4 is 68)."""
    rng = np.random.default_rng(c + d + seg)
    x = rng.standard_normal((c, d)).astype(np.float32)
    if (c, d, seg) == (100, 128, 16):
        cfg = dfl.make_config(d, [(16, 5, d)], x)
        assert dfl.packed_words(cfg) == 64
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
