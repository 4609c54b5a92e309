"""The packed FEE kernels' burst-staged decode, on the CPU.

The CUDA kernels ``fee_distance_packed`` and ``fee_distance_packed_skipdma``
read each FEE block through its covering bursts (the 16 B units of the row
around the block's word span) and decode from the staged words with a table
relative to the block's first burst.  Here the host layout
(``fee_distance.block_bursts``) is held against the JAX package's
``_block_positions``, and a plain emulation of the kernels' staged decode
against both packages' decoders, bit for bit; the kernels themselves are in
``test_torch_cuda.py``.  Also the packed-row check's row pitch: the kernels
take a row view of a wider matrix.
"""
import numpy as np
import pytest
import torch

from repro.core import dfloat as jdfl
from repro.kernels.fee_distance import _block_positions
from repro_torch.core import dfloat as dfl
from repro_torch.kernels import dfloat_unpack as unpack_kernel
from repro_torch.kernels import fee_distance as fee_kernel
from repro_torch.kernels import ref
from repro_torch.kernels.check import random_layout

# (D, seg, layout): the main path's 16-bit run and a 32-bit one (every block
# starts a burst), the 12-bit run (10 fields a burst, so blocks of 16 start
# mid-burst), runs whose blocks start a burst only now and then, widths whose
# bursts do not hold a whole block, and the random layouts of
# check.random_layout (seeded below)
LAYOUTS = [(128, 16, [(16, 5, 128)]), (64, 8, [(32, 8, 64)]),
           (128, 16, [(12, 4, 64), (21, 6, 64)]), (64, 16, [(12, 4, 64)]), (96, 16, [(12, 4, 96)]), (60, 6, [(12, 4, 60)]),
           (64, 16, [(21, 6, 22), (14, 5, 42)]), (128, 16, [(24, 8, 40), (18, 6, 88)]),
           (32, 2, [(32, 8, 7), (12, 4, 25)]), (960, 32, [(16, 5, 500), (12, 4, 460)])]
RANDOM = [(d, seg, seed) for seed, (d, seg) in enumerate(
    [(32, 8), (128, 16), (128, 16), (36, 6), (64, 16), (960, 32), (32, 2), (128, 32)])]


def _layout(d, seg, runs_or_seed):
    """(port config, JAX config, packed words, rows) of one layout, the rows
    made from a seed with numpy."""
    rng = np.random.default_rng(d + seg)
    x = rng.standard_normal((37, d)).astype(np.float32)
    if isinstance(runs_or_seed, int):
        cfg, runs = random_layout(np.random.default_rng(runs_or_seed), d, x)
    else:
        runs = runs_or_seed
        cfg = dfl.make_config(d, runs, x)
    jcfg = jdfl.make_config(d, runs, x)
    assert [tuple(vars(s).values()) for s in cfg.segments] == \
        [tuple(vars(s).values()) for s in jcfg.segments]
    return cfg, jcfg, dfl.pack_db(x, cfg)


CASES = [pytest.param(d, seg, runs, id=f"{d}/{seg}-{runs}") for d, seg, runs in LAYOUTS] + \
    [pytest.param(d, seg, seed, id=f"{d}/{seg}-random{seed}") for d, seg, seed in RANDOM]


@pytest.mark.parametrize("d,seg,layout", CASES)
def test_block_bursts_cover_jax_block_positions(d, seg, layout):
    """Each block's covering bursts start on a 4-word boundary around the
    reference's word span and hold every field's word and carry word; the
    burst table names each field's word relative to word ``4 * b0``, in
    word order within the block, its bit offset and its format's
    constants."""
    cfg, jcfg, _ = _layout(d, seg, layout)
    bursts, table = fee_kernel.block_bursts(cfg, seg)
    blocks, w_words = _block_positions(jcfg, seg)
    assert len(bursts) == len(blocks) == d // seg and table.shape == (d, 4)
    assert fee_kernel.stage_bursts(bursts) >= max(b1 - b0 for b0, b1 in bursts)
    u = table.view(np.uint32).astype(np.int64)
    for k, ((b0, b1), (pos, w0, w1)) in enumerate(zip(bursts, blocks)):
        assert (b0, b1) == (w0 // 4, -(-w1 // 4))
        assert 4 * b0 <= w0 < w1 <= 4 * b1 and 4 * b1 <= w_words
        rel = u[k * seg:(k + 1) * seg]
        assert (np.diff(rel[:, 0] >> 5) >= 0).all()              # word order
        for (wi, ofs, s), (x, mask, mul, ebias) in zip(pos, rel):
            assert (x >> 5, x & 31) == (wi - 4 * b0, ofs)
            assert (mask, mul) == ((1 << s.width) - 1, 1 << (23 - s.n_man))
            assert ebias == ((127 - s.bias) << 23) % (1 << 32)
            carry = wi + (ofs + s.width > 32)
            assert 4 * b0 <= wi <= carry < 4 * b1


@pytest.mark.parametrize("d,seg,layout", CASES)
def test_block_formats_mark_static_blocks(d, seg, layout):
    """A block takes the compile-time positions exactly when its fields share
    one format and lie where that width puts them from the start of a burst
    (field j at bit (j % per) * width of burst j // per)."""
    cfg, _, _ = _layout(d, seg, layout)
    bursts, table = fee_kernel.block_bursts(cfg, seg)
    pos, _ = dfl.feature_positions(cfg)
    u = table.view(np.uint32).astype(np.int64)
    n_static = 0
    for k, (width, mul, ebias) in enumerate(fee_kernel.block_formats(cfg, seg)):
        fmts = {id(p[2]) for p in pos[k * seg:(k + 1) * seg]}
        sg = pos[k * seg][2]
        per = 128 // sg.width
        placed = [((j // per) * 4 + (j % per) * sg.width // 32, (j % per) * sg.width % 32)
                  for j in range(seg)]
        where = [(x >> 5, x & 31) for x in u[k * seg:(k + 1) * seg, 0]]
        static = len(fmts) == 1 and placed == where
        assert (width != 0) == static, k
        if width:
            n_static += 1
            assert (width, mul, ebias) == (sg.width, *(int(v) for v in u[k * seg, 2:]))
            assert bursts[k][1] - bursts[k][0] == -(-seg // per)
    if isinstance(layout, list) and len(layout) == 1 and seg % (128 // layout[0][0]) == 0:
        assert n_static == d // seg                        # e.g. the main path's 16-bit run


def _widen(fld, mask, mul, ebias):
    """``naszip::widen_field`` in int64 arithmetic -> f32."""
    body = mask >> 1
    bits = ((fld & body) * mul + ebias) & ((1 << 32) - 1)
    bits = torch.where(fld == 0, 0, bits | torch.where(fld > body, 1 << 31, 0))
    return (bits - ((bits >> 31) << 32)).to(torch.int32).view(torch.float32)


def staged_decode(xp: torch.Tensor, cfg: dfl.DfloatConfig, seg: int,
                  tables=None) -> torch.Tensor:
    """Plain emulation of the packed kernels' decode (``seg_part_bursts``):
    per block, stage its covering bursts' words (clipped to the row; zero
    past them and in the extra last slot), then either decode each field j
    at its compile-time position (a block whose descriptor names a width:
    bit (j % per) * width of burst j // per) or walk the staged bursts in
    order taking each burst's fields from the burst table, picking a
    field's word pair by compare/select among the burst's four words and the
    next burst's first; shift the pair down as a funnel shift does, and
    widen the field with its format's constants.  ``tables`` = (burst table,
    block descriptors, staging size) as the kernels get them, by default
    the packed kernels' own (``_burst_tables``).  Returns (N, D) f32."""
    if tables is None:
        tables = fee_kernel._burst_tables(cfg, seg, torch.device("cpu"))
    table, blocks, nb = tables
    table, blocks = np.asarray(table), np.asarray(blocks).view(np.uint32)
    words = dfl.words_i64(xp)
    n, w_total = words.shape
    if cfg.dim == 0:
        return torch.zeros((n, 0), dtype=torch.float32)
    cols = [None] * cfg.dim
    for k, (b0, desc, mul, ebias) in enumerate(blocks.astype(np.int64)):
        b1, width = b0 + (desc & 0xFF), desc >> 8
        assert b1 - b0 <= nb
        staged = torch.zeros((n, 4 * nb + 1), dtype=torch.int64)
        end = min(4 * b1, w_total)
        staged[:, :end - 4 * b0] = words[:, 4 * b0:end]
        f, f_end = k * seg, (k + 1) * seg
        if width:
            per = 128 // width
            for j in range(seg):
                bit = (j % per) * width
                wi, ofs = 4 * (j // per) + bit // 32, bit % 32
                pair = staged[:, wi] | (staged[:, wi + 1] << 32)
                cols[f + j] = _widen((pair >> ofs) & ((1 << width) - 1), (1 << width) - 1,
                                     int(mul), int(ebias))
            continue
        for c in range(nb):
            while f < f_end and int(table[f, 0]) >> 7 == c:
                x, mask, mul, ebias = (int(v) for v in table[f].view(np.uint32))
                base = 4 * c + (2 if x & 64 else 0)
                p0, p1, p2 = (staged[:, base + i] for i in range(3))
                lo, hi = (p1, p2) if x & 32 else (p0, p1)
                cols[f] = _widen(((lo | (hi << 32)) >> (x & 31)) & mask, mask, mul, ebias)
                f += 1
        assert f == f_end, f"block {k}: fields {f}..{f_end} lie past the staged bursts"
    return torch.stack(cols, dim=1)


@pytest.mark.parametrize("d,seg,layout", CASES)
def test_staged_decode_matches_both_decoders(d, seg, layout):
    cfg, jcfg, packed = _layout(d, seg, layout)
    pt = torch.from_numpy(packed.view(np.int32))
    got = staged_decode(pt, cfg, seg).view(torch.int32)
    assert torch.equal(got, dfl.unpack_rows(pt, cfg).view(torch.int32))
    want = jdfl.unpack_db(packed, jcfg)
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_stage_bursts_sizes():
    """The least compiled staging size that holds every block; a block of
    more than 16 bursts is refused."""
    assert fee_kernel.stage_bursts([(0, 2), (2, 4)]) == 2
    assert fee_kernel.stage_bursts([(0, 2), (2, 5)]) == 4
    assert fee_kernel.stage_bursts([(3, 12)]) == 16
    with pytest.raises(ValueError, match="bursts"):
        fee_kernel.stage_bursts([(0, 17)])
    # seg = 16 of 16-bit fields: two bursts per block, the main path's size
    x = np.random.default_rng(0).standard_normal((8, 128)).astype(np.float32)
    bursts, _ = fee_kernel.block_bursts(dfl.make_config(128, [(16, 5, 128)], x), 16)
    assert bursts == [(2 * k, 2 * k + 2) for k in range(8)]


def test_row_pitch_takes_row_views():
    """The packed kernels take rows at any pitch >= W (a row view of a wider
    matrix: ``stride(1) == 1``, ``stride(0) >= W``) and refuse any other
    stride; the check also wants a CUDA tensor."""
    x = np.random.default_rng(1).standard_normal((10, 64)).astype(np.float32)
    cfg = dfl.make_config(64, [(16, 5, 64)], x)
    w = dfl.packed_words(cfg)
    wide = torch.zeros((10, w + 4), dtype=torch.int32)
    assert unpack_kernel.row_pitch(torch.zeros((10, w), dtype=torch.int32), cfg) == w
    assert unpack_kernel.row_pitch(wide[:, :w], cfg) == w + 4
    assert unpack_kernel.row_pitch(wide[:, 1:w + 1], cfg) == w + 4      # base + 4 B
    with pytest.raises(ValueError, match="pitch"):                    # stride(1) != 1
        unpack_kernel.row_pitch(torch.zeros((w, 10), dtype=torch.int32).t(), cfg)
    with pytest.raises(ValueError, match="pitch"):                    # rows overlap
        unpack_kernel.row_pitch(torch.zeros(10 * w, dtype=torch.int32)
                                .as_strided((10, w), (w - 1, 1)), cfg)
    with pytest.raises(ValueError, match="words per row"):
        unpack_kernel.row_pitch(wide, cfg)
    # an empty tier (split 0 or S) comes as (N, 0) with any strides
    _, none = dfl.split_config(cfg, 64)
    empty = torch.from_numpy(dfl.pack_tiers(x, cfg, 64)[1].view(np.int32))
    assert empty.shape == (10, 0)
    unpack_kernel.row_pitch(empty, none)
    with pytest.raises(ValueError, match="CUDA"):
        unpack_kernel.check_packed(wide[:, :w], cfg)


def test_packed_wrappers_take_row_views_on_cpu():
    """A row view at pitch W + 4 scores and decodes as the contiguous rows
    do (CPU tensors: the plain versions)."""
    c, d, seg = 40, 64, 16
    rng = np.random.default_rng(2)
    x = rng.standard_normal((c, d)).astype(np.float32)
    cfg = dfl.make_config(d, [(16, 5, 30), (12, 4, 34)], x)
    packed = torch.from_numpy(dfl.pack_db(x, cfg).view(np.int32))
    w = packed.shape[1]
    wide = torch.zeros((c, w + 4), dtype=torch.int32)
    view = wide[:, 1:w + 1]
    view.copy_(packed)
    ids = torch.from_numpy(rng.integers(0, c, (3, c)).astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((3, d)).astype(np.float32))
    s = d // seg
    fee = (torch.full((s,), 1.2), torch.ones(s), torch.zeros(s))
    thr = torch.full((3,), 100.0)
    for fn in (fee_kernel.fee_distance_packed, fee_kernel.fee_distance_packed_skipdma):
        got = fn(view, ids, q, thr, *fee, dfloat_cfg=cfg, seg=seg)
        want = fn(packed, ids, q, thr, *fee, dfloat_cfg=cfg, seg=seg)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert torch.equal(ref.dfloat_unpack_ref(view, cfg), ref.dfloat_unpack_ref(packed, cfg))
