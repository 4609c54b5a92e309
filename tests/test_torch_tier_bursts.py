"""The host layout of the tiered and f32 skip-DMA kernels, on the CPU.

``fee_distance_tiered`` stages a block's covering bursts from the tier that
holds it and decodes them as the packed kernels do, with one burst table and
one set of block descriptors for both tiers (``fee_distance._tier_tables``:
the coarse tier's blocks, then the residual tier's, each relative to its own
row).  Here those tables are held, at every split on a segment boundary,
against the JAX package's ``_block_positions`` of each tier (tier layouts
from the JAX package's ``split_config``), and the plain emulation of the
staged decode, run per tier with them, against both packages' decoders of
the parent rows, bit for bit.  The f32 skip-DMA kernel's lane slots: their
stride is odd in the unit a lane reads them by, so a warp's shared loads hit
distinct banks, and the warps fit a block's shared memory.  The kernels
themselves are in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro.core import dfloat as jdfl
from repro.kernels.fee_distance import _block_positions
from repro_torch.core import dfloat as dfl
from repro_torch.kernels import fee_distance as fee_kernel
from repro_torch.kernels import ref
from test_torch_packed_bursts import CASES, _layout, staged_decode

CPU = torch.device("cpu")


def _tiers(cfg, jcfg, seg, split):
    """The port's and the JAX package's tier layouts at ``split`` segments,
    checked equal, and the tier tables split into (coarse, residual)."""
    ccfg, rcfg = dfl.split_config(cfg, split * seg)
    jc, jr = jdfl.split_config(jcfg, split * seg)
    for mine, theirs in ((ccfg, jc), (rcfg, jr)):
        assert [tuple(vars(s).values()) for s in mine.segments] == \
            [tuple(vars(s).values()) for s in theirs.segments]
    table, blocks, nb = fee_kernel._tier_tables(ccfg, rcfg, seg, CPU)
    table, blocks = table.numpy(), blocks.numpy()
    dc = ccfg.dim
    assert table.shape == (cfg.dim, 4) and blocks.shape == (cfg.dim // seg, 4)
    return ((ccfg, jc, (table[:dc], blocks[:split], nb)),
            (rcfg, jr, (table[dc:], blocks[split:], nb)))


@pytest.mark.parametrize("d,seg,layout", CASES)
def test_tier_tables_cover_jax_block_positions(d, seg, layout):
    """At every split k * seg, each tier's block descriptors name covering
    bursts of that tier's row around the reference's word span of the block
    (``_block_positions`` of the tier layout), within the staging size; its
    burst table rows name each field's word relative to the block's first
    burst, and its bit offset."""
    cfg, jcfg, _ = _layout(d, seg, layout)
    for split in range(d // seg + 1):
        for tcfg, jt, (table, blocks, nb) in _tiers(cfg, jcfg, seg, split):
            spans, w_words = _block_positions(jt, seg)
            assert len(spans) == len(blocks) == tcfg.dim // seg
            assert w_words == dfl.packed_words(tcfg)
            u = blocks.view(np.uint32).astype(np.int64)
            t = table.view(np.uint32).astype(np.int64)
            formats = fee_kernel.block_formats(tcfg, seg)
            for k, ((pos, w0, w1), (b0, desc, mul, ebias)) in enumerate(zip(spans, u)):
                b1 = b0 + (desc & 0xFF)
                assert (b0, b1) == (w0 // 4, -(-w1 // 4)), (split, k)
                assert 4 * b0 <= w0 < w1 <= 4 * b1 <= w_words and b1 - b0 <= nb
                assert (desc >> 8, mul, ebias) == formats[k]
                for (wi, ofs, s), row in zip(pos, t[k * seg:(k + 1) * seg]):
                    assert (row[0] >> 5, row[0] & 31) == (wi - 4 * b0, ofs)
                    assert row[1] == (1 << s.width) - 1


@pytest.mark.parametrize("d,seg,layout", CASES)
def test_tier_staged_decode_matches_parent(d, seg, layout):
    """The staged decode of each tier's rows with the tier tables,
    concatenated, equals the decode of the parent rows bit for bit, in both
    packages, at every split (the empty tiers included)."""
    cfg, jcfg, packed = _layout(d, seg, layout)
    pt = torch.from_numpy(packed.view(np.int32))
    want = dfl.unpack_rows(pt, cfg).view(torch.int32)
    assert np.array_equal(want.numpy().view(np.uint32),
                          jdfl.unpack_db(packed, jcfg).view(np.uint32))
    x = dfl.unpack_rows(pt, cfg).numpy()      # rows that pack back to `packed`
    for split in range(d // seg + 1):
        tiers = dfl.pack_tiers(x, cfg, split * seg)
        got = torch.cat([staged_decode(torch.from_numpy(rows.view(np.int32)), tcfg, seg,
                                       tables)
                         for rows, (tcfg, _, tables)
                         in zip(tiers, _tiers(cfg, jcfg, seg, split))], dim=1)
        assert torch.equal(got.view(torch.int32), want), split


def test_tier_tables_refuse_a_split_inside_a_segment():
    """The kernel's tables want the split on a segment boundary; the plain
    version takes any split and still equals the packed one."""
    c, d, seg = 12, 64, 16
    rng = np.random.default_rng(3)
    x = rng.standard_normal((c, d)).astype(np.float32)
    cfg = dfl.make_config(d, [(16, 5, 30), (12, 4, 34)], x)
    for n_features in (1, 15, 17, 40):
        ccfg, rcfg = dfl.split_config(cfg, n_features)
        with pytest.raises(ValueError, match="segment boundary"):
            fee_kernel._tier_tables(ccfg, rcfg, seg, CPU)
    ccfg, rcfg = dfl.split_config(cfg, 40)
    xc, xr = (torch.from_numpy(t.view(np.int32)) for t in dfl.pack_tiers(x, cfg, 40))
    packed = torch.from_numpy(dfl.pack_db(x, cfg).view(np.int32))
    ids = torch.from_numpy(rng.integers(0, c, (2, c)).astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((2, d)).astype(np.float32))
    s = d // seg
    fee = (torch.full((s,), 1.2), torch.ones(s), torch.zeros(s))
    thr = torch.full((2,), 60.0)
    got = fee_kernel.fee_distance_tiered(xc, xr, ids, q, thr, *fee, coarse_cfg=ccfg,
                                         resid_cfg=rcfg, seg=seg)
    want = ref.fee_distance_packed_gather_ref(packed, ids, q, thr, *fee, dfloat_cfg=cfg,
                                              seg=seg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seg", [2, 6, 8, 16, 32, 128])
def test_skipdma_f32_slots_are_conflict_free_and_fit(seg):
    """A lane's slot holds its segment at a stride that is odd in 16 B
    chunks on the 16 B path and odd in words on the 4 B path, so the 16 B
    loads of each quarter-warp (or the 4 B loads of the warp) at the same
    offset of their slots hit distinct banks; two tiles of 32 slots a warp
    fit a block's shared memory."""
    for vec in ((True, False) if seg % 4 == 0 else (False,)):
        slot = fee_kernel.skipdma_f32_slot(seg, vec)
        assert slot >= seg
        if vec:
            assert slot % 4 == 0 and (slot // 4) % 2 == 1 and slot < seg + 8
            for k in range(seg // 4):              # chunk k of 8 lanes: 8 banks of 4
                for quarter in range(4):
                    lanes = range(8 * quarter, 8 * quarter + 8)
                    assert len({(j * slot // 4 + k) % 8 for j in lanes}) == 8
        else:
            assert slot % 2 == 1 and slot < seg + 2
            for f in range(seg):
                assert len({(j * slot + f) % 32 for j in range(32)}) == 32
        per_warp = 2 * 32 * slot * 4
        warps = fee_kernel.skip_warps(per_warp)
        assert 1 <= warps <= fee_kernel.SKIP_WARPS
        assert warps * per_warp <= fee_kernel.SMEM_BLOCK_MAX
    assert fee_kernel.skipdma_f32_slot(16, True) == 20       # the main path: seg + 4
