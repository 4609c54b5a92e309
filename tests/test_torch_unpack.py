"""The ``dfloat_unpack`` kernel's host side and its gather / column routes, on
the CPU.

The CUDA kernel decodes one 16 B burst a thread from a per-burst descriptor
table (``dfloat_unpack.burst_descriptors``), or, for layouts whose bursts are
not 128 bits or whose widths lie outside the palette, one field a thread from
a per-feature table (``field_table``).  Here a plain emulation of both paths
over those tables is held against the JAX package's ``unpack_db`` bit for
bit, and the wrapper's ``ids`` (rows gathered inside the kernel, an id that
names no row decoding as zeros) and ``out``/``col`` (a column offset of a
wider output) routes, through ``kernels.ops`` and ``core.search.decode_rows``
for packed rows and for every tier split, against ``unpack_db`` too.  The
kernel itself is held against its plain version in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro.core import dfloat as jdfl
from repro_torch.core import dfloat as dfl
from repro_torch.core import search as tsearch
from repro_torch.kernels import dfloat_unpack as unpack_kernel
from repro_torch.kernels import ops, ref
from test_torch_packed_bursts import CASES, _layout, _widen


def _u32(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32)


def _want(packed, jcfg, ids):
    """The JAX package's decode of rows ``ids`` (zeros where an id names no
    row)."""
    full = jdfl.unpack_db(packed, jcfg)
    ok = (ids >= 0) & (ids < len(packed))
    return np.where(ok[:, None], full[np.where(ok, ids, 0)], np.float32(0))


def _ids(n, seed):
    """Row ids with repeats, and two that name no row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, 2 * n + 3)
    ids[[1, -2]] = (-1, n)
    return ids


def burst_decode(words: torch.Tensor, cfg: dfl.DfloatConfig) -> torch.Tensor:
    """Plain emulation of the kernel's burst path: burst b of a row is words
    4b..4b+3; descriptor b gives its first output feature f0, its field
    count n, its width w and its format's constants; field l < n lies at
    bit l * w of the burst (never past bit 128) and goes to column f0 + l."""
    desc = unpack_kernel.burst_descriptors(cfg).view(np.uint32).astype(np.int64)
    w64 = dfl.words_i64(words)
    assert desc.shape[0] * 4 == w64.shape[1]
    out = torch.full((w64.shape[0], cfg.dim), float("nan"))
    for b, (f0, nw, mul, ebias) in enumerate(desc):
        n, width = int(nw & 0xFF), int(nw >> 8)
        assert 0 < n <= 128 // width and width in unpack_kernel.BURST_WIDTHS
        burst = sum(w64[:, 4 * b + i] << (32 * i) for i in range(2))  # words 0-1
        hi = sum(w64[:, 4 * b + 2 + i] << (32 * i) for i in range(2))  # words 2-3
        for l in range(n):
            bit = l * width
            assert bit + width <= 128
            if bit + width <= 64:
                fld = burst >> bit
            elif bit >= 64:
                fld = hi >> (bit - 64)
            else:   # a logical shift of the low half, then the high half's bits
                fld = ((burst >> bit) & ((1 << (64 - bit)) - 1)) | (hi << (64 - bit))
            mask = (1 << width) - 1
            out[:, f0 + l] = _widen(fld & mask, mask, int(mul), int(ebias))
    return out


def field_decode(words: torch.Tensor, cfg: dfl.DfloatConfig) -> torch.Tensor:
    """Plain emulation of the kernel's per-field path from ``field_table``:
    the field at bit offset ``ofs`` of word ``wi`` (its carry in word wi + 1
    when it spans two), widened with its format's constants."""
    tab = unpack_kernel.field_table(cfg).view(np.uint32).astype(np.int64)
    w64 = dfl.words_i64(words)
    cols = []
    for wi, y, mul, ebias in tab:
        ofs, width = int(y & 0xFF), int(y >> 8)
        v = w64[:, wi] >> ofs
        if ofs + width > 32:
            v = v | (w64[:, wi + 1] << (32 - ofs))
        mask = (1 << width) - 1
        cols.append(_widen(v & mask, mask, int(mul), int(ebias)))
    return torch.stack(cols, dim=1) if cols else torch.zeros((w64.shape[0], 0))


@pytest.mark.parametrize("d,seg,layout", CASES)
def test_burst_and_field_tables_decode_like_jax(d, seg, layout):
    cfg, jcfg, packed = _layout(d, seg, layout)
    pt = torch.from_numpy(packed.view(np.int32))
    want = _u32(jdfl.unpack_db(packed, jcfg))
    assert unpack_kernel.by_burst(cfg)
    assert np.array_equal(_u32(burst_decode(pt, cfg)), want)
    assert np.array_equal(_u32(field_decode(pt, cfg)), want)


@pytest.mark.parametrize("burst_bits,runs", [(64, [(16, 5, 40), (12, 4, 24)]),
                                             (256, [(21, 6, 50), (14, 5, 14)]),
                                             (128, [(20, 6, 30), (16, 5, 34)])])
def test_field_path_layouts_decode_like_jax(burst_bits, runs):
    """Bursts of other than 128 bits, or a width outside the palette (20),
    take the per-field path: its table decodes them exactly."""
    rng = np.random.default_rng(burst_bits)
    x = rng.standard_normal((29, 64)).astype(np.float32)
    cfg = dfl.make_config(64, runs, x, burst_bits=burst_bits)
    jcfg = jdfl.make_config(64, runs, x, burst_bits=burst_bits)
    assert not unpack_kernel.by_burst(cfg)
    packed = dfl.pack_db(x, cfg)
    got = field_decode(torch.from_numpy(packed.view(np.int32)), cfg)
    assert np.array_equal(_u32(got), _u32(jdfl.unpack_db(packed, jcfg)))


@pytest.mark.parametrize("d,seg,layout", CASES)
@pytest.mark.parametrize("backend", ["auto", "jnp"])
def test_gather_and_column_routes_match_jax(d, seg, layout, backend):
    cfg, jcfg, packed = _layout(d, seg, layout)
    pt = torch.from_numpy(packed.view(np.int32))
    ids = _ids(len(packed), d + seg)
    want = _u32(_want(packed, jcfg, ids))
    it = torch.from_numpy(ids)
    got = ops.dfloat_unpack_rows(pt, cfg, ids=it, backend=backend)
    assert np.array_equal(_u32(got), want)
    assert np.array_equal(_u32(tsearch.decode_rows(pt, it, cfg, backend=backend)), want)
    # a row view at a 4-word wider pitch, written at column 3 of a wider output
    wide = torch.zeros((len(packed), pt.shape[1] + 4), dtype=torch.int32)
    wide[:, :pt.shape[1]] = pt
    out = torch.full((len(ids), d + 5), -7.0)
    assert unpack_kernel.dfloat_unpack(wide[:, :pt.shape[1]], cfg, ids=it, out=out,
                                       col=3) is out
    assert np.array_equal(_u32(out[:, 3:3 + d]), want)
    assert bool((out[:, :3] == -7).all() and (out[:, 3 + d:] == -7).all())


@pytest.mark.parametrize("d,seg,layout", [c for c in CASES if "random" not in c.id][:6])
@pytest.mark.parametrize("backend", ["auto", "jnp"])
def test_tiered_pair_routes_match_jax_every_split(d, seg, layout, backend):
    """Both tiers decoded into one matrix (the coarse tier's columns, then
    the residual tier's from column Dc) equal the parent layout's decode, at
    every split, gathered by id or whole."""
    cfg, jcfg, packed = _layout(d, seg, layout)
    x = jdfl.unpack_db(packed, jcfg)
    ids = _ids(len(packed), seg)
    it = torch.from_numpy(ids)
    for split in range(0, d + 1, seg):
        ccfg, rcfg = dfl.split_config(cfg, split)
        tiers = tuple(torch.from_numpy(t.view(np.int32))
                      for t in dfl.pack_tiers(x, cfg, split))
        whole = ops.dfloat_unpack_tiered_rows(*tiers, ccfg, rcfg, backend=backend)
        assert np.array_equal(_u32(whole), _u32(x)), split
        got = tsearch.decode_rows(tiers, it, (ccfg, rcfg), backend=backend)
        assert np.array_equal(_u32(got), _u32(_want(packed, jcfg, ids))), split


def test_wrapper_rejects_bad_targets():
    x = np.random.default_rng(0).standard_normal((8, 32)).astype(np.float32)
    cfg = dfl.make_config(32, [(16, 5, 32)], x)
    pt = torch.from_numpy(dfl.pack_db(x, cfg).view(np.int32))
    with pytest.raises(TypeError, match="int64"):
        unpack_kernel.dfloat_unpack(pt, cfg, ids=torch.arange(4, dtype=torch.int32))
    with pytest.raises(TypeError, match="int64"):
        unpack_kernel.dfloat_unpack(pt, cfg, ids=torch.arange(8)[::2])
    with pytest.raises(ValueError, match="column offset"):
        unpack_kernel.dfloat_unpack(pt, cfg, col=1)
    with pytest.raises(ValueError, match="no room"):
        unpack_kernel.dfloat_unpack(pt, cfg, out=torch.zeros((8, 40)), col=9)
    with pytest.raises(ValueError, match="no room"):
        unpack_kernel.dfloat_unpack(pt, cfg, ids=torch.arange(3), out=torch.zeros((8, 32)))
    with pytest.raises(TypeError, match="float32"):
        unpack_kernel.dfloat_unpack(pt, cfg, out=torch.zeros((8, 32), dtype=torch.float64))
    # no rows, one row, an empty source: shapes as the plain version gives them
    assert unpack_kernel.dfloat_unpack(pt, cfg, ids=torch.zeros(0, dtype=torch.int64)).shape \
        == (0, 32)
    one = unpack_kernel.dfloat_unpack(pt, cfg, ids=torch.tensor([5]))
    assert torch.equal(one, ref.dfloat_unpack_ref(pt[5:6], cfg))
    none = unpack_kernel.dfloat_unpack(pt[:0], cfg, ids=torch.tensor([0, 2]))
    assert torch.equal(none, torch.zeros((2, 32)))


def test_burst_descriptors_cover_each_feature_once():
    """Per layout of the index and the edge layouts: the descriptors' runs
    tile [0, D) in burst order, and their count is W / 4."""
    for d, seg, layout in (c.values for c in CASES):
        cfg, _, packed = _layout(d, seg, layout)
        desc = unpack_kernel.burst_descriptors(cfg).view(np.uint32)
        assert desc.shape == (packed.shape[1] // 4, 4)
        starts, counts = desc[:, 0].astype(int), (desc[:, 1] & 0xFF).astype(int)
        assert starts[0] == 0 and np.array_equal(starts[1:], np.cumsum(counts)[:-1])
        assert counts.sum() == d


@pytest.mark.parametrize("d,runs", [(32, [(16, 5, 32)]), (64, [(12, 4, 30), (21, 6, 34)])])
def test_plain_decoder_takes_zero_rows(d, runs):
    """The torch decoder of zero rows gives a (0, D) matrix, as the JAX
    package's ``unpack_db`` does (it used to fail on the empty reshape)."""
    x = np.random.default_rng(d).standard_normal((5, d)).astype(np.float32)
    cfg, jcfg = dfl.make_config(d, runs, x), jdfl.make_config(d, runs, x)
    empty = dfl.pack_db(x, cfg)[:0]
    want = jdfl.unpack_db(empty, jcfg)
    got = dfl.unpack_rows(torch.from_numpy(empty.view(np.int32)), cfg)
    assert tuple(got.shape) == want.shape == (0, d)
    assert unpack_kernel.dfloat_unpack(torch.from_numpy(empty.view(np.int32)),
                                       cfg).shape == (0, d)
