"""Port kernels vs the JAX package: the plain PyTorch versions (what the
wrappers run on CPU tensors) against the Pallas kernels in interpret mode and
their ``ref.py`` oracles, on the same numpy inputs (the CUDA kernels against
the plain versions are in ``test_torch_cuda.py``).

Tolerance (``repro_torch.kernels.check``): XLA and torch reduce each
segment's sum in different orders (on the CPU only about a third of
per-segment f32 sums come out bit-equal), so distances are held to rtol 3e-5
/ atol 2e-4 and exit flags / ``segs_used`` must be exact except for lanes
whose estimate lies within that tolerance of the threshold.  The Dfloat
decode is integer work and must be bit-exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fee_cases import inputs, threshold
from proptest import given
from repro.core import dfloat as jdfl
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.dfloat_unpack import dfloat_unpack_pallas
from repro.kernels.fee_distance import fee_distance_packed_pallas, fee_distance_pallas
from repro_torch.core import dfloat as dfl
from repro_torch.kernels import dfloat_unpack as unpack_kernel
from repro_torch.kernels import fee_distance as fee_kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels.check import SHAPES, compare_fee, near_threshold


def _inputs(c, d, seg, metric, seed, cast=None):
    q, x, thr, alpha, beta, margin = inputs(c, d, seg, metric, seed)
    if cast is not None:
        q, x = (np.asarray(jnp.asarray(a).astype(cast).astype(jnp.float32))
                for a in (q, x))
        thr = threshold(q, x, metric)
    return q, x, thr, alpha, beta, margin


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _port_fee(q, x, thr, alpha, beta, margin, seg, metric, lane_mask=None):
    """The port's dispatcher on one query: ids 0..C-1 into ``x``."""
    c = x.shape[0]
    ids = torch.arange(c, dtype=torch.int32)[None]
    qt, xt, at, bt, mt = _t(q, x, alpha, beta, margin)
    return ops.fee_distance(xt, ids, qt[None], torch.tensor([thr]), at, bt, mt,
                            seg=seg, metric=metric, lane_mask=lane_mask)


@pytest.mark.parametrize("c,d,seg", SHAPES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_fee_distance_plain_vs_jax(c, d, seg, metric):
    q, x, thr, alpha, beta, margin = _inputs(c, d, seg, metric, c + d)
    args = (jnp.asarray(q), jnp.asarray(x), jnp.float32(thr), jnp.asarray(alpha),
            jnp.asarray(beta), jnp.asarray(margin))
    pallas = fee_distance_pallas(*args, seg=seg, metric=metric, tile_c=64)
    oracle = jref.fee_distance_ref(*args, seg=seg, metric=metric)
    near = near_threshold(q, x, thr, alpha, beta, margin, seg=seg, metric=metric)
    plain = ref.fee_distance_ref(*_t(q, x), thr, *_t(alpha, beta, margin),
                                 seg=seg, metric=metric)
    routed = _port_fee(q, x, thr, alpha, beta, margin, seg, metric)
    for got in (plain, routed):
        compare_fee(got, pallas, near)
        compare_fee(got, oracle, near)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_fee_distance_bf16_cast_inputs(metric):
    c, d, seg = 64, 128, 16
    q, x, thr, alpha, beta, margin = _inputs(c, d, seg, metric, 0, cast=jnp.bfloat16)
    pallas = fee_distance_pallas(jnp.asarray(q), jnp.asarray(x), jnp.float32(thr),
                                 jnp.asarray(alpha), jnp.asarray(beta),
                                 jnp.asarray(margin), seg=seg, metric=metric)
    near = near_threshold(q, x, thr, alpha, beta, margin, seg=seg, metric=metric)
    compare_fee(_port_fee(q, x, thr, alpha, beta, margin, seg, metric), pallas, near)


def _random_layout(draw, d, x):
    widths = sorted({draw.choice([32, 24, 21, 18, 16, 14, 12], f"w{i}")
                     for i in range(draw.integers(1, 3, "nseg"))}, reverse=True)
    runs, left = [], d
    for i, w in enumerate(widths):
        nd = left if i == len(widths) - 1 else max(1, left // (len(widths) - i))
        runs.append((w, dfl.EXP_BITS[w], nd))
        left -= nd
    return jdfl.make_config(d, runs, x), dfl.make_config(d, runs, x)


@given(n_cases=12)
def test_dfloat_unpack_plain_vs_jax_bit_exact(draw):
    d = draw.choice([32, 64, 128, 256], "d")
    n = draw.integers(3, 70, "n")
    x = draw.array((n, d), scale=np.exp(draw.floats(-2, 2, "logscale")))
    jcfg, cfg = _random_layout(draw, d, x)
    packed = jdfl.pack_db(x, jcfg)
    want = jref.dfloat_unpack_ref(packed, jcfg)
    assert np.array_equal(np.asarray(dfloat_unpack_pallas(jnp.asarray(packed), jcfg,
                                                          tile_c=128)), want)
    pt = torch.from_numpy(packed.view(np.int32))
    for got in (ref.dfloat_unpack_ref(pt, cfg), ops.dfloat_unpack_rows(pt, cfg),
                unpack_kernel.dfloat_unpack(torch.from_numpy(packed), cfg)):
        assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@given(n_cases=4)
def test_fee_distance_packed_plain_vs_jax_random_layouts(draw):
    d = draw.choice([64, 128], "d")
    seg = 16
    n = draw.integers(10, 90, "n")
    metric = draw.choice(["l2", "ip"], "metric")
    x = draw.array((n, d), scale=np.exp(draw.floats(-1, 1, "logscale")))
    jcfg, cfg = _random_layout(draw, d, x)
    packed = jdfl.pack_db(x, jcfg)
    s = d // seg
    ones = np.ones(s, np.float32)
    q = x[0]
    xq = jdfl.unpack_db(packed, jcfg)
    thr = np.float32(np.median(((xq - q) ** 2).sum(1)) if metric == "l2"
                     else -np.median(xq @ q))
    jargs = (jnp.asarray(q), jnp.asarray(packed), jnp.float32(thr),
             jnp.asarray(ones * 1.2), jnp.asarray(ones), jnp.asarray(ones * 0))
    oracle = jref.fee_distance_packed_ref(*jargs, dfloat_cfg=jcfg, seg=seg,
                                          metric=metric)
    pallas = fee_distance_packed_pallas(*jargs, dfloat_cfg=jcfg, seg=seg,
                                        metric=metric, tile_c=128)
    near = near_threshold(q, xq, thr, ones * 1.2, ones, ones * 0, seg=seg,
                          metric=metric)
    pt = torch.from_numpy(packed.view(np.int32))
    qt, at, bt, mt = _t(q, ones * 1.2, ones, ones * 0)
    plain = ref.fee_distance_packed_ref(qt, pt, thr, at, bt, mt, dfloat_cfg=cfg,
                                        seg=seg, metric=metric)
    routed = ops.fee_distance_packed(pt, torch.arange(n, dtype=torch.int32)[None],
                                     qt[None], torch.tensor([thr]), at, bt, mt,
                                     dfloat_cfg=cfg, seg=seg, metric=metric)
    for got in (plain, routed):
        compare_fee(got, oracle, near)
        compare_fee(got, pallas, near)
    # packed scoring is bit-identical to f32 scoring of the decoded rows
    f32 = _port_fee(q, xq, thr, ones * 1.2, ones, ones * 0, seg, metric)
    for a, b in zip(routed, f32):
        assert torch.equal(a, b)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_lane_mask_fold_vs_jax(metric):
    c, d, seg = 100, 128, 16
    q, x, thr, alpha, beta, margin = _inputs(c, d, seg, metric, 3)
    mask = np.random.default_rng(4).random(c) < 0.7
    want = jops.fee_distance(jnp.asarray(q), jnp.asarray(x), jnp.float32(thr),
                             jnp.asarray(alpha), jnp.asarray(beta),
                             jnp.asarray(margin), seg=seg, metric=metric,
                             backend="jnp", lane_mask=jnp.asarray(mask))
    got = _port_fee(q, x, thr, alpha, beta, margin, seg, metric,
                    lane_mask=torch.from_numpy(mask)[None])
    dist, rej, segs = (t.numpy()[0] for t in got)
    # dead lanes: rejected, no segments, the partial score of zero segments
    assert rej[~mask].all() and (segs[~mask] == 0).all() and (dist[~mask] == 0).all()
    assert np.array_equal(rej[~mask], np.asarray(want[1])[~mask])
    assert np.array_equal(segs[~mask], np.asarray(want[2])[~mask])
    near = near_threshold(q, x, thr, alpha, beta, margin, seg=seg, metric=metric)
    compare_fee([t.numpy()[0][mask] for t in got],
                [np.asarray(t)[mask] for t in want], near[torch.from_numpy(mask)])


def test_ops_routing_on_cpu():
    """CPU tensors take the plain version under every backend (no launch is
    counted); "jnp" selects it explicitly; an unknown backend raises."""
    c, d, seg = 40, 64, 16
    q, x, thr, alpha, beta, margin = _inputs(c, d, seg, "l2", 5)
    kernels = (fee_kernel.fee_distance, fee_kernel.fee_distance_packed,
               fee_kernel.fee_distance_skipdma, fee_kernel.fee_distance_packed_skipdma,
               fee_kernel.fee_distance_tiered, unpack_kernel.dfloat_unpack)
    before = [k.launches for k in kernels]
    auto = _port_fee(q, x, thr, alpha, beta, margin, seg, "l2")
    ids = torch.arange(c, dtype=torch.int32)[None]
    qt, xt, at, bt, mt = _t(q, x, alpha, beta, margin)
    args = (ids, qt[None], torch.tensor([thr]), at, bt, mt)
    plain = ops.fee_distance(xt, *args, seg=seg, backend="jnp")
    skip = ops.fee_distance(xt, *args, seg=seg, backend="pallas_skip_dma")
    cfg = dfl.make_config(d, [(16, 5, 24), (12, 4, 40)], x)
    packed = torch.from_numpy(dfl.pack_db(x, cfg).view(np.int32))
    tiers = [torch.from_numpy(t.view(np.int32)) for t in dfl.pack_tiers(x, cfg, 32)]
    tier_cfgs = dfl.split_config(cfg, 32)
    for backend in ("auto", "pallas_skip_dma"):
        pk = ops.fee_distance_packed(packed, *args, dfloat_cfg=cfg, seg=seg,
                                     backend=backend)
        tr = ops.fee_distance_tiered(*tiers, *args, coarse_cfg=tier_cfgs[0],
                                     resid_cfg=tier_cfgs[1], seg=seg, backend=backend)
        for a, b in zip(pk, tr):
            assert torch.equal(a, b)
        ops.dfloat_unpack_rows(packed, cfg, backend=backend)
    assert [k.launches for k in kernels] == before
    for a, b, s in zip(auto, plain, skip):
        assert torch.equal(a, b) and torch.equal(a, s)
    with pytest.raises(ValueError, match="backend"):
        ops.fee_distance(xt, *args, seg=seg, backend="pallas_dma")


@given(n_cases=8)
def test_block_spans_match_jax_block_positions(draw):
    """The skip-DMA packed kernel copies each FEE block's word span: the
    reference's ``_block_positions`` spans, carry words included."""
    from repro.kernels.fee_distance import _block_positions

    d = draw.choice([32, 64, 128], "d")
    seg = draw.choice([4, 8, 16], "seg")
    x = draw.array((8, d), scale=1.0)
    jcfg, cfg = _random_layout(draw, d, x)
    blocks, _ = _block_positions(jcfg, seg)
    assert fee_kernel.block_spans(cfg, seg) == [(w0, w1) for _, w0, w1 in blocks]


def test_skip_warps_fit_shared_memory():
    """Eight warps where their landing buffers fit a block's shared memory,
    fewer where they do not, and a refusal where not even one does."""
    assert fee_kernel.skip_warps(32 * 16 * 4) == 8                  # seg = 16
    per_warp = 32 * 512 * 4                                          # seg = 512
    assert fee_kernel.skip_warps(per_warp) == fee_kernel.SMEM_BLOCK_MAX // per_warp == 3
    assert fee_kernel.skip_warps(per_warp, fixed=per_warp) == 2
    with pytest.raises(ValueError, match="shared memory"):
        fee_kernel.skip_warps(fee_kernel.SMEM_BLOCK_MAX + 4)
