"""Tiered Dfloat storage in the port vs the JAX package.

The same numpy inputs go to both packages: the tier-split helpers of
``core.pca``, the ``Index`` tier surface (``tier_split``, ``tier_cfgs``,
``tier_arrays``) on an index carried across, the tiered FEE kernel's plain
version against the JAX oracle and the Pallas kernel in interpret mode, and
``storage="tiered"`` search.

Tolerances are those of ``test_torch_search.py`` and
``repro_torch.kernels.check``: distances within rtol 3e-5 / atol 2e-4, exits
and ``segs_used`` exact except near-threshold lanes, id overlap@10 >= 0.99,
recall within 0.005, counters (``n_resid`` included) equal on >= 95% of
queries.  Within the port, tiered ids and distances must equal packed ids and
distances exactly, at every split: ``split_config`` keeps every feature's
format.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.index as jix
from repro.core import dfloat as jdfl
from repro.core import pca as jpca
from repro.kernels import ref as jref
from repro.kernels.fee_distance import fee_distance_tiered_pallas
from repro_torch.core import dfloat as dfl
from repro_torch.core import pca as tpca
from repro_torch.data.synthetic import recall_at_k
from repro_torch.index import Index, SearchParams, SearchResult
from repro_torch.kernels import ops, ref
from repro_torch.kernels.check import compare_fee, near_threshold
from test_torch_search import _overlap, pair  # noqa: F401  (module fixture)

RTOL, ATOL = 3e-5, 2e-4
TIERED = SearchParams(ef=48, k=10, storage="tiered")


def _with_split(idx, split):
    """The same index (either package) with ``spec.tier_split = split`` and
    its tier and device caches dropped."""
    return dataclasses.replace(
        idx, spec=dataclasses.replace(idx.spec, tier_split=split), _tiers=None,
        _searchers={}, _device={})


def _same_cfg(a, b):
    return (tuple(map(dataclasses.astuple, a.segments)), a.burst_bits,
            a.devices_per_subchannel) == (tuple(map(dataclasses.astuple, b.segments)),
                                          b.burst_bits, b.devices_per_subchannel)


# ---------------------------------------------------------------------------
# pca tier helpers and the Index tier surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("decay,seg,energy", [(0.9, 16, 0.9), (0.3, 8, 0.9),
                                              (2.0, 16, 0.5), (0.0, 4, 0.99)])
def test_tier_split_helpers_exact(decay, seg, energy):
    eig = (np.arange(1, 129, dtype=np.float64) ** -decay).astype(np.float32)
    assert tpca.suggest_tier_split(eig, seg, energy) == \
        jpca.suggest_tier_split(eig, seg, energy)
    s = 128 // seg
    rng = np.random.default_rng(s)
    fit = dict(alpha=rng.random(s, np.float32), beta=rng.random(s, np.float32),
               margin=rng.random(s, np.float32), var_k=rng.random(s, np.float32),
               seg=seg, p_target=0.9, metric="l2")
    for split in range(s + 1):
        got, want = tpca.tier_fee(fit, split), jpca.tier_fee(fit, split)
        assert got["tier_split"] == want["tier_split"] == split
        for tier in ("coarse", "residual"):
            assert got[tier].keys() == want[tier].keys()
            for k, v in want[tier].items():
                assert np.array_equal(got[tier][k], v), (split, tier, k)
    for bad in (-1, s + 1):
        with pytest.raises(ValueError):
            tpca.tier_fee(fit, bad)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_tier_surface_bit_exact_on_carried_index(pair, metric):  # noqa: F811
    """``tier_split`` (auto and every explicit split), ``tier_cfgs`` and
    ``tier_arrays`` equal the JAX index's bit for bit — with the default
    ``tier_split=None`` too, where ``tier_arrays`` resolves the auto split."""
    _, ref_idx, port, *_ = pair[metric]
    n_segs = port.dim // port.seg
    assert port.spec.tier_split is None
    for a, b in zip(_with_split(port, None).tier_arrays(), ref_idx.tier_arrays()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for split in (None, *range(n_segs + 1)):
        p, j = _with_split(port, split), _with_split(ref_idx, split)
        assert p.tier_split == j.tier_split
        for a, b in zip(p.tier_cfgs(), j.tier_cfgs()):
            assert _same_cfg(a, b), split
        for a, b in zip(p.tier_arrays(), j.tier_arrays()):
            assert a.dtype == b.dtype and np.array_equal(a, b), split
    for bad in (-1, n_segs + 1):
        with pytest.raises(ValueError):
            _with_split(port, bad).tier_split


def test_residual_fetch_fraction_matches_jax():
    rng = np.random.default_rng(0)
    n_eval = rng.integers(0, 50, 20).astype(np.int32)
    n_resid = (n_eval * rng.random(20)).astype(np.int32)
    ids = np.zeros((20, 10), np.int32)
    for ne, nr in ((n_eval, n_resid), (n_eval * 0, n_resid * 0), (n_eval, None),
                   (None, n_resid)):
        got = SearchResult(ids=ids, dists=ids, n_eval=ne, n_resid=nr)
        want = jix.SearchResult(ids=ids, dists=ids, n_eval=ne, n_resid=nr)
        assert got.residual_fetch_fraction == want.residual_fetch_fraction


# ---------------------------------------------------------------------------
# the tiered FEE kernel's plain version at every split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_fee_distance_tiered_plain_vs_jax_every_split(metric):
    c, d, seg = 40, 64, 16
    rng = np.random.default_rng(11)
    x = rng.standard_normal((c, d)).astype(np.float32)
    runs = [(16, 5, 24), (12, 4, 40)]          # tier cuts fall inside each run
    jcfg, cfg = jdfl.make_config(d, runs, x), dfl.make_config(d, runs, x)
    xq = jdfl.unpack_db(jdfl.pack_db(x, jcfg), jcfg)
    q = x[3] + 0.3 * rng.standard_normal(d).astype(np.float32)
    s = d // seg
    alpha = (1.0 + 1.0 / np.arange(1, s + 1)).astype(np.float32)
    beta = (1.0 + 0.2 / np.arange(1, s + 1)).astype(np.float32)
    margin = (0.05 * rng.random(s)).astype(np.float32)
    thr = np.float32(np.median(((xq - q) ** 2).sum(1)) if metric == "l2"
                     else -np.median(xq @ q))
    near = near_threshold(xq, q, thr, alpha, beta, margin, seg=seg, metric=metric)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    ids = torch.arange(c, dtype=torch.int32)[None]
    common = (ids, t(q)[None], torch.tensor([thr]), t(alpha), t(beta), t(margin))
    mask = t(rng.random(c) < 0.8)[None]
    packed_np = dfl.pack_db(x, cfg)
    packed = ops.fee_distance_packed(t(packed_np.view(np.int32)), *common,
                                     dfloat_cfg=cfg, seg=seg, metric=metric,
                                     lane_mask=mask)
    for split in range(s + 1):
        nf = split * seg
        xc, xr = dfl.pack_tiers(x, cfg, nf)
        ccfg, rcfg = dfl.split_config(cfg, nf)
        jc, jr = jdfl.split_config(jcfg, nf)
        jargs = (jnp.asarray(q), jnp.asarray(xc), jnp.asarray(xr), jnp.float32(thr),
                 jnp.asarray(alpha), jnp.asarray(beta), jnp.asarray(margin))
        kw = dict(coarse_cfg=jc, resid_cfg=jr, seg=seg, metric=metric)
        oracle = jref.fee_distance_tiered_ref(*jargs, **kw)
        pallas = fee_distance_tiered_pallas(*jargs, **kw, tile_c=16)
        tiers = (t(xc.view(np.int32)), t(xr.view(np.int32)))
        got = ops.fee_distance_tiered(*tiers, *common, coarse_cfg=ccfg,
                                      resid_cfg=rcfg, seg=seg, metric=metric)
        plain = ref.fee_distance_tiered_ref(t(q), *tiers, thr, t(alpha), t(beta),
                                            t(margin), coarse_cfg=ccfg,
                                            resid_cfg=rcfg, seg=seg, metric=metric)
        for out in (got, plain):
            compare_fee(out, oracle, near, f"tiered split={split}")
            compare_fee(out, pallas, near, f"tiered split={split} vs pallas")
        # bit-identical to packed scoring of the parent rows, lane mask folded
        masked = ops.fee_distance_tiered(*tiers, *common, coarse_cfg=ccfg,
                                         resid_cfg=rcfg, seg=seg, metric=metric,
                                         lane_mask=mask)
        for a, b in zip(masked, packed):
            assert torch.equal(a, b), split
        # the tier pair decodes to the parent rows
        rows = ops.dfloat_unpack_tiered_rows(*tiers, ccfg, rcfg)
        assert np.array_equal(rows.numpy().view(np.uint32), xq.view(np.uint32))


# ---------------------------------------------------------------------------
# storage="tiered" search on a carried index
# ---------------------------------------------------------------------------

CASES = {
    "l2-e4-auto": ("l2", None, dict()),
    "l2-e4-split0": ("l2", 0, dict()),
    "l2-e4-splitS": ("l2", "S", dict()),
    "l2-e1-auto-trace": ("l2", None, dict(expand=1, trace=True)),
    "l2-e4-c1-split1-tomb": ("l2", 1, dict(compact=1.0, tomb=True)),
    "l2-e4-split2-nofee": ("l2", 2, dict(use_fee=False)),
    "ip-e4-auto": ("ip", None, dict()),
    "ip-e1-split0-trace": ("ip", 0, dict(expand=1, trace=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tiered_search_matches_jax(pair, case):  # noqa: F811
    metric, split, opts = CASES[case]
    db, ref_idx, port, ref_dead, port_dead, dead = pair[metric]
    tomb = opts.get("tomb", False)
    if tomb:
        ref_idx, port = ref_dead, port_dead
    if split == "S":
        split = port.dim // port.seg
    ref_idx, port = _with_split(ref_idx, split), _with_split(port, split)
    params = dataclasses.replace(TIERED, **{k: v for k, v in opts.items()
                                            if k != "tomb"})
    want = ref_idx.search(db.queries, jix.SearchParams(**dataclasses.asdict(params)))
    got = port.search(db.queries, params)

    assert got.ids.shape == want.ids.shape
    assert _overlap(got.ids, want.ids) >= 0.99
    assert abs(recall_at_k(got.ids, db.gt, 10)
               - recall_at_k(want.ids, db.gt, 10)) <= 0.005
    for gi, gd, wi, wd in zip(got.ids, got.dists, want.ids, want.dists):
        shared = np.intersect1d(gi[gi >= 0], wi[wi >= 0])
        g = dict(zip(gi.tolist(), gd.tolist()))
        w = dict(zip(wi.tolist(), wd.tolist()))
        np.testing.assert_allclose([g[i] for i in shared], [w[i] for i in shared],
                                   rtol=RTOL, atol=ATOL)
    for key in ("hops", "n_eval", "dims", "n_resid"):
        assert np.mean(getattr(got, key) == getattr(want, key)) >= 0.95, key
    assert abs(got.residual_fetch_fraction - want.residual_fetch_fraction) <= 0.01
    n_segs = port.dim // port.seg
    if port.tier_split == 0 and params.use_fee:
        assert got.residual_fetch_fraction == 1.0
    if port.tier_split == n_segs:
        assert got.residual_fetch_fraction == 0.0
    if tomb:
        assert not np.isin(got.ids, dead).any()
    if params.trace:
        segs = got.trace["segs"]
        assert np.array_equal(got.n_resid, (segs > port.tier_split).sum(axis=(1, 2)))
        assert np.array_equal(got.n_eval, (segs > 0).sum(axis=(1, 2)))
        same = (got.trace["nbrs"] == want.trace["nbrs"]).all((1, 2))
        assert same.mean() >= 0.95
    packed = port.search(db.queries, dataclasses.replace(params, storage="packed"))
    assert np.array_equal(got.ids, packed.ids)
    assert np.array_equal(got.dists, packed.dists)


# ---------------------------------------------------------------------------
# tier-native artifacts both ways
# ---------------------------------------------------------------------------


def test_tiered_artifacts_load_both_ways(pair, tmp_path):  # noqa: F811
    db, ref_idx, port, *_ = pair["l2"]
    port2, ref2 = _with_split(port, 2), _with_split(ref_idx, 1)
    port2.save(tmp_path / "port")
    ref2.save(tmp_path / "jax")
    in_jax = jix.Index.load(tmp_path / "port")
    in_port = Index.load(tmp_path / "jax", device="cpu")
    assert in_jax.tier_split == 2 and in_port.tier_split == 1
    assert in_jax._tiers is not None and in_port._tiers is not None   # persisted
    for a, b in zip(in_jax.tier_arrays(), port2.tier_arrays()):
        assert np.array_equal(a, b)
    for a, b in zip(in_port.tier_arrays(), ref2.tier_arrays()):
        assert np.array_equal(a, b)
    q = db.queries[:16]
    assert np.array_equal(in_port.search(q, TIERED).ids,
                          port.search(q, dataclasses.replace(TIERED, storage="packed")).ids)
