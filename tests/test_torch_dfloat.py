"""Port Dfloat layer vs the JAX package's, bit for bit: configs, emulation,
packed words, burst layouts, feature positions, the Algorithm-1 config search
and the torch decoder (including exponent biases above 127, where the
decoder relies on 32-bit wraparound)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from proptest import given
from repro.core import dfloat as jdfl
from repro_torch.core import dfloat as dfl


def _key(cfg):
    return ([dataclasses.astuple(s) for s in cfg.segments], cfg.burst_bits,
            cfg.devices_per_subchannel)


def _layout_key(layout):
    return [(dataclasses.astuple(s), w, nb, per) for s, w, nb, per in layout]


def _u32(a):
    return np.asarray(a).view(np.uint32)


def _runs(draw, d):
    widths = sorted({draw.choice(list(dfl.WIDTH_PALETTE), f"w{i}")
                     for i in range(draw.integers(1, 3, "nseg"))}, reverse=True)
    runs, left = [], d
    for i, w in enumerate(widths):
        nd = left if i == len(widths) - 1 else draw.integers(1, left - (len(widths) - i - 1), f"n{i}")
        runs.append((w, dfl.EXP_BITS[w], nd))
        left -= nd
    return runs


@given(n_cases=15)
def test_host_layer_bit_exact(draw):
    d = draw.choice([32, 64, 100, 128], "d")
    n = draw.integers(3, 60, "n")
    x = draw.array((n, d), scale=np.exp(draw.floats(-4, 4, "logscale")))
    runs = _runs(draw, d)
    jcfg, cfg = jdfl.make_config(d, runs, x), dfl.make_config(d, runs, x)
    assert _key(jcfg) == _key(cfg)
    assert _layout_key(jdfl.burst_layout(jcfg)[0]) == _layout_key(dfl.burst_layout(cfg)[0])
    jpos, jw = jdfl.feature_positions(jcfg)
    pos, w = dfl.feature_positions(cfg)
    assert jw == w and [(a, b, dataclasses.astuple(s)) for a, b, s in jpos] == \
        [(a, b, dataclasses.astuple(s)) for a, b, s in pos]
    packed = dfl.pack_db(x, cfg)
    assert np.array_equal(packed, jdfl.pack_db(x, jcfg))
    em = dfl.emulate_db(x, cfg)
    assert np.array_equal(_u32(em), _u32(jdfl.emulate_db(x, jcfg)))
    assert np.array_equal(_u32(dfl.unpack_db(packed, cfg)), _u32(em))
    # the torch paths: emulation on tensors, and the decoder
    xt = torch.from_numpy(x)
    assert dfl.make_config(d, runs, xt) == cfg
    assert np.array_equal(_u32(dfl.emulate_db(xt, cfg).numpy()), _u32(em))
    got = dfl.unpack_rows(torch.from_numpy(packed.view(np.int32)), cfg)
    assert np.array_equal(_u32(got.numpy()), _u32(em))


def test_torch_decoder_matches_jax_decoder():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((50, 96)) * 3).astype(np.float32)
    runs = [(24, 8, 20), (18, 6, 40), (12, 4, 36)]
    jcfg, cfg = jdfl.make_config(96, runs, x), dfl.make_config(96, runs, x)
    packed = jdfl.pack_db(x, jcfg)
    got = dfl.unpack_rows(torch.from_numpy(packed.view(np.int32)), cfg)
    assert np.array_equal(_u32(got.numpy()),
                          _u32(jdfl.unpack_rows_jnp(jnp.asarray(packed), jcfg)))


def test_decoder_bias_above_127_and_zero_fields():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((40, 32)) * 1e-30).astype(np.float32)
    x[::7, 3] = 0.0                               # zero fields stay zero
    x[::5, 9] = -x[::5, 9]
    biases = []
    for runs in ([(32, 8, 32)], [(21, 6, 16), (14, 5, 16)], [(12, 4, 32)]):
        jcfg, cfg = jdfl.make_config(32, runs, x), dfl.make_config(32, runs, x)
        assert _key(jcfg) == _key(cfg)
        biases += [s.bias for s in cfg.segments]
        packed = jdfl.pack_db(x, jcfg)
        want = jdfl.unpack_db(packed, jcfg)
        for words in (torch.from_numpy(packed.view(np.int32)), torch.from_numpy(packed)):
            assert np.array_equal(_u32(dfl.unpack_rows(words, cfg).numpy()), _u32(want))
    assert max(biases) > 127           # data near 1e-30 pushes the 8-bit bias up
    # an explicit bias far above 127 on a hand-made layout
    seg = dfl.DfloatSegment(0, 8, 5, 10, 200)
    jseg = jdfl.DfloatSegment(0, 8, 5, 10, 200)
    fld = rng.integers(0, 1 << 16, (10, 8)).astype(np.uint32)
    want = jdfl.decode_fields(fld, 5, 10, 200)
    got = dfl.decode_field_t(torch.from_numpy(fld.astype(np.int64)), seg.n_exp,
                             seg.n_man, seg.bias)
    assert np.array_equal(_u32(got.numpy()), _u32(want))
    assert np.array_equal(_u32(jdfl.decode_field_jnp(jnp.asarray(fld), jseg.n_exp,
                                                     jseg.n_man, jseg.bias)),
                          _u32(want))


def test_search_config_matches_reference():
    rng = np.random.default_rng(1)
    scale = np.linspace(3.0, 0.05, 64).astype(np.float32)
    db = (rng.standard_normal((400, 64)) * scale).astype(np.float32)
    q = db[:16] + 0.1 * rng.standard_normal((16, 64)).astype(np.float32)

    def recall_np(emul):
        d = ((q[:, None, :] - np.asarray(emul)[None]) ** 2).sum(-1)
        gt = np.argsort(((q[:, None, :] - db[None]) ** 2).sum(-1), 1)[:, :10]
        top = np.argsort(d, 1)[:, :10]
        return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(top, gt)])

    jcfg, jlog = jdfl.search_config(db, recall_np, 0.9)
    cfg, log = dfl.search_config(torch.from_numpy(db),
                                 lambda e: recall_np(e.numpy()), 0.9)
    assert _key(cfg) == _key(jcfg)
    assert log == jlog
    assert cfg.bursts_per_vector() < dfl.fp32_config(64).bursts_per_vector()
