"""The parts of the port's LM stack against the JAX package's, one function
at a time: chunked attention across q and kv chunks, the decode partials and
their merge over stacked shards, RoPE and RMSNorm in float32 and bfloat16,
the SSD scan over 1, 2 and 4 chunks, the Mamba-2 mixer's decode step, the
cross-entropy, and the weight conversion and initialiser.

Inputs are seeded numpy arrays handed to both packages.  Tolerance: the
largest difference under 1e-4 of the largest |value| in float32; in
bfloat16, RoPE and RMSNorm round once at the end, so at most one bfloat16
step (2**-7) of the largest |value|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import attention as jatt
from repro.models import common as jcommon
from repro.models import mamba2 as jm2
from repro.models.registry import get_model as jget_model
from repro_torch import configs as C
from repro_torch.models import attention as att
from repro_torch.models import common
from repro_torch.models import convert
from repro_torch.models import get_model
from repro_torch.models import mamba2 as m2

TOL = 1e-4
BF16_STEP = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(port, ref) -> float:
    a = port.float().numpy()
    b = np.asarray(jnp.asarray(ref, jnp.float32))
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("causal,kv_len,q_offset", [
    (True, None, 0), (False, None, 0), (True, 1500, 0), (False, 700, 0),
    (True, None, 1024), (True, 1800, 512)])
def test_chunked_attention_matches_jax(causal, kv_len, q_offset):
    """t = 1024 in two q chunks of 512, s = 2048 in two kv chunks of 1024."""
    rng = np.random.default_rng(0)
    q, k, v = normal(rng, (1, 1024, 4, 16)), normal(rng, (1, 2048, 2, 16)), \
        normal(rng, (1, 2048, 2, 16))
    ref = jatt.chunked_attention(*map(jnp.asarray, (q, k, v)), causal=causal, kv_len=kv_len,
                                 q_offset=q_offset)
    out = att.chunked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                causal=causal, kv_len=kv_len, q_offset=q_offset)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert rel(out, ref) < TOL


def test_chunked_attention_refuses_ragged_chunks_like_jax():
    q = np.zeros((1, 600, 2, 8), np.float32)
    with pytest.raises(AssertionError):
        jatt.chunked_attention(*(jnp.asarray(q),) * 3, causal=True)
    with pytest.raises(AssertionError):
        att.chunked_attention(*(torch.from_numpy(q),) * 3, causal=True)


def test_decode_partials_merged_over_shards_match_jax():
    """A KV cache of 4 x 96 positions split into 4 shards: each shard's
    partial, then the merge (the reference's under ``jax.vmap`` over a named
    axis, the port's over the stacked axis) and the unsharded result."""
    rng = np.random.default_rng(1)
    c, b, sl, h, kk, dh = 4, 2, 96, 8, 2, 16
    q = normal(rng, (b, h, dh))
    k, v = normal(rng, (c, b, sl, kk, dh)), normal(rng, (c, b, sl, kk, dh))
    valid = rng.random((c, b, sl)) < 0.8

    def shard(k_, v_, m_):
        o, m, l = jatt.decode_attention_partial(q, k_, v_, m_)
        return jatt.merge_partials(o, m, l, "s")

    ref = jax.vmap(shard, axis_name="s")(k, v, valid)[0]
    parts = [att.decode_attention_partial(torch.from_numpy(q), torch.from_numpy(k[i]),
                                          torch.from_numpy(v[i]), torch.from_numpy(valid[i]))
             for i in range(c)]
    jparts = [jatt.decode_attention_partial(q, k[i], v[i], valid[i]) for i in range(c)]
    for p, jp in zip(parts, jparts):
        for a, ja in zip(p, jp):
            assert rel(a, ja) < TOL
    out = att.merge_partials(*(torch.stack(xs) for xs in zip(*parts)), dim=0)
    assert rel(out, ref) < TOL
    # one shard holding the whole cache gives the same answer
    whole = att.decode_attention_partial(
        torch.from_numpy(q), torch.from_numpy(k.transpose(1, 0, 2, 3, 4).reshape(b, -1, kk, dh)),
        torch.from_numpy(v.transpose(1, 0, 2, 3, 4).reshape(b, -1, kk, dh)),
        torch.from_numpy(valid.transpose(1, 0, 2).reshape(b, -1)))
    assert rel(whole[0] / whole[2][..., None], ref) < TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_and_rms_norm_match_jax(dtype):
    rng = np.random.default_rng(2)
    x = normal(rng, (2, 12, 4, 32)) * 3
    w = normal(rng, (32,))
    pos = np.arange(12, dtype=np.int32)[None] + 5
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tol = TOL if dtype == "float32" else BF16_STEP
    ref = jcommon.rope(jx, pos, 5e5)
    out = common.rope(tx, torch.from_numpy(pos), 5e5)
    assert out.dtype == tx.dtype and rel(out, ref) < tol
    jw, tw = jnp.asarray(w, dtype), torch.from_numpy(w).to(getattr(torch, dtype))
    ref = jcommon.rms_norm(jx, jw, 1e-5)
    out = common.rms_norm(tx, tw, 1e-5)
    assert out.dtype == tx.dtype and rel(out, ref) < tol
    # a float32 weight on bfloat16 activations: computed in float32, cast back
    ref = jcommon.rms_norm(jx, jnp.asarray(w), 1e-5)
    out = common.rms_norm(tx, torch.from_numpy(w), 1e-5)
    assert out.dtype == tx.dtype and rel(out, ref) < tol


@pytest.mark.parametrize("n_chunks", [1, 2, 4])
def test_ssd_chunked_matches_jax(n_chunks):
    rng = np.random.default_rng(3)
    b, t, h, dh, s = 2, 32, 3, 8, 6
    x, bb, cc = normal(rng, (b, t, h, dh)), normal(rng, (b, t, s)), normal(rng, (b, t, s))
    dt = np.abs(normal(rng, (b, t, h))) * 0.5 + 0.05
    a_log = normal(rng, (h,)) * 0.3
    y, state = jm2.ssd_chunked(x, dt, a_log, bb, cc, t // n_chunks)
    ty, tstate = m2.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, a_log, bb, cc)),
                                t // n_chunks)
    assert ty.dtype == tstate.dtype == torch.float32
    assert rel(ty, y) < TOL and rel(tstate, state) < TOL


def test_mamba2_mixer_prefill_and_decode_match_jax():
    """A prompt of 12 (chunk 8 falls to the largest divisor, 6), then 3
    decode steps carrying the conv window and the SSM state."""
    jcfg, cfg = JC.get_smoke("mamba2-780m"), C.get_smoke("mamba2-780m")
    jp = jm2.init_mamba2(jax.random.key(4), jcfg, jnp.float32)
    jp = dict(jp, dt_bias=jnp.full_like(jp["dt_bias"], 0.3), a_log=jnp.full_like(jp["a_log"], -0.5))
    p = convert._module(jax.device_get(jp), "cpu")
    x = normal(np.random.default_rng(4), (2, 15, cfg.d_model))
    y, (conv, ssm) = jm2.mamba2_mixer(x[:, :12], jp, jcfg)
    ty, (tconv, tssm) = m2.mamba2_mixer(torch.from_numpy(x[:, :12]), p, cfg)
    for a, b in ((ty, y), (tconv, conv), (tssm, ssm)):
        assert rel(a, b) < TOL
    for s in range(12, 15):
        y, (conv, ssm) = jm2.mamba2_mixer(x[:, s:s + 1], jp, jcfg, conv_state=conv,
                                          ssm_state=ssm, decode=True)
        ty, (tconv, tssm) = m2.mamba2_mixer(torch.from_numpy(x[:, s:s + 1]), p, cfg,
                                            conv_state=tconv, ssm_state=tssm, decode=True)
        for a, b in ((ty, y), (tconv, conv), (tssm, ssm)):
            assert rel(a, b) < TOL


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(5)
    logits = normal(rng, (3, 7, 50)) * 4
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    ref = jcommon.cross_entropy(logits, labels, mask)
    out = common.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                               None if mask is None else torch.from_numpy(mask))
    assert abs(float(out) - float(ref)) < TOL * abs(float(ref))


@pytest.mark.parametrize("arch,dtype", [("llama3.2-1b", "float32"), ("llama3.2-1b", "bfloat16"),
                                        ("jamba-1.5-large-398b", "bfloat16"),
                                        ("qwen2-72b", "float32"), ("whisper-base", "bfloat16")])
def test_from_jax_params_round_trips(arch, dtype):
    jcfg = dataclasses.replace(JC.get_smoke(arch), dtype=jnp.dtype(dtype))
    cfg = dataclasses.replace(C.get_smoke(arch), dtype=getattr(torch, dtype))
    tree = jax.device_get(jget_model(jcfg).init(jax.random.key(7)))
    params = convert.from_jax_params(cfg, tree, "cpu")
    back = convert.params_to_numpy(cfg, params)
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat.keys() == flat_back.keys()
    for path, a in flat.items():
        b = flat_back[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8)), path
    # the uint16 view of the bfloat16 leaves carries across too
    if dtype == "bfloat16":
        bits = jax.tree.map(lambda a: a.view(np.uint16) if a.dtype.name == "bfloat16" else a, tree)
        again = convert.params_to_numpy(cfg, convert.from_jax_params(cfg, bits, "cpu"))
        for path, a in dict(jax.tree_util.tree_flatten_with_path(again)[0]).items():
            assert np.array_equal(np.asarray(a).view(np.uint8),
                                  np.asarray(flat[path]).view(np.uint8)), path


def test_uinit_scales():
    """Each weight drawn by the port's initialiser has the std of its scale
    (within 5%); norms are ones and biases zeros, as the reference's."""
    cfg = dataclasses.replace(C.get_smoke("qwen2-moe-a2.7b"), n_layers=1)
    params = get_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    d, f, dh, h = cfg.d_model, cfg.d_ff, cfg.head_dim, cfg.n_heads
    blk = params.blocks[0]
    scales = {"embed": (params.embed, 0.02), "head": (params.head, d ** -0.5),
              "wq": (blk.attn.wq, d ** -0.5), "wo": (blk.attn.wo, (h * dh) ** -0.5),
              "router": (blk.moe.router, d ** -0.5), "moe.wo": (blk.moe.wo, f ** -0.5),
              "shared_wo": (blk.moe.shared_wo, (f * cfg.moe_shared_experts) ** -0.5)}
    for name, (w, scale) in scales.items():
        assert abs(float(w.float().std()) / scale - 1) < 0.05, name
    assert blk.moe.router.dtype == torch.float32
    assert torch.equal(blk.norm1, torch.ones(d)) and torch.equal(blk.attn.bq, torch.zeros(h * dh))
    # bfloat16 weights are the float32 draw rounded once
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    w32 = common.uinit(g1, (64, 64), 0.1, torch.float32)
    w16 = common.uinit(g2, (64, 64), 0.1, torch.bfloat16)
    assert torch.equal(w32.to(torch.bfloat16), w16)


def test_abstract_params_allocate_nothing():
    api = get_model(C.get_config("llama3.2-1b"), "cpu")
    params = api.abstract_params()
    assert all(p.device.type == "meta" for p in params.parameters())
    assert params.embed.shape == (128256, 2048) and params.embed.dtype == torch.bfloat16
    cache = api.abstract_cache(4, 96)
    assert cache["layers"][0]["k"].shape == (4, 96, 8, 64)
    assert cache["layers"][0]["k"].device.type == "meta"
