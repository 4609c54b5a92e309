"""The port's LM stack (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package's, architecture by architecture.

For each of the 10 ``SMOKE`` configs the reference is initialised with
``jax.random.key(0)``, its weights carried across with
``models/convert.py::from_jax_params`` and both packages get the same
seeded numpy inputs: ``lm_forward`` (``encdec_forward`` for whisper)
logits and aux, the loss, prefill (the last logits and every cache array,
through ``cache_to_numpy``) and 6 decode steps.  Tolerance in float32: the
largest difference under 1e-4 of the largest |logit| (|value| for cache
arrays); cache positions equal.  The reference's functions are run once
per architecture (a module-scoped cache).

bfloat16 (llama and qwen2-moe): both packages round every matmul output to
bfloat16 but accumulate in other orders, so logits differ by about one
bfloat16 step of the largest logit (0.8-1.2e-2 measured on the smoke
configs): the bound is 3e-2.  For the MoE model, bfloat16 rounding flips
near-tied top-k choices, and a flipped choice shifts its expert's capacity
positions: the bound holds on at least 3/4 of the positions, and the median
position is under 2e-2.

Also here: the reference tests of ``tests/test_models.py`` restated on the
port, a MoE case whose capacity drops tokens (the same (token, choice)
pairs dropped), and the write past the cache, which the reference clamps
onto the last slot and the port refuses.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.models import whisper as jwh
from repro.models.registry import get_model as jget_model
from repro_torch import configs as C
from repro_torch.models import get_model
from repro_torch.models import moe
from repro_torch.models import transformer as tr
from repro_torch.models import whisper as wh
from repro_torch.models import convert
from repro_torch.models.convert import cache_to_numpy, from_jax_params
from repro_torch.utils import param_count

ARCHS = list(C.ARCHS)
TOL = 1e-4
BF16_TOL = 3e-2
B, T, PROMPT, STEPS = 2, 16, 8, 6
ENC_LEN = 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small models: run torch on one thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(port, ref) -> float:
    """Largest difference over the largest |ref|."""
    a = port.float().numpy() if isinstance(port, torch.Tensor) else np.asarray(port, np.float32)
    b = np.asarray(ref, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def tree_rel(port: dict, ref: dict) -> dict:
    """``rel`` of every array of two nested dicts, by path."""
    out = {}
    for k, v in ref.items():
        if isinstance(v, dict):
            out.update({f"{k}/{p}": e for p, e in tree_rel(port[k], v).items()})
        else:
            out[k] = rel(port[k], v)
    return out


def t(a, dtype=None):
    x = torch.from_numpy(np.asarray(a))
    return x.long() if x.dtype == torch.int32 and dtype is None else x


def inputs(cfg, seed=0):
    """Seeded numpy inputs: tokens, labels, and frames or patch embeddings."""
    rng = np.random.default_rng(seed)
    out = dict(tokens=rng.integers(0, cfg.vocab, (B, T)).astype(np.int32),
               labels=rng.integers(0, cfg.vocab, (B, T)).astype(np.int32))
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal((B, ENC_LEN, cfg.d_model)).astype(np.float32)
    elif cfg.frontend == "vision":
        out["prefix_embeds"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def run_reference(jcfg, seed=0, key=0):
    """The reference's forward, loss, prefill and decode outputs (numpy)."""
    api = jget_model(jcfg)
    params = api.init(jax.random.key(key))
    x = inputs(jcfg, seed)
    out = dict(tree=jax.device_get(params), x=x)
    if jcfg.is_encdec:
        out["logits"] = jax.jit(jwh.encdec_forward, static_argnums=3)(
            params, x["frames"], x["tokens"], jcfg)
        out["loss"] = jax.jit(api.loss)(params, x)[0]
        logits, cache = jax.jit(api.prefill, static_argnums=2)(
            params, dict(frames=x["frames"]), 0)
        feed = x["tokens"][:, :STEPS]
    else:
        pre = x.get("prefix_embeds")
        out["logits"], out["aux"] = jax.jit(jtr.lm_forward, static_argnums=2)(
            params, x["tokens"], jcfg, prefix_embeds=pre)
        out["loss"] = jax.jit(api.loss)(params, x)[0]
        prompt = dict(tokens=x["tokens"][:, :PROMPT])
        if pre is not None:
            prompt["prefix_embeds"] = pre
        logits, cache = jax.jit(api.prefill, static_argnums=2)(params, prompt, kv_len(jcfg))
        feed = x["tokens"][:, PROMPT:PROMPT + STEPS]
    out["prefill"], out["prefill_cache"] = logits, jax.device_get(cache)
    decode = jax.jit(api.decode)
    out["decode"] = []
    for s in range(STEPS):
        logits, cache = decode(params, cache, feed[:, s])
        out["decode"].append(np.asarray(logits))
    out["decode_cache"] = jax.device_get(cache)
    out["feed"] = feed
    return jax.device_get(out)


def kv_len(cfg):
    return PROMPT + STEPS + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)


def run_port(cfg, ref):
    """The port's outputs for the reference's weights and inputs."""
    api = get_model(cfg, "cpu")
    params = from_jax_params(cfg, ref["tree"], "cpu")
    x = ref["x"]
    out = {}
    with torch.no_grad():
        if cfg.is_encdec:
            out["logits"] = wh.encdec_forward(params, t(x["frames"]), t(x["tokens"]), cfg)
            out["loss"] = api.loss(params, {k: t(v) for k, v in x.items()})[0]
            logits, cache = api.prefill(params, dict(frames=t(x["frames"])), 0)
        else:
            pre = x.get("prefix_embeds")
            out["logits"], out["aux"] = tr.lm_forward(
                params, t(x["tokens"]), cfg, prefix_embeds=None if pre is None else t(pre))
            out["loss"] = api.loss(params, {k: t(v) for k, v in x.items()})[0]
            prompt = dict(tokens=t(x["tokens"][:, :PROMPT]))
            if pre is not None:
                prompt["prefix_embeds"] = t(pre)
            logits, cache = api.prefill(params, prompt, kv_len(cfg))
    out["prefill"], out["prefill_cache"] = logits, cache_to_numpy(cfg, cache)
    out["decode"] = []
    for s in range(STEPS):
        logits, cache = api.decode(params, cache, t(ref["feed"][:, s]))
        out["decode"].append(logits)
    out["decode_cache"] = cache_to_numpy(cfg, cache)
    return out


@pytest.fixture(scope="module")
def runs():
    """Reference and port outputs per architecture, each computed once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            ref = run_reference(JC.get_smoke(arch))
            cache[arch] = (ref, run_port(C.get_smoke(arch), ref))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(runs, arch):
    ref, port = runs(arch)
    assert port["logits"].shape == ref["logits"].shape
    assert port["logits"].dtype == torch.float32
    assert rel(port["logits"], ref["logits"]) < TOL
    if "aux" in ref:
        assert abs(float(port["aux"]) - float(ref["aux"])) <= TOL * max(1.0, abs(float(ref["aux"])))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(runs, arch):
    ref, port = runs(arch)
    assert abs(float(port["loss"]) - float(ref["loss"])) < TOL * float(ref["loss"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_jax(runs, arch):
    ref, port = runs(arch)
    assert rel(port["prefill"], ref["prefill"]) < TOL
    assert int(port["prefill_cache"]["pos"]) == int(ref["prefill_cache"]["pos"])
    errs = tree_rel(port["prefill_cache"], ref["prefill_cache"])
    assert max(errs.values()) < TOL, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(runs, arch):
    ref, port = runs(arch)
    errs = [rel(p, r) for p, r in zip(port["decode"], ref["decode"])]
    assert max(errs) < TOL, errs
    assert int(port["decode_cache"]["pos"]) == int(ref["decode_cache"]["pos"])
    cache_errs = tree_rel(port["decode_cache"], ref["decode_cache"])
    assert max(cache_errs.values()) < TOL, cache_errs
    for path, a in _leaves(port["decode_cache"]):     # the smoke configs are float32
        assert a.dtype == np.float32, path


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        elif k != "pos":
            yield prefix + k, v


def test_whisper_encoder_and_cross_kv_match_jax():
    jcfg, cfg = JC.get_smoke("whisper-base"), C.get_smoke("whisper-base")
    jp = jget_model(jcfg).init(jax.random.key(1))
    params = from_jax_params(cfg, jax.device_get(jp), "cpu")
    frames = np.random.default_rng(1).standard_normal((B, ENC_LEN, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        assert rel(wh.encode(params, t(frames), cfg), jwh.encode(jp, frames, jcfg)) < TOL
        cache = wh.prefill_cross(params, t(frames),
                                 wh.init_encdec_cache(params, cfg, B, ENC_LEN), cfg)
    jcache = jwh.prefill_cross(jp, frames, jwh.init_encdec_cache(jp, jcfg, B, ENC_LEN), jcfg)
    for k in ("cross_k", "cross_v"):
        assert rel(cache[k], jcache[k]) < TOL


def _bf16(arch):
    return (dataclasses.replace(JC.get_smoke(arch), dtype=jnp.bfloat16),
            dataclasses.replace(C.get_smoke(arch), dtype=torch.bfloat16))


def test_bf16_llama_matches_jax():
    jcfg, cfg = _bf16("llama3.2-1b")
    ref = run_reference(jcfg)
    port = run_port(cfg, ref)
    assert port["logits"].dtype == torch.bfloat16 and port["prefill"].dtype == torch.bfloat16
    assert rel(port["logits"], ref["logits"]) < BF16_TOL
    assert rel(port["prefill"], ref["prefill"]) < BF16_TOL
    assert max(rel(p, r) for p, r in zip(port["decode"], ref["decode"])) < BF16_TOL
    for path, a in _leaves(port["decode_cache"]):
        assert a.dtype.name == "bfloat16", path


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-1.5-large-398b", "whisper-base"])
def test_bf16_output_and_cache_dtypes_match_jax(arch):
    """Logits in the model's dtype; K/V and conv states too, the SSM state in
    float32: leaf for leaf the reference's dtypes."""
    jcfg, cfg = _bf16(arch)
    ref = run_reference(jcfg)
    port = run_port(cfg, ref)
    for key in ("logits", "prefill"):
        assert port[key].dtype == torch.bfloat16, key
        assert np.asarray(ref[key]).dtype.name == "bfloat16", key
    ref_leaves = dict(_leaves(ref["decode_cache"]))
    for path, a in _leaves(port["decode_cache"]):
        assert a.dtype.name == np.asarray(ref_leaves[path]).dtype.name, path


def test_bf16_moe_matches_jax_on_most_positions():
    jcfg, cfg = _bf16("qwen2-moe-a2.7b")
    ref = run_reference(jcfg)
    port = run_port(cfg, ref)
    a, b = port["logits"].float().numpy(), np.asarray(ref["logits"], np.float32)
    per_pos = np.abs(a - b).max(-1) / np.abs(b).max()
    assert (per_pos < BF16_TOL).mean() >= 0.75, per_pos
    assert np.median(per_pos) < 2e-2, per_pos


# --- the reference's own tests, restated on the port -------------------------


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-moe-a2.7b",
                                  "mamba2-780m", "jamba-1.5-large-398b"])
def test_prefill_decode_matches_forward(arch):
    cfg = dataclasses.replace(C.get_smoke(arch), capacity_factor=8.0, dtype=torch.float32)
    api = get_model(cfg, "cpu")
    params = api.init(api.generator(2))
    toks = t(np.random.default_rng(2).integers(0, cfg.vocab, (2, 12)))
    with torch.no_grad():
        full, _ = tr.lm_forward(params, toks, cfg)
    _, cache = api.prefill(params, dict(tokens=toks[:, :6]), 12)
    for s in range(6, 12):
        logits, cache = api.decode(params, cache, toks[:, s])
    assert rel(logits, full[:, -1].numpy()) < 5e-4


def test_whisper_decode_consistency():
    cfg = C.get_smoke("whisper-base")
    api = get_model(cfg, "cpu")
    params = api.init(api.generator(3))
    rng = np.random.default_rng(3)
    frames = t(rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32))
    toks = t(rng.integers(0, cfg.vocab, (2, 8)))
    with torch.no_grad():
        full = wh.encdec_forward(params, frames, toks, cfg)
        cache = wh.prefill_cross(params, frames, wh.init_encdec_cache(params, cfg, 2, 24), cfg)
    for s in range(8):
        logits, cache = api.decode(params, cache, toks[:, s])
    assert rel(logits, full[:, -1].numpy()) < 5e-4


def test_param_count_formula_close():
    for arch in ("llama3.2-1b", "qwen2-moe-a2.7b", "mamba2-780m"):
        cfg = C.get_smoke(arch)
        actual = param_count(get_model(cfg, "cpu").abstract_params())
        assert abs(actual - cfg.param_count()) / actual < 0.05, (arch, actual)
    full = C.get_config("llama3.2-1b")
    assert param_count(get_model(full, "cpu").abstract_params()) == full.param_count() \
        == 1_235_814_400


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_jax(arch):
    from repro.utils import tree_params

    for get in (C.get_smoke, C.get_config):
        cfg = get(arch)
        jcfg = (JC.get_smoke if get is C.get_smoke else JC.get_config)(arch)
        assert param_count(get_model(cfg, "cpu").abstract_params()) == \
            tree_params(jget_model(jcfg).abstract_params())
        assert cfg.param_count() == jcfg.param_count()


def test_all_cells_defined():
    cells = C.cells(include_skipped=True)
    assert len(cells) == 40
    skipped = [(a, s) for a, s, ok, _ in cells if not ok]
    assert len(skipped) == 8      # long_500k for the 8 full-attention archs
    assert all(s == "long_500k" for _, s in skipped)
    assert [c[2] for c in cells].count(True) == 32
    assert cells == JC.cells(include_skipped=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_input_specs_match_jax(arch):
    for cfg, jcfg in ((C.get_config(arch), JC.get_config(arch)),
                      (C.get_smoke(arch), JC.get_smoke(arch))):
        fields, jfields = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
        fields.pop("dtype"), jfields.pop("dtype")
        assert fields == jfields
        assert str(cfg.dtype).split(".")[-1] == jnp.dtype(jcfg.dtype).name
    for name, shape in C.SHAPES.items():
        assert C.shape_applicable(cfg, name) == JC.shape_applicable(jcfg, name)
        specs = C.input_specs(C.get_config(arch), shape)
        jspecs = JC.input_specs(JC.get_config(arch), JC.SHAPES[name])
        assert specs.keys() == jspecs.keys()
        for k, v in specs.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == jspecs[k].shape
            assert str(v.dtype).split(".")[-1] == jnp.dtype(jspecs[k].dtype).name


# --- MoE capacity drops --------------------------------------------------------


def test_moe_capacity_drops_the_same_pairs_as_jax():
    """capacity_factor 0.5 drops about half of the (token, choice) pairs: the
    port keeps exactly the reference's pairs and its output matches."""
    arch = "qwen2-moe-a2.7b"
    jcfg = dataclasses.replace(JC.get_smoke(arch), capacity_factor=0.5)
    cfg = dataclasses.replace(C.get_smoke(arch), capacity_factor=0.5)
    jp = jmoe.init_moe(jax.random.key(4), jcfg, jnp.float32)
    p = convert._module(jax.device_get(jp), "cpu")
    x = np.random.default_rng(4).standard_normal((2, 16, cfg.d_model)).astype(np.float32)

    # the reference's routing, by its own formula
    e, k = jcfg.moe_experts, jcfg.moe_top_k
    probs = jax.nn.softmax(jnp.einsum("nd,de->ne", x.reshape(-1, cfg.d_model), jp["router"]))
    _, top_e = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(top_e, e, dtype=jnp.int32)
    flat = onehot.reshape(-1, e)
    pos = ((jnp.cumsum(flat, 0) - flat).reshape(-1, k, e) * onehot).sum(-1)
    cap = max(1, int(jcfg.capacity_factor * k * x.shape[0] * x.shape[1] / e))
    ref_keep = np.asarray(pos < cap)

    _, _, port_e, port_pos, port_keep, port_cap = moe.route(
        t(x).reshape(1, -1, cfg.d_model), p.router, cfg)
    assert port_cap == cap
    assert np.array_equal(port_e[0].numpy(), np.asarray(top_e))
    assert np.array_equal(port_pos[0].numpy(), np.asarray(pos))
    assert np.array_equal(port_keep[0].numpy(), ref_keep)
    assert 0.25 < 1 - ref_keep.mean() < 0.75            # the case really drops
    y, aux = moe.moe_ffn(t(x), p, cfg)
    jy, jaux = jmoe.moe_ffn(x, jp, jcfg)
    assert rel(y, jy) < TOL
    assert abs(float(aux) - float(jaux)) < TOL * float(jaux)


def test_top_k_breaks_ties_like_jax():
    probs = np.array([[0.2, 0.3, 0.3, 0.1, 0.3, 0.0],
                      [0.25, 0.25, 0.25, 0.25, 0.0, 0.0]], np.float32)
    jv, je = jax.lax.top_k(probs, 4)
    v, e = moe.top_k(t(probs), 4)
    assert np.array_equal(e.numpy(), np.asarray(je))
    assert np.array_equal(v.numpy(), np.asarray(jv))


# --- writes past the cache -----------------------------------------------------


def test_decode_past_the_cache_raises_where_jax_clamps():
    """A cache of 8 slots after a 6-token prompt takes two steps.  The
    reference's third step writes into slot 7 again (``dynamic_update_slice``
    clamps its start), overwriting the second step's K; the port raises."""
    jcfg, cfg = JC.get_smoke("llama3.2-1b"), C.get_smoke("llama3.2-1b")
    japi, api = jget_model(jcfg), get_model(cfg, "cpu")
    jp = japi.init(jax.random.key(5))
    params = from_jax_params(cfg, jax.device_get(jp), "cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    _, jc = japi.prefill(jp, dict(tokens=toks[:, :6]), 8)
    _, cache = api.prefill(params, dict(tokens=t(toks[:, :6])), 8)
    for s in (6, 7):
        _, jc = japi.decode(jp, jc, toks[:, s])
        _, cache = api.decode(params, cache, t(toks[:, s]))
    k_before = np.asarray(jc["blocks"]["pos0"]["k"])[:, :, 7].copy()
    _, jc = japi.decode(jp, jc, toks[:, 8])
    k_after = np.asarray(jc["blocks"]["pos0"]["k"])[:, :, 7]
    assert int(jc["pos"]) == 9 and not np.array_equal(k_before, k_after)
    with pytest.raises(ValueError, match="past the cache"):
        api.decode(params, cache, t(toks[:, 8]))
    assert cache["pos"] == 8


def test_whisper_decode_past_the_window_raises_where_jax_clamps():
    jcfg, cfg = JC.get_smoke("whisper-base"), C.get_smoke("whisper-base")
    w = cfg.decoder_self_window
    japi, api = jget_model(jcfg), get_model(cfg, "cpu")
    jp = japi.init(jax.random.key(6))
    params = from_jax_params(cfg, jax.device_get(jp), "cpu")
    frames = np.random.default_rng(6).standard_normal((1, 8, cfg.d_model)).astype(np.float32)
    _, jc = japi.prefill(jp, dict(frames=frames), 0)
    _, cache = api.prefill(params, dict(frames=t(frames)), 0)
    decode = jax.jit(japi.decode)
    tok = np.zeros((1,), np.int32)
    for _ in range(w - 1):
        _, jc = decode(jp, jc, tok)
        _, cache = api.decode(params, cache, t(tok))
    assert cache["pos"] == int(jc["pos"]) == w
    last = np.asarray(jc["self_k"])[:, :, w - 1].copy()
    _, jc = decode(jp, jc, tok + 1)
    assert not np.array_equal(last, np.asarray(jc["self_k"])[:, :, w - 1])
    with pytest.raises(ValueError, match="past the cache"):
        api.decode(params, cache, t(tok + 1))


def test_prefill_longer_than_the_cache_raises():
    cfg = C.get_smoke("llama3.2-1b")
    api = get_model(cfg, "cpu")
    params = api.init(api.generator(0))
    with pytest.raises(ValueError, match="longer than the cache"):
        api.prefill(params, dict(tokens=torch.zeros((1, 9), dtype=torch.long)), 8)


def test_check_helpers_on_the_cpu():
    """``models/check.py`` (what the card's checks run): the same device gives
    no error, and decode agrees with forward."""
    from repro_torch.models.check import card_against_cpu, decode_against_forward

    errs = card_against_cpu(C.get_smoke("jamba-1.5-large-398b"), "cpu")
    assert errs == dict(forward=0.0, prefill=0.0, decode=0.0)
    api = get_model(C.get_smoke("llama3.2-1b"), "cpu")
    assert decode_against_forward(api, api.init(api.generator(0))) < 5e-4


def test_tr_prefill_cache_matches_jax():
    """The one-pass cache fill on its own (attention K/V, conv tail, SSM
    state), with a vision-free hybrid: jamba's attention and Mamba layers."""
    from repro.models.registry import tr_prefill_cache as jfill
    from repro_torch.models.registry import tr_prefill_cache

    jcfg, cfg = JC.get_smoke("jamba-1.5-large-398b"), C.get_smoke("jamba-1.5-large-398b")
    jp = jget_model(jcfg).init(jax.random.key(8))
    params = from_jax_params(cfg, jax.device_get(jp), "cpu")
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    ref = jfill(jp, dict(tokens=toks), jtr.init_cache(jcfg, 2, 12), jcfg)
    with torch.no_grad():
        cache = tr_prefill_cache(params, dict(tokens=t(toks)),
                                 tr.init_cache(cfg, 2, 12, device="cpu"), cfg)
    assert cache["pos"] == int(ref["pos"]) == 8
    errs = tree_rel(cache_to_numpy(cfg, cache), jax.device_get(ref))
    assert max(errs.values()) < TOL, errs


def test_scan_unroll_naive_attention_matches_jax():
    """``scan_unroll`` selects the unchunked attention in both packages."""
    jcfg = dataclasses.replace(JC.get_smoke("qwen3-8b"), scan_unroll=True)
    cfg = dataclasses.replace(C.get_smoke("qwen3-8b"), scan_unroll=True)
    jp = jget_model(jcfg).init(jax.random.key(9))
    params = from_jax_params(cfg, jax.device_get(jp), "cpu")
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    ref, _ = jtr.lm_forward(jp, toks, jcfg)
    with torch.no_grad():
        out, _ = tr.lm_forward(params, t(toks), cfg)
    assert rel(out, ref) < TOL


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "whisper-base"])
def test_decode_continues_from_a_jax_cache(arch):
    """``cache_from_jax``: the reference's prefill cache carried across, then
    3 decode steps in each package give the same logits and caches."""
    from repro_torch.models.convert import cache_from_jax

    jcfg, cfg = JC.get_smoke(arch), C.get_smoke(arch)
    japi, api = jget_model(jcfg), get_model(cfg, "cpu")
    jp = japi.init(jax.random.key(10))
    params = from_jax_params(cfg, jax.device_get(jp), "cpu")
    x = inputs(jcfg, 10)
    if cfg.is_encdec:
        _, jc = japi.prefill(jp, dict(frames=x["frames"]), 0)
    else:
        _, jc = japi.prefill(jp, dict(tokens=x["tokens"][:, :PROMPT]), PROMPT + 3)
    cache = cache_from_jax(cfg, jax.device_get(jc), "cpu")
    assert set(tree_rel(cache_to_numpy(cfg, cache), jax.device_get(jc)).values()) == {0.0}
    decode = jax.jit(japi.decode)
    for s in range(3):
        tok = x["tokens"][:, PROMPT + s]
        jl, jc = decode(jp, jc, tok)
        tl, cache = api.decode(params, cache, t(tok))
        assert rel(tl, jl) < TOL
    errs = tree_rel(cache_to_numpy(cfg, cache), jax.device_get(jc))
    assert max(errs.values()) < TOL, errs
