"""The port's training substrate against the JAX package's: the token
pipeline (``repro_torch.data.pipeline``), the optimizers
(``repro_torch.training.optim``) and the gradient compressor
(``repro_torch.training.compress``), each fed the same seeded numpy inputs
as the reference.

Tolerances: pipeline batches bit-equal; after 10 optimizer updates a
float32 leaf within 1e-6 of its largest |p| and a bfloat16 leaf within one
bfloat16 ulp (its 16-bit patterns differ by at most 1); factored state
shapes equal; int8 levels equal and dequantised values and residuals bit
for bit.  ``compressed_psum`` runs over 8 gloo ranks (``tests/
torch_train_ranks.py``) against the reference's ``shard_map`` over 8 fake
XLA devices (a subprocess, as ``tests/test_distributed.py`` runs it), each
rank's result bit for bit.  The cases of ``tests/test_training.py`` are
restated on the port at the end (the smoke-model case is in
``test_torch_train_step.py``).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.data.pipeline import TokenPipeline as JPipeline
from repro.training import GradCompressor as JCompressor
from repro.training import OptConfig as JOptConfig
from repro.training import optim as joptim
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.training import (GradCompressor, OptConfig, init_state, make_train_step,
                                  optim)
from repro_torch.training.tree import Stacked

HERE = Path(__file__).parent
SRC = str(HERE.parent / "src")
WORLD = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tt(a) -> torch.Tensor:
    """A numpy array (bfloat16 as ``ml_dtypes``) as a torch tensor."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def host(x) -> np.ndarray:
    """A tensor (or a ``Stacked`` group, stacked) as numpy, bfloat16 as
    ``ml_dtypes``."""
    if isinstance(x, Stacked):
        x = torch.stack(list(x))
    x = x.detach()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return x.numpy()


# --------------------------- token pipeline --------------------------------

PIPES = {
    "decoder": dict(),
    "vision": dict(frontend="vision", frontend_tokens=4, d_model=8),
    "encdec": dict(encdec=True, d_model=8, decoder_len=6),
}


@pytest.mark.parametrize("kind", list(PIPES))
def test_token_pipeline_bit_equal(kind):
    ref, port = (cls(97, 4, 12, seed=3, **PIPES[kind]) for cls in (JPipeline, TokenPipeline))
    for step in (0, 1, 7, 1000):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert np.array_equal(got[k], want[k]), (kind, step, k)


def test_token_pipeline_depends_only_on_seed_and_step():
    p = TokenPipeline(97, 4, 12, seed=3)
    a = p.batch_at(5)
    p.batch_at(6)
    assert np.array_equal(a["tokens"], p.batch_at(5)["tokens"])
    assert not np.array_equal(a["tokens"], TokenPipeline(97, 4, 12, seed=4).batch_at(5)["tokens"])


# ------------------------------ optimizers ---------------------------------

def _tree(seed=0):
    """1-D, 2-D and 3-D float32 leaves and a bfloat16 leaf."""
    rng = np.random.default_rng(seed)
    return dict(a=rng.standard_normal((7,)).astype(np.float32),
                b=rng.standard_normal((5, 6)).astype(np.float32),
                c=rng.standard_normal((3, 4, 5)).astype(np.float32),
                d=rng.standard_normal((8, 16)).astype(ml_dtypes.bfloat16))


def _grads(tree, n, seed=1):
    rng = np.random.default_rng(seed)
    return [{k: (0.1 * rng.standard_normal(v.shape)).astype(v.dtype) for k, v in tree.items()}
            for _ in range(n)]


def _run_reference(tree, grads, cfg):
    params = {k: jnp.asarray(v) for k, v in tree.items()}
    state = joptim.init_opt_state(params, cfg)
    upd = jax.jit(lambda p, g, s: joptim.apply_updates(p, g, s, cfg))
    for g in grads:
        params, state = upd(params, {k: jnp.asarray(v) for k, v in g.items()}, state)
    return jax.device_get(params), jax.device_get(state)


def _close(got: np.ndarray, want: np.ndarray):
    if want.dtype == ml_dtypes.bfloat16:
        # one bfloat16 ulp: the 16-bit patterns of same-signed values
        bits = lambda x: x.view(np.int16).astype(np.int32)
        assert np.all(np.sign(got.astype(np.float32)) == np.sign(want.astype(np.float32)))
        assert np.abs(bits(got) - bits(want)).max() <= 1
    else:
        assert got.dtype == want.dtype
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_apply_updates_match_jax(name):
    tree, grads = _tree(), _grads(_tree(), 10)
    want_p, want_s = _run_reference(tree, grads, JOptConfig(name=name, lr=1e-2))
    cfg = OptConfig(name=name, lr=1e-2)
    params = {k: tt(v) for k, v in tree.items()}
    state = optim.init_opt_state(params, cfg)
    for g in grads:
        params, state = optim.apply_updates(params, {k: tt(v) for k, v in g.items()}, state, cfg)
    for k in tree:
        _close(host(params[k]), want_p[k])
    assert int(state["step"]) == int(want_s["step"]) == 10
    assert state["step"].dtype == torch.int32
    flat_s = jax.tree_util.tree_flatten_with_path(want_s)[0]
    for path, want in flat_s:
        got = state
        for key in path:
            got = got[key.key]
        assert tuple(got.shape) == want.shape, path
        if want.ndim:
            assert np.abs(host(got) - want).max() <= 1e-5 * np.abs(want).max(), path


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_stacked_groups_update_as_the_reference_stack(name):
    """A ``Stacked`` group of per-layer tensors is the reference's stacked
    leaf: Adafactor factors a stack of vectors (G, D) into vr (G,) and vc
    (D,) and clips over the whole stack."""
    rng = np.random.default_rng(4)
    tree = dict(mat=rng.standard_normal((3, 4, 5)).astype(np.float32),
                vec=rng.standard_normal((3, 6)).astype(np.float32))
    grads = [{k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in tree.items()} for _ in range(5)]
    want_p, want_s = _run_reference(tree, grads, JOptConfig(name=name, lr=1e-2))
    cfg = OptConfig(name=name, lr=1e-2)
    params = {k: Stacked(tt(v).unbind(0)) for k, v in tree.items()}
    state = optim.init_opt_state(params, cfg)
    for g in grads:
        params, state = optim.apply_updates(
            params, {k: Stacked(tt(v).unbind(0)) for k, v in g.items()}, state, cfg)
    for k in tree:
        _close(host(params[k]), want_p[k])
    if name == "adafactor":
        assert tuple(state["v"]["vec"]["vr"].shape) == want_s["v"]["vec"]["vr"].shape == (3,)
        assert tuple(state["v"]["vec"]["vc"].shape) == want_s["v"]["vec"]["vc"].shape == (6,)
    else:
        assert tuple(state["mu"]["mat"].shape) == (3, 4, 5)


def test_opt_config_defaults_match_jax():
    assert OptConfig().__dict__ == JOptConfig().__dict__


# ------------------------------ compression --------------------------------

def _comp_inputs(seed=0):
    rng = np.random.default_rng(seed)
    grads = dict(w=rng.standard_normal((64,)).astype(np.float32),
                 m=(rng.standard_normal((6, 5)) * np.arange(1, 7)[:, None]).astype(np.float32),
                 h=rng.standard_normal((4, 8)).astype(ml_dtypes.bfloat16))
    err = {k: (1e-3 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in grads.items()}
    return grads, err


def test_compress_decompress_bit_equal_to_jax():
    grads, err = _comp_inputs()
    ref, port = JCompressor(bits=8), GradCompressor(bits=8)
    for k, g in grads.items():
        g32 = np.asarray(g, np.float32) + err[k]
        jq, jscale = ref._quant(jnp.asarray(g32))
        q, scale = port._quant(torch.from_numpy(g32))
        assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq)), k
        assert float(scale) == float(jscale), k
    want_d, want_e = jax.device_get(ref.compress_decompress(
        {k: jnp.asarray(v) for k, v in grads.items()}, {k: jnp.asarray(v) for k, v in err.items()}))
    got_d, got_e = port.compress_decompress({k: tt(v) for k, v in grads.items()},
                                            {k: tt(v) for k, v in err.items()})
    for k in grads:
        assert np.array_equal(host(got_d[k]), want_d[k]), k
        assert np.array_equal(host(got_e[k]), want_e[k]), k


def test_compress_decompress_one_scale_over_a_stack():
    """A ``Stacked`` group is quantized as the reference's stacked leaf: one
    scale over every slice."""
    rng = np.random.default_rng(2)
    g = (rng.standard_normal((3, 5, 4)) * np.array([1, 10, 100])[:, None, None]).astype(np.float32)
    e = np.zeros_like(g)
    want_d, want_e = jax.device_get(JCompressor().compress_decompress(
        dict(x=jnp.asarray(g)), dict(x=jnp.asarray(e))))
    got_d, got_e = GradCompressor().compress_decompress(
        dict(x=Stacked(tt(g).unbind(0))), dict(x=torch.from_numpy(e)))
    assert isinstance(got_d["x"], Stacked) and len(got_d["x"]) == 3
    assert np.array_equal(host(got_d["x"]), want_d["x"])
    assert np.array_equal(got_e["x"].numpy(), want_e["x"])


def test_compressed_psum_without_a_group_is_one_member():
    """With no process group the shared scale is the local one and the sum
    is the local payload: ``compress_decompress``'s values, bit for bit."""
    grads, err = _comp_inputs()
    port = GradCompressor()
    g = {k: tt(v) for k, v in grads.items()}
    e = {k: tt(v) for k, v in err.items()}
    d1, e1 = port.compressed_psum(g, e)
    d2, e2 = port.compress_decompress(g, e)
    for k in grads:
        assert torch.equal(d1[k], d2[k]) and torch.equal(e1[k], e2[k]), k


_JAX_PSUM = r"""
import sys; sys.path.insert(0, %r)
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.distributed import compat
from repro.training.compress import GradCompressor

z = np.load(%r)
names = sorted({k.rsplit("/", 1)[0] for k in z.files})
mesh = jax.make_mesh((%d,), ("data",))
comp = GradCompressor(bits=8)

def body(gs, es):
    deq, err = comp.compressed_psum({n: g[0] for n, g in gs.items()},
                                    {n: e[0] for n, e in es.items()}, "data")
    return ({n: deq[n][None] for n in names}, {n: err[n][None] for n in names})

spec = {n: P("data") for n in names}
with compat.set_mesh(mesh):
    deq, err = compat.shard_map(body, mesh=mesh, in_specs=(spec, spec),
                                out_specs=(spec, spec))(
        {n: jnp.asarray(z[n + "/g"]) for n in names}, {n: jnp.asarray(z[n + "/e"]) for n in names})
out = {}
for n in names:
    out[n + "/deq"], out[n + "/err"] = np.asarray(deq[n]), np.asarray(err[n])
np.savez(%r, **out)
print("OK")
"""


def test_compressed_psum_over_8_gloo_ranks_matches_shard_map(tmp_path):
    rng = np.random.default_rng(0)
    inp = tmp_path / "in.npz"
    arrays = {"w/g": rng.standard_normal((WORLD, 64)).astype(np.float32),
              "m/g": (rng.standard_normal((WORLD, 6, 5)) * np.arange(1, WORLD + 1)[:, None, None]
                      ).astype(np.float32)}
    for n in ("w", "m"):
        arrays[n + "/e"] = (1e-3 * rng.standard_normal(arrays[n + "/g"].shape)).astype(np.float32)
    np.savez(inp, **arrays)
    ref_out = tmp_path / "ref.npz"
    env = {"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
           "JAX_PLATFORMS": "cpu", "XLA_FLAGS": f"--xla_force_host_platform_device_count={WORLD}"}
    r = subprocess.run([sys.executable, "-c", _JAX_PSUM % (SRC, str(inp), WORLD, str(ref_out))],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-2500:])
    out = tmp_path / "ranks"
    out.mkdir()
    r = subprocess.run([sys.executable, str(HERE / "torch_train_ranks.py"), str(inp), str(out),
                        str(WORLD)], capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": SRC})
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-2500:])
    with np.load(ref_out) as want:
        for rank in range(WORLD):
            with np.load(out / f"rank{rank}.npz") as got:
                for n in ("w", "m"):
                    assert np.array_equal(got[n + "/deq"], want[n + "/deq"][rank]), (rank, n)
                    assert np.array_equal(got[n + "/err"], want[n + "/err"][rank]), (rank, n)
        # every member recovers the same mean gradient, within int8 error
        g = arrays["w/g"] + arrays["w/e"]
        rel = np.abs(want["w/deq"][0] - g.mean(0)).max() / np.abs(g.mean(0)).max()
        assert rel < 0.02, rel


# -------------- tests/test_training.py, restated on the port ---------------

def _toy_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    loss = ((pred - batch["y"]) ** 2).mean()
    return loss, dict(loss=loss)


def _toy_setup(seed=0, n=256, d=16):
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal((d, 1)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = x @ w_true + 0.01 * rng.standard_normal((n, 1)).astype(np.float32)
    params = dict(w=torch.zeros((d, 1)), b=torch.zeros((1,)))
    return params, dict(x=torch.from_numpy(x), y=torch.from_numpy(y))


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_optimizer_converges(opt_name):
    params, batch = _toy_setup()
    opt_cfg = OptConfig(name=opt_name, lr=3e-2, weight_decay=0.0)
    state = init_state(params, opt_cfg)
    step = make_train_step(_toy_loss, opt_cfg)
    losses = []
    for _ in range(150):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.05 * losses[0], (opt_name, losses[0], losses[-1])


def test_microbatch_accumulation_matches_full_batch():
    params, batch = _toy_setup()
    opt_cfg = OptConfig(name="adamw", lr=1e-2, weight_decay=0.0)
    s1 = init_state(params, opt_cfg)
    p4, _ = _toy_setup()
    s4 = init_state(p4, opt_cfg)
    step1 = make_train_step(_toy_loss, opt_cfg, microbatch=1)
    step4 = make_train_step(_toy_loss, opt_cfg, microbatch=4)
    for _ in range(5):
        s1, m1 = step1(s1, batch)
        s4, m4 = step4(s4, batch)
    for k in ("w", "b"):
        np.testing.assert_allclose(s1.params[k].detach().numpy(), s4.params[k].detach().numpy(),
                                   rtol=2e-4, atol=2e-5)


def test_compressed_grads_error_feedback_converges():
    params, batch = _toy_setup()
    opt_cfg = OptConfig(name="adamw", lr=3e-2, weight_decay=0.0)
    comp = GradCompressor(bits=8)
    state = init_state(params, opt_cfg, comp)
    step = make_train_step(_toy_loss, opt_cfg, compressor=comp)
    for _ in range(150):
        state, m = step(state, batch)
    assert float(m["loss"]) < 0.01, float(m["loss"])
    # error feedback residual actually carries information
    assert any(float(e.abs().max()) > 0 for e in state.error_fb.values())


def test_compression_quantizes_to_levels():
    comp = GradCompressor(bits=8)
    g = dict(w=torch.from_numpy(np.random.default_rng(0).standard_normal((64,)).astype(np.float32)))
    e = comp.init_error(g)
    deq, err = comp.compress_decompress(g, e)
    scale = float(g["w"].abs().max()) / 127
    lv = deq["w"].numpy() / scale
    np.testing.assert_allclose(lv, np.round(lv), atol=1e-4)
    np.testing.assert_allclose(deq["w"].numpy() + err["w"].numpy(), g["w"].numpy(),
                               rtol=1e-6, atol=1e-7)


def test_adafactor_state_is_factored():
    params = dict(w=torch.zeros((32, 16)), b=torch.zeros((16,)))
    st = optim.init_opt_state(params, OptConfig(name="adafactor"))
    assert st["v"]["w"]["vr"].shape == (32,)
    assert st["v"]["w"]["vc"].shape == (16,)
    assert st["v"]["b"]["v"].shape == (16,)
    n_state = sum(x.numel() for v in st["v"].values() for x in v.values())
    n_param = sum(x.numel() for x in params.values())
    assert n_state < 0.2 * n_param, "factored state must be tiny vs adam's 2x"
