"""The port's prefill and decode on a (data, model) mesh of gloo ranks
against its one-process decode and against the JAX package's.

Every smoke architecture in float32, in serve mode (weights in the serve
layout, ``axes.set_mode("serve")``) at (2, 1), (1, 2) and (2, 2), and the
smoke llama at (2, 2) in train mode too (train-layout weights moved at
their use sites, the case of the reference's seed-failing
``tests/test_distributed.py::test_sharded_decode_matches_unsharded``).  The
weights are the reference's (``api.init(jax.random.key(0))``), carried
across; the ranks (``tests/torch_mesh_serve_ranks.py``, one spawn for the
layouts of 2 ranks and one for those of 4, run alongside the reference)
prefill 8 tokens (llava: after its 16 patch embeddings; whisper: its 16
frames and token 0) and decode 6 teacher-forced steps of the same seeded
inputs at B = 4, each rank its rows and its blocks of the cache.  Rank 0
holds the logits of the prefill and of every step, gathered, within 2e-4
of the largest |logit| (the bound of ``test_sharded_decode_matches_
unsharded``) of the port's one-process decode, and every cache array
after the last step, gathered, within that bound of the one-process
cache's; in serve mode the weight use sites make no collective.  The test
holds the mesh logits within the same bound of the reference's
one-process ``prefill`` and ``decode`` on the same weights and inputs,
run under an abstract mesh of the layout's shape so that MoE groups its
tokens into the layout's data-parallel chunks, as the mesh does (a rank's
rows are its chunk).

``test_training_checkpoint_serves_on_a_mesh``: the smoke llama's weights
written as a training checkpoint by 2 ranks at (2, 1)
(``tests/torch_mesh_ranks.py save``) restore into the serve layout at
(1, 2) (``checkpoint.restore(mesh=, spec_fn=)``, equal to
``ft.elastic.reshard`` of the host arrays) and decode within 2e-4 of the
one-process model restored from the same checkpoint.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh, use_abstract_mesh

from repro import configs as JC
from repro.distributed import axes as jaxes
from repro.models.registry import get_model as jget_model
from repro_torch import configs as C
from repro_torch.distributed import axes
from repro_torch.launch.mesh import MeshShape, axis_names
from repro_torch.models import mesh_check
from torch_mesh_serve_ranks import arrays_path

HERE = Path(__file__).parent
SRC = str(HERE.parent / "src")
TOL = 2e-4

LAYOUTS = {
    "2x1": [dict(arch=a) for a in C.ARCHS],
    "1x2": [dict(arch=a) for a in C.ARCHS],
    "2x2": [dict(arch=a) for a in C.ARCHS] + [dict(arch="llama3.2-1b", mode="train")],
}
CASES = [(layout, i) for layout, cases in LAYOUTS.items() for i in range(len(cases))]


def _name(case) -> str:
    layout, i = case
    c = LAYOUTS[layout][i]
    return f"{layout}-{c['arch']}-{c.get('mode', 'serve')}"


def _env():
    return {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}


def _ranks(out: Path, *argv) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, str(HERE / "torch_mesh_serve_ranks.py"), argv[0],
                             str(out), *map(str, argv[1:])], env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _wait(proc: subprocess.Popen, timeout=400):
    _, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]


def _dp(layout: str) -> int:
    return int(layout.split("x")[0])


def _reference_logits(arch: str, params, dp: int) -> list:
    """The reference's one-process prefill and teacher-forced decode of
    ``mesh_check.decode_inputs`` (numpy logits), under an abstract mesh
    of ``dp`` data ranks (``dp_size()``: MoE's chunks)."""
    cfg = C.get_smoke(arch)
    japi = jget_model(JC.get_smoke(arch))
    x = mesh_check.decode_inputs(cfg)
    tokens = jnp.asarray(x["tokens"], jnp.int32)
    with use_abstract_mesh(AbstractMesh((dp, 1), ("data", "model"))):
        if cfg.is_encdec:
            logits, cache = jax.jit(japi.prefill, static_argnums=2)(
                params, dict(frames=jnp.asarray(x["frames"])), 0)
            feed = tokens
        else:
            prompt = dict(tokens=tokens[:, :mesh_check.N_PROMPT])
            if "prefix_embeds" in x:
                prompt["prefix_embeds"] = jnp.asarray(x["prefix_embeds"])
            logits, cache = jax.jit(japi.prefill, static_argnums=2)(
                params, prompt, mesh_check.kv_slots(cfg))
            feed = tokens[:, mesh_check.N_PROMPT:]
        out = [np.asarray(logits)]
        decode = jax.jit(japi.decode)
        for s in range(mesh_check.N_STEPS):
            logits, cache = decode(params, cache, feed[:, s])
            out.append(np.asarray(logits))
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both spawns of ranks on the reference's weights, started first, and
    the reference's logits of every (arch, data ranks) the layouts need,
    computed while the ranks run."""
    d = tmp_path_factory.mktemp("mesh_serve")
    (d / "w").mkdir()
    params = {}
    for arch in C.ARCHS:
        params[arch] = jget_model(JC.get_smoke(arch)).init(jax.random.key(0))
        flat = {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(v)
                for p, v in jax.tree_util.tree_flatten_with_path(
                    jax.device_get(params[arch]))[0]}
        np.savez(d / "w" / f"{arch}.npz", **flat)
    procs = {}
    for n in (2, 4):
        group = {k: v for k, v in LAYOUTS.items() if _dp(k) * int(k.split("x")[1]) == n}
        procs[n] = (_ranks(d / f"out{n}.json", "decode", json.dumps(group), d / "w"), group)
    ref = {}
    for layout, cases in LAYOUTS.items():
        for c in cases:
            moe = C.get_smoke(c["arch"]).moe_experts > 0
            key = (c["arch"], _dp(layout) if moe else 1)
            if key not in ref:
                ref[key] = _reference_logits(c["arch"], params[c["arch"]], key[1])
    res = {}
    for n, (proc, group) in procs.items():
        _wait(proc)
        out = json.loads((d / f"out{n}.json").read_text())
        for layout in group:
            for i, r in enumerate(out[layout]):
                with np.load(arrays_path(d / f"out{n}.json", layout, i)) as z:
                    r["arrays"] = [z[str(s)] for s in range(len(z.files))]
                res[(layout, i)] = r
    return res, ref


@pytest.mark.parametrize("case", CASES, ids=[_name(c) for c in CASES])
def test_mesh_decode_matches_one_process_and_reference(served, case):
    res, ref = served
    layout, i = case
    c = LAYOUTS[layout][i]
    r = res[case]
    assert r["mesh"] == [int(x) for x in layout.split("x")] and r["steps"] == mesh_check.N_STEPS
    assert r["logits"] < TOL, r
    assert r["cache"] < TOL, r
    if c.get("mode", "serve") == "serve":
        assert r["weight_moves"] == 0, r
    else:
        assert r["weight_moves"] > 0, r          # train layout: moved at the use sites
    moe = C.get_smoke(c["arch"]).moe_experts > 0
    want = ref[(c["arch"], _dp(layout) if moe else 1)]
    assert len(want) == len(r["arrays"])
    for s, (g, w) in enumerate(zip(r["arrays"], want)):
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err < TOL, (s, err)


def test_moe_chunks_change_the_reference_decode():
    """Why the reference runs under an abstract mesh of the layout: at 2
    data ranks qwen2-moe's capacity per chunk drops other (token, expert)
    pairs than one chunk does, and its logits differ."""
    arch = "qwen2-moe-a2.7b"
    params = jget_model(JC.get_smoke(arch)).init(jax.random.key(0))
    one, two = (_reference_logits(arch, params, dp) for dp in (1, 2))
    assert max(np.abs(a - b).max() / np.abs(a).max() for a, b in zip(one, two)) > 1e-2


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 4), (2, 2), (16, 16), (2, 16, 16)])
def test_set_mode_and_current_axes_match_reference(shape):
    """``current_axes`` under a shape-only mesh equals the reference's under
    an abstract mesh of the shape, and ``((), None)`` with none in scope;
    ``set_mode`` takes the reference's two modes and no other."""
    names = axis_names(len(shape))
    with use_abstract_mesh(AbstractMesh(shape, names)):
        want, want_dp = jaxes.current_axes(), jaxes.dp_size()
    with axes.use_mesh(MeshShape(shape, names)):
        assert axes.current_axes() == want
        assert axes.dp_size() == want_dp
    assert axes.current_axes() == jaxes.current_axes() == ((), None)
    prev = axes.set_mode("serve")
    try:
        assert prev == "train" and axes.set_mode("serve") == "serve"
        jaxes.set_mode("serve")
        with pytest.raises(ValueError):
            axes.set_mode("eval")
        with pytest.raises(AssertionError):
            jaxes.set_mode("eval")
    finally:
        axes.set_mode(prev)
        jaxes.set_mode("train")


def test_training_checkpoint_serves_on_a_mesh(tmp_path):
    flat = {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jax.device_get(
                jget_model(JC.get_smoke("llama3.2-1b")).init(jax.random.key(0))))[0]}
    np.savez(tmp_path / "w.npz", **flat)
    save = subprocess.run([sys.executable, str(HERE / "torch_mesh_ranks.py"), "save",
                           str(tmp_path / "save.json"), "2x1", str(tmp_path / "w.npz"),
                           str(tmp_path / "ck")], env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert save.returncode == 0, save.stderr[-3000:]
    assert json.loads((tmp_path / "save.json").read_text()) == dict(saved=2)
    _wait(_ranks(tmp_path / "load.json", "ckpt", "1x2", tmp_path / "ck"), timeout=300)
    res = json.loads((tmp_path / "load.json").read_text())
    assert res["step"] == 1 and res["same_blocks"], res
    assert res["logits"] < TOL, res
