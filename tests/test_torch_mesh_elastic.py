"""Checkpoints across mesh shapes, and the mesh trainer's crash and resume.

- The smoke llama's weights (the reference's, ``jax.random.key(0)``) cut
  to the blocks of 4 gloo ranks at (1, 4), gathered a leaf at a time and
  written by rank 0, restore on 2 ranks at (1, 2) and on 1 rank at (1, 1)
  (``checkpoint.restore(mesh=)`` and ``ft.elastic.reshard`` of the host
  arrays, every rank's blocks its cut of the global arrays), in one
  process with no mesh, and in the reference's ``ckpt.restore``, each with
  the checksum of ``tests/test_ft.py::test_elastic_reshard_across_device_
  counts`` (the sum of |x| over the leaves, each in float32) within 1e-5
  relative of the weights'.
- ``launch/train.py --device cpu --devices 2`` (a (1, 2) mesh, and a
  (2, 1) one) crashed at step 7 and resumed from its step-5 checkpoint ends
  within 1e-4 of the uninterrupted run's loss (``test_ft.py::
  test_failure_and_resume_deterministic``'s check, on the port's mesh), and
  the one-process trainer resumed from that checkpoint takes step 5 at the
  mesh run's loss.
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

from repro import configs as JC
from repro.ft import checkpoint as jckpt
from repro.models.registry import get_model as jget_model
from repro_torch import configs as C
from repro_torch.ft import checkpoint as ckpt
from repro_torch.models import get_model
from repro_torch.models.convert import abstract_param_tree
from repro_torch.training import check as train_check

HERE = Path(__file__).parent
SRC = HERE.parent / "src"
CHECKSUM_TOL, RESUME_TOL = 1e-5, 1e-4


def _ranks(*argv, timeout=300):
    r = subprocess.run([sys.executable, str(HERE / "torch_mesh_ranks.py"), *map(str, argv)],
                       capture_output=True, text=True, timeout=timeout,
                       env={**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(Path(argv[1]).read_text())


def _checksum(leaves) -> float:
    return sum(float(np.sum(np.abs(np.asarray(x, np.float32)))) for x in leaves)


@pytest.fixture(scope="module")
def four_rank_ckpt(tmp_path_factory):
    """The reference's smoke llama weights, written by 4 ranks at (1, 4)."""
    d = tmp_path_factory.mktemp("elastic")
    params = jax.device_get(jget_model(JC.get_smoke("llama3.2-1b")).init(jax.random.key(0)))
    flat = {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(d / "w.npz", **flat)
    res = _ranks("save", d / "save.json", "1x4", d / "w.npz", d / "ck")
    assert res == dict(saved=4)
    return d, _checksum(flat.values())


@pytest.mark.parametrize("shape", ["1x2", "1x1"])
def test_four_rank_checkpoint_restores_on_fewer_ranks(four_rank_ckpt, shape):
    d, want = four_rank_ckpt
    res = _ranks("load", d / f"load_{shape}.json", shape, d / "ck")
    assert res["blocks_ok"], res
    for k in ("restore", "reshard"):
        assert abs(res[k] - want) / want < CHECKSUM_TOL, (k, res, want)


def test_four_rank_checkpoint_restores_in_one_process_and_reference(four_rank_ckpt):
    d, want = four_rank_ckpt
    cfg = C.get_smoke("llama3.2-1b")
    abstract = abstract_param_tree(cfg, get_model(cfg, "cpu").abstract_params())
    tree, manifest = ckpt.restore(d / "ck", abstract, device="cpu")
    assert manifest["step"] == 1
    got = _checksum(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tree)))
    assert abs(got - want) / want < CHECKSUM_TOL
    jtree, _ = jckpt.restore(d / "ck", jget_model(JC.get_smoke("llama3.2-1b")).abstract_params())
    got = sum(float(jnp.sum(jnp.abs(x).astype(jnp.float32))) for x in jax.tree.leaves(jtree))
    assert abs(got - want) / want < CHECKSUM_TOL


@pytest.fixture
def niced():
    """This process at a lower priority while a test runs, so the trainer's
    processes, which inherit it, yield the CPU to the suite's other tests."""
    old = os.getpriority(os.PRIO_PROCESS, 0)
    os.setpriority(os.PRIO_PROCESS, 0, old + 10)
    yield
    try:
        os.setpriority(os.PRIO_PROCESS, 0, old)
    except PermissionError:     # lowering it back needs the privilege
        pass


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_mesh_trainer_crash_and_resume(tmp_path, monkeypatch, niced, mesh):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = train_check.crash_and_resume(
        "cpu", tmp_path, SRC, extra=("--devices", "2", "--mesh", mesh),
        alongside=lambda crash: train_check.resume_one_process(
            "cpu", crash / "step_5", tmp_path / "one", SRC))
    assert (res["rc_full"], res["rc_crash"], res["rc_resume"]) == (
        0, train_check.FAILURE_EXIT, 0), res
    assert res["restored"], res
    assert abs(res["resumed_loss"] - res["final_loss"]) < RESUME_TOL, res
    one = res["alongside"]
    assert one["rc"] == 0 and one["restored"], one
    assert abs(one["loss"] - res["losses"][train_check.RESUME_STEP]) < RESUME_TOL, (one, res)
