"""``TrainState`` checkpoints across the two packages, and the port's
trainer (``repro_torch.launch.train``, ``launch.train_lm``) on the CPU.

- The reference's checkpoint (``repro.ft.checkpoint.save`` of its
  ``TrainState``) restored by the port (``repro_torch.ft.checkpoint`` and
  ``convert.load_train_state``): every array equal, then 2 more steps give
  the reference's losses (the bounds of ``test_torch_train_step.py``).
- The port's (``convert.train_state_tree``) restored by the reference's
  ``ckpt.restore`` against its abstract ``TrainState``: every array equal
  and of the reference's dtype, then one more step gives the port's
  metrics (bfloat16 weights: loss within 1e-3 relative and ``grad_norm``
  within 1e-2, a bfloat16 model's spread between the packages, 2e-5 and
  9e-4 measured).
- The trainer: a crash at step 7 exits 17, a resume prints ``[resume]
  restored step 5`` and ends within 1e-4 of the uninterrupted run's final
  loss (the twin of ``tests/test_ft.py::test_failure_and_resume_
  deterministic``); multi-card flags raise; no card, no fallback.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ft import checkpoint as jckpt
from repro_torch.ft import checkpoint as ckpt
from repro_torch.models.convert import load_train_state, train_state_tree
from torch_train_cases import Pair, check_metrics, f32, flat

SRC = str(Path(__file__).parent.parent / "src")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,opt,compress", [("llama3.2-1b", "adamw", False),
                                               ("mamba2-780m", "adafactor", True)])
def test_jax_checkpoint_restores_into_the_port(tmp_path, arch, opt, compress):
    """The reference's ``TrainState`` checkpoint after 2 steps, restored by
    the port into its own state and continued 2 steps, gives the
    reference's losses."""
    pair = Pair(arch, opt, compress=compress)
    pair.run([0, 1])
    jckpt.save(tmp_path / "step_2", 2, pair.jstate)
    port = Pair(arch, opt, compress=compress)       # a fresh state, overwritten
    tree, manifest = ckpt.restore(tmp_path / "step_2",
                                  train_state_tree(port.state, abstract=True), device="cpu")
    load_train_state(port.state, tree)
    assert manifest["step"] == 2 and int(port.state.step) == 2
    ref = jax.device_get(pair.jstate)
    for (path, want), (_, got) in zip(flat(ref.params),
                                      flat(train_state_tree(port.state)[".params"])):
        assert np.array_equal(f32(got), f32(want)), path
    port.jstate = pair.jstate
    out = port.run([2, 3])
    check_metrics(out)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_port_checkpoint_restores_into_jax(tmp_path, dtype):
    """The port's ``TrainState`` checkpoint, restored by the reference's
    ``ckpt.restore`` against its abstract ``TrainState``: every array equal,
    and one more step from it equal to the port's next step."""
    pair = Pair("llama3.2-1b", "adamw", compress=True, bf16=dtype == "bf16")
    pair.run([0, 1])
    ckpt.save(tmp_path / "step_2", 2, train_state_tree(pair.state), metadata=dict(arch="x"))
    abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), pair.jstate)
    restored, manifest = jckpt.restore(tmp_path / "step_2", abstract)
    assert manifest["step"] == 2 and int(restored.step) == 2
    mine = train_state_tree(pair.state)
    theirs = jax.device_get(restored)
    for name, tree in ((".params", theirs.params), (".opt_state", theirs.opt_state),
                       (".error_fb", theirs.error_fb)):
        for (path, want), (_, got) in zip(flat(tree), flat(mine[name])):
            assert str(want.dtype) == str(got.dtype).split(".")[-1], (name, path)
            assert np.array_equal(f32(got), f32(want)), (name, path)
    if dtype == "bf16":
        assert theirs.params["embed"].dtype == ml_dtypes.bfloat16
    pair.jstate = restored
    check_metrics(pair.run([2]), *((1e-3, 1e-2) if dtype == "bf16" else ()))


TRAIN = ["--device", "cpu", "--smoke", "--arch", "llama3.2-1b", "--steps", "12",
         "--batch", "4", "--seq", "32", "--ckpt-every", "5"]


def _train(*extra, ckpt_dir):
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *TRAIN,
                           "--ckpt-dir", str(ckpt_dir), *extra],
                          capture_output=True, text=True, timeout=300, env=env)


def _final_loss(out: str) -> float:
    return float(re.search(r"\[done\] final loss ([0-9.]+)", out).group(1))


def test_trainer_crash_and_resume_match_an_uninterrupted_run(tmp_path):
    full = _train(ckpt_dir=tmp_path / "a")
    assert full.returncode == 0, full.stderr[-2000:]
    crash = _train("--simulate-failure", "7", ckpt_dir=tmp_path / "b")
    assert crash.returncode == 17, (crash.returncode, crash.stderr[-2000:])
    assert "[failure] simulated crash at step 7" in crash.stdout
    assert ckpt.latest_step(tmp_path / "b") == 5
    resumed = _train("--resume", ckpt_dir=tmp_path / "b")
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert "[resume] restored step 5" in resumed.stdout
    assert abs(_final_loss(resumed.stdout) - _final_loss(full.stdout)) < 1e-4
    # the resumed run prints the uninterrupted run's lines from step 5 on
    tail = lambda out: [ln for ln in out.splitlines() if ln.startswith("step")
                        and int(ln.split()[1]) >= 5]
    assert tail(resumed.stdout) == tail(full.stdout)


def test_trainer_checkpoint_is_the_reference_layout(tmp_path):
    """The trainer's checkpoint holds the reference's ``TrainState`` keys."""
    from repro_torch.launch import train

    train.main(TRAIN[:5] + ["--steps", "5", "--batch", "4", "--seq", "32", "--ckpt-every",
                            "5", "--compress-grads", "--ckpt-dir", str(tmp_path)])
    import json
    keys = json.loads((tmp_path / "step_5" / "manifest.json").read_text())["keys"]
    assert {".step", ".opt_state/step", ".params/embed", ".opt_state/mu/embed",
            ".opt_state/nu/blocks/pos0/attn/wq", ".error_fb/final_norm"} <= set(keys)
    assert all(k.split("/")[0] in (".params", ".opt_state", ".step", ".error_fb")
               for k in keys)


@pytest.mark.parametrize("flags", [["--mesh", "1x2"], ["--devices", "2"]])
def test_trainer_multi_card_flags_raise(flags):
    """The mesh flags train on a mesh of ranks (``test_torch_mesh_elastic.py``
    runs them); they raise before starting a rank where they cannot run: a
    ``--mesh`` of another rank count than ``--devices``, and NCCL asked for
    CPU ranks."""
    from repro_torch.launch import train

    extra = ["--devices", "4"] if "--mesh" in flags else ["--backend", "nccl"]
    with pytest.raises(ValueError, match="--devices 4|CPU ranks run gloo"):
        train.main(TRAIN + flags + extra)


def test_train_lm_runs_and_its_devices_flag_raises(tmp_path, capsys):
    """``train_lm`` runs on one device; its ``--devices`` asks for a mesh,
    which raises before starting a rank when NCCL is asked for CPU ranks."""
    from repro_torch.launch import train_lm

    train_lm.main(["--steps", "2", "--ckpt", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "[done] final loss" in out
    with pytest.raises(ValueError, match="CPU ranks run gloo"):
        train_lm.main(["--steps", "2", "--ckpt", str(tmp_path), "--devices", "2",
                       "--device", "cpu", "--backend", "nccl"])


def test_trainer_without_a_card_raises(monkeypatch):
    from repro_torch.launch import train, train_lm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_lm.main(["--steps", "1"])


def test_simulated_crash_waits_for_the_checkpoint_in_flight(tmp_path):
    """A checkpoint write slower than the steps after it (as the smoke
    model's steps on a card are) has reached the disk when the simulated
    crash exits, so the restart resumes from it."""
    from repro_torch.launch import train
    from repro_torch.resilience.faults import FaultPlan, FaultSpec, active_plan

    slow = FaultPlan({"ckpt.write_arrays": FaultSpec("delay", after=0, delay_s=2.0)})
    with active_plan(slow), pytest.raises(SystemExit) as exit_:
        train.main(TRAIN + ["--ckpt-dir", str(tmp_path), "--simulate-failure", "7"])
    assert exit_.value.code == 17
    assert ckpt.latest_step(tmp_path) == 5
