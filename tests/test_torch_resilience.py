"""The port's fault injection, checkpoints and WAL recovery vs the JAX
package's.

``repro_torch.resilience.faults`` is a copy of the reference's module, so
under one seed the two fire the same schedule.  ``repro_torch.ft.checkpoint``
writes the reference's layout without JAX: a checkpoint written by either
package restores in the other with equal keys, dtypes and bits (bfloat16
included).  The cases of ``tests/test_resilience.py`` for fault plans, every
crash window, bit flips, the index's torn-npz and bit-flip detection (through
the port's ``index.read_arrays`` hook) and the WAL are restated on the port.
"""
import json
import shutil

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ft import checkpoint as jckpt
from repro.resilience import faults as jfaults
from repro_torch.ft import checkpoint as ckpt
from repro_torch.index import CorruptArtifactError, Index
from repro_torch.resilience import (ALGO, FaultPlan, FaultSpec, InjectedCrash,
                                    InjectedFault, active_plan, checksum_array,
                                    fault_point, verify_arrays)
from repro_torch.streaming import MutableIndex, delta


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU work here is many small operations: run them on one
    thread, so that they neither wait on a pool nor crowd the other test
    processes (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_index(unit_index, tmp_path_factory):
    path = unit_index.save(tmp_path_factory.mktemp("base") / "i.naszip")
    return Index.load(path, device="cpu")


# ---------------------------------------------------------------------------
# fault plan mechanics
# ---------------------------------------------------------------------------
def _schedule(mod):
    """Fire log of one seeded plan over three points, in module ``mod``."""
    plan = mod.FaultPlan({
        "p.raise": mod.FaultSpec("raise", at=(1, 3)),
        "p.window": mod.FaultSpec("raise", after=2, until=4),
        "p.prob": mod.FaultSpec("raise", p=0.5, max_fires=2),
    }, seed=42)
    fired = []
    with mod.active_plan(plan):
        for point in ("p.raise", "p.window", "p.prob"):
            for i in range(8):
                try:
                    mod.fault_point(point)
                    fired.append((point, i, False))
                except mod.InjectedFault:
                    fired.append((point, i, True))
    return fired, [(e.point, e.hit, e.kind) for e in plan.events]


def test_fault_plan_deterministic_replay():
    from repro_torch.resilience import faults

    f1, log1 = _schedule(faults)
    f2, log2 = _schedule(faults)
    assert f1 == f2 and log1 == log2          # same seed -> same schedule
    assert [i for p, i, hit in f1 if p == "p.raise" and hit] == [1, 3]
    assert [i for p, i, hit in f1 if p == "p.window" and hit] == [2, 3]
    assert sum(1 for p, _, hit in f1 if p == "p.prob" and hit) == 2
    assert (f1, log1) == _schedule(jfaults)   # the reference's schedule
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec("explode")


def test_fault_point_free_without_plan():
    fault_point("nonexistent.point", ids=[1, 2])   # no plan -> pure no-op


# ---------------------------------------------------------------------------
# checkpoint crash windows + verification
# ---------------------------------------------------------------------------
def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((16, 8)).astype(np.float32),
            "step_id": np.asarray([seed], np.int64)}


@pytest.mark.parametrize("window", ["ckpt.write_arrays", "ckpt.pre_swap",
                                    "ckpt.mid_swap", "ckpt.post_swap"])
def test_checkpoint_survives_every_crash_window(tmp_path, window):
    d = tmp_path / "ck" / "step_0"
    ckpt.save(d, step=0, tree=_tree(0))
    kind = "torn_write" if window == "ckpt.write_arrays" else "crash"
    with active_plan(FaultPlan({window: FaultSpec(kind, at=(0,))})):
        with pytest.raises(InjectedCrash):
            ckpt.save(d, step=0, tree=_tree(1))
    # whatever window died, a complete checkpoint is recoverable
    assert ckpt.steps(tmp_path / "ck") == [0]
    tree, manifest = ckpt.restore(d, {k: 0 for k in _tree(0)})
    expect = _tree(0) if window in ("ckpt.write_arrays", "ckpt.pre_swap",
                                    "ckpt.mid_swap") else _tree(1)
    assert int(tree["step_id"][0]) == int(expect["step_id"][0])
    np.testing.assert_array_equal(tree["w"], expect["w"])
    assert manifest["checksums"]["arrays"].keys() == {"w", "step_id"}


def test_checkpoint_detects_bit_flip_on_read(tmp_path):
    d = tmp_path / "step_0"
    ckpt.save(d, step=0, tree=_tree(0))
    plan = FaultPlan({"ckpt.read_arrays": FaultSpec("bit_flip", at=(0,))})
    with active_plan(plan):
        with pytest.raises(CorruptArtifactError, match="checksum mismatch"):
            ckpt.restore(d, {k: 0 for k in _tree(0)})
    assert plan.events_of("bit_flip")          # the flip actually fired


def test_checksum_helpers():
    a = np.arange(12, dtype=np.float32)
    cks = {"algo": ALGO, "arrays": {"a": checksum_array(a, ALGO)}}
    verify_arrays({"a": a}, cks, "here")                 # clean
    verify_arrays({"a": a}, None, "here")                # pre-checksum artifact
    b = a.copy()
    b[3] += 1
    with pytest.raises(CorruptArtifactError, match="'a'"):
        verify_arrays({"a": b}, cks, "here")


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------
def _mixed_tree():
    """Nested dicts and lists of every dtype the writer special-cases."""
    rng = np.random.default_rng(9)
    bf = rng.standard_normal((4, 6)).astype(ml_dtypes.bfloat16)
    return {"params": {"dense": [rng.standard_normal((3, 5)).astype(np.float32),
                                 rng.integers(0, 9, (7,)).astype(np.int64)],
                       "bf16": bf, "b": None},
            "opt": [{"mu": rng.integers(0, 2**32, (5,), dtype=np.uint32)},
                    np.asarray([True, False, True])],
            "step": np.asarray(12, np.int32)}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def test_flatten_keys_match_jax():
    tree = _mixed_tree()
    want, _ = jckpt._flatten(tree)
    got = ckpt._flatten(tree)
    assert list(got) == list(want)
    for k in want:
        assert np.array_equal(_bits(got[k]), _bits(want[k])), k


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_checkpoint_restores_across_packages(tmp_path, reader):
    """Both writers leave the same manifest (keys, dtypes, checksums: the
    same bits), and each package restores the other's checkpoint."""
    tree = _mixed_tree()
    # the port also takes torch tensors, bfloat16 included
    tree_in = dict(tree, params=dict(tree["params"], bf16=torch.from_numpy(
        tree["params"]["bf16"].view(np.int16)).view(torch.bfloat16)))
    ckpt.save(tmp_path / "port" / "step_3", step=3, tree=tree_in,
              metadata={"n": 1})
    jckpt.save(tmp_path / "jax" / "step_3", step=3, tree=tree,
               metadata={"n": 1})
    man = {w: json.loads((tmp_path / w / "step_3" / "manifest.json").read_text())
           for w in ("port", "jax")}
    assert man["port"] == man["jax"]
    assert man["port"]["dtypes"]["params/bf16"] == "bfloat16"
    want, _ = jckpt._flatten(tree)
    if reader == "port":
        got, manifest = ckpt.restore(tmp_path / "jax" / "step_3", tree)
    else:
        got, manifest = jckpt.restore(tmp_path / "port" / "step_3", tree)
    assert manifest["metadata"] == {"n": 1} and manifest["step"] == 3
    flat = ckpt._flatten(got)
    assert list(flat) == list(want)
    for k, v in want.items():
        g = np.asarray(flat[k])
        if reader == "port":      # jax narrows 64-bit dtypes on its devices
            assert g.dtype == np.asarray(v).dtype, k
        assert np.array_equal(_bits(g), _bits(v)), k


def test_checkpoint_restores_to_torch(tmp_path):
    tree = _mixed_tree()
    jckpt.save(tmp_path / "step_0", step=0, tree=tree)
    got, _ = ckpt.restore(tmp_path / "step_0", tree, device="cpu")
    assert got["params"]["bf16"].dtype == torch.bfloat16
    assert np.array_equal(got["params"]["bf16"].view(torch.int16).numpy()
                          .view(np.uint16), _bits(tree["params"]["bf16"]))
    assert got["opt"][0]["mu"].dtype == torch.uint32
    assert torch.equal(got["params"]["dense"][0],
                       torch.from_numpy(tree["params"]["dense"][0]))
    assert got["params"]["b"] is None


# ---------------------------------------------------------------------------
# index artifact integrity
# ---------------------------------------------------------------------------
def test_index_torn_npz_detected(tmp_path, port_index):
    d = tmp_path / "idx"
    port_index.save(d)
    assert "checksums" in json.loads((d / "spec.json").read_text())
    with open(d / "arrays.npz", "r+b") as f:
        f.truncate((d / "arrays.npz").stat().st_size // 2)
    with pytest.raises(CorruptArtifactError, match="arrays.npz"):
        Index.load(d, device="cpu")


def test_index_bit_flip_on_read_detected(tmp_path, port_index):
    d = tmp_path / "idx"
    port_index.save(d)
    loaded = Index.load(d, device="cpu")       # clean load passes checksums
    assert loaded.n == port_index.n
    plan = FaultPlan({"index.read_arrays": FaultSpec("bit_flip", at=(2,))})
    with active_plan(plan):
        with pytest.raises(CorruptArtifactError, match="checksum mismatch"):
            Index.load(d, device="cpu")
    assert plan.events_of("bit_flip")


# ---------------------------------------------------------------------------
# WAL recovery: quarantine + bit-deterministic prefix replay
# ---------------------------------------------------------------------------
def _wal(tmp_path, base, n_segments=3, rows=4, seed=0):
    rng = np.random.default_rng(seed)
    mi = MutableIndex(base, reserve=0.5)
    wal = tmp_path / "wal"
    for _ in range(n_segments):
        mi.append(rng.standard_normal((rows, base.dim)).astype(np.float32))
        mi.save_delta(wal)
    return wal, mi


def test_wal_byte_flip_quarantined_prefix_bit_identical(tmp_path, port_index):
    wal, mi = _wal(tmp_path, port_index)
    npz = wal / "delta" / "step_1" / "arrays.npz"
    data = bytearray(npz.read_bytes())
    data[len(data) // 2] ^= 0x04
    npz.write_bytes(bytes(data))

    with pytest.raises(CorruptArtifactError):  # strict: refuse, don't guess
        MutableIndex.load(wal, device="cpu")

    m1 = MutableIndex.load(wal, recover=True, device="cpu")
    rep = m1.recovery_report
    assert rep["good"] == [0] and rep["quarantined"] == [1, 2]
    q = wal / "delta" / "quarantine"
    assert (q / "step_1").exists() and (q / "step_2").exists()
    assert m1.n == port_index.n + 4

    m2 = MutableIndex.load(wal, device="cpu")  # now-clean log, strict load
    s1, s2 = m1.freeze(), m2.freeze()
    assert m1.n == m2.n
    np.testing.assert_array_equal(s1.db_packed[:m1.n], s2.db_packed[:m2.n])
    np.testing.assert_array_equal(s1.graph.base_adjacency[:m1.n],
                                  s2.graph.base_adjacency[:m2.n])


def test_wal_gap_detected_and_quarantined(tmp_path, port_index):
    wal, _ = _wal(tmp_path, port_index)
    shutil.rmtree(wal / "delta" / "step_1")
    with pytest.raises(CorruptArtifactError, match="gap"):
        MutableIndex.load(wal, device="cpu")
    rep = delta.recover(wal)
    assert rep["good"] == [0] and rep["quarantined"] == [2]
    assert MutableIndex.load(wal, device="cpu").n == port_index.n + 4


def test_wal_lost_manifest_detected(tmp_path, port_index):
    wal, _ = _wal(tmp_path, port_index)
    (wal / "delta" / "step_2" / "manifest.json").unlink()
    with pytest.raises(CorruptArtifactError, match="step_2"):
        MutableIndex.load(wal, device="cpu")
    rep = delta.recover(wal)
    assert rep["good"] == [0, 1] and rep["quarantined"] == [2]


def test_wal_torn_flush_loses_only_unacked(tmp_path, port_index):
    wal, mi = _wal(tmp_path, port_index, n_segments=2)
    mi.append(np.zeros((4, port_index.dim), np.float32))
    with active_plan(FaultPlan({"ckpt.write_arrays":
                                FaultSpec("torn_write", at=(0,))})):
        with pytest.raises(InjectedCrash):
            mi.save_delta(wal)                 # the flush the process died in
    m = MutableIndex.load(wal, recover=True, device="cpu")
    assert m.recovery_report["reason"] is None
    assert m.n == port_index.n + 8             # both acked segments survive


def test_injected_fault_types_are_the_ports_own():
    """A plan of one package never fires in the other's points."""
    with jfaults.active_plan(jfaults.FaultPlan(
            {"p.x": jfaults.FaultSpec("raise", at=(0,))})):
        fault_point("p.x")                     # the port has no plan installed
    with active_plan(FaultPlan({"p.x": FaultSpec("raise", at=(0,))})):
        with pytest.raises(InjectedFault):
            fault_point("p.x")
