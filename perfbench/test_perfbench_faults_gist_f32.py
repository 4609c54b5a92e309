"""Whole runs on the CPU at a tiny size of the gist packed cell and the sift
f32 cell, as ``test_perfbench_faults.py`` makes them for sift's packed
cells: sound, traced and untraced, each comes out correct under its
configuration's limits; with the timed path broken underneath, it does not.

The tiny gist configuration keeps its 960 dims in 60 FEE segments and its
generator statistics at 2,000 rows. Each tiny configuration's index is
built once a test run, which keeps gist's cases to tens of seconds here.
"""
import copy

import pytest
import torch

from perfbench import harness
from perfbench import test_perfbench_faults as base

CELLS = ["gist-960-euclidean.batch-packed", "sift-128-euclidean.batch-f32"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


_BUILT = {}


@pytest.fixture(autouse=True)
def _one_build_per_configuration(monkeypatch):
    """Every case makes the same rows from ``SEED`` and the build reads no
    traffic, so one index serves them all; a case's patch replaces
    attributes of its own shallow copy only."""
    build = harness.build_index

    def once(config, inputs, device):
        key = (harness.graph_key(config), str(device))
        if key not in _BUILT:
            _BUILT[key] = build(config, inputs, device)
        return copy.copy(_BUILT[key])

    monkeypatch.setattr(harness, "build_index", once)


def test_tiny_cells_keep_their_shape():
    config = base.tiny("gist-960-euclidean.batch-packed").config
    assert config["data"]["dim"] == 960 and config["data"]["n"] == 2000
    traffic = base.tiny("sift-128-euclidean.batch-f32").traffic
    assert traffic["params"]["storage"] == "f32"


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, trace):
    out = base.run(cell, trace=trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    if trace:
        # no card here: the readers of device numbers return nothing
        assert out["device"]["window_s"] > 0 and "breakdown" in out
        assert set(out["metrics"]) <= {"search.dims_per_eval"}
    else:
        assert {"recall_at_10", "setup_s"} <= set(out["metrics"])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(base.FAULTS))
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    if fault == "beam_unchanged":
        base._hop_keeps_its_beam(monkeypatch)
    out = base.run(cell, patch=base.FAULTS[fault])
    assert not out["correct"], out["checks"]
