"""The port's dry run (``repro_torch.launch.dryrun``) and its report.

- ``analytic_memory`` equals the reference's on every term and on
  ``total_gb`` for all 64 applicable (arch x shape x mesh) cells of both
  production meshes (16 x 16 and 2 x 16 x 16).  The reference runs in a
  subprocess (its module sets ``XLA_FLAGS`` for 512 host devices when
  imported) with a duck-typed mesh (``axis_names`` and ``devices.shape``);
  the port reads a ``MeshShape``.  The fit reads the card's 80 GB.
- The meta pass of llama3.2-1b's train_4k, prefill_32k and decode_32k
  cells at 16 x 16 (one rank's step on the meta device, recovered from 1
  and 2 layer groups): positive FLOPs and collective bytes, and state
  bytes equal to ``analytic_memory``'s (params and opt, or params and the
  cache, whose ``pos`` the port keeps on the host).
- The retrieval cell's per-rank state at the reference's BigANN-1B shape,
  the command line's record, and ``launch/report.py``'s table.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch import configs as C
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, mesh as mesh_mod, report
from repro_torch.models import get_model
from repro_torch.models.convert import cache_tree

HERE = Path(__file__).parent
SRC = str(HERE.parent / "src")
GB = 2**30

_REFERENCE = r"""
import json, sys, types
import numpy as np
from repro import configs as C
from repro.launch import dryrun
out = {}
for multi in (False, True):
    shape = (2, 16, 16) if multi else (16, 16)
    names = ("pod", "data", "model") if multi else ("data", "model")
    mesh = types.SimpleNamespace(axis_names=names, devices=np.empty(shape, object))
    for arch, s, ok, _ in C.cells():
        out[f"{arch}|{s}|{'x'.join(map(str, shape))}"] = dryrun.analytic_memory(arch, s, mesh)
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's ``analytic_memory`` of every applicable cell, in a
    subprocess started first (read when a test asks for it)."""
    out = tmp_path_factory.mktemp("dry_ref") / "ref.json"
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(out)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"})
    cache = {}

    def get():
        if not cache:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            cache.update(json.loads(out.read_text()))
        return cache

    yield get
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def cells(tmp_path_factory, reference):
    """The meta pass of llama3.2-1b's three cells at 16 x 16, written by
    ``run_cell`` (the reference's analytic run alongside)."""
    d = tmp_path_factory.mktemp("dry")
    return d, {s: dryrun.run_cell("llama3.2-1b", s, False, out_dir=d)
               for s in ("train_4k", "prefill_32k", "decode_32k")}


def test_analytic_memory_matches_reference_on_every_cell(reference, cells):
    want = reference()          # (``cells`` ran the meta passes while the reference ran)
    assert len(want) == 64
    for key, w in want.items():
        arch, s, mesh = key.split("|")
        shape = tuple(int(x) for x in mesh.split("x"))
        got = dryrun.analytic_memory(arch, s, mesh_mod.MeshShape(
            shape, mesh_mod.axis_names(len(shape))))
        terms = {k: v for k, v in w.items() if k.endswith("_gb")}
        assert {k: got[k] for k in got if k.endswith("_gb")} == terms, key
        assert got["fits_hbm"] == (got["total_gb"] * GB <= 80e9), key


def test_jamba_serve_cells_grow_on_two_pods():
    """jamba-1.5-large-398b's 16 experts lie over the data axes in serve
    mode: 16-way at 16 x 16, but 32 does not divide 16, so at 2 x 16 x 16
    the experts are whole on every rank (a finding about the rules)."""
    got = {}
    for shape in ((16, 16), (2, 16, 16)):
        mesh = mesh_mod.MeshShape(shape, mesh_mod.axis_names(len(shape)))
        got[len(shape)] = [dryrun.analytic_memory("jamba-1.5-large-398b", s, mesh)["total_gb"]
                           for s in ("prefill_32k", "decode_32k", "long_500k")]
    assert [round(x, 1) for x in got[2]] == [16.5, 9.0, 9.5]
    assert [round(x, 1) for x in got[3]] == [50.4, 46.7, 47.4]


def test_analytic_memory_takes_a_shape_spec():
    spec = C.ShapeSpec("mine", 32768, 128, "decode")
    mesh = mesh_mod.production_mesh_shape()
    assert (dryrun.analytic_memory("llama3.2-1b", spec, mesh)
            == dryrun.analytic_memory("llama3.2-1b", "decode_32k", mesh))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_meta_pass_cells(cells, shape):
    _, recs = cells
    r = recs[shape]
    assert r["ok"], r.get("traceback")
    assert r["mode"] == ("train" if shape == "train_4k" else "serve")
    assert r["flops"] > 0 and r["collectives"]["total_bytes"] > 0
    assert r["collectives"]["total_count"] == sum(
        v["count"] for k, v in r["collectives"].items() if isinstance(v, dict) and k != "by_axis")
    ana = r["analytic_memory"]
    st = r["state"]
    assert round(st["params_bytes"] / GB, 3) == ana["params_gb"]
    if shape == "train_4k":
        assert round(st["opt_bytes"] / GB, 3) == ana["opt_gb"]
        assert "all_gather data" in r["collectives"]["by_axis"]   # FSDP gathers
    else:
        # the rules count the cache's 0-d int32 ``pos``; the port's is a host int
        mesh = mesh_mod.production_mesh_shape()
        cfg = C.get_config("llama3.2-1b")
        tree = cache_tree(cfg, get_model(cfg, "cpu").abstract_cache(
            C.SHAPES[shape].global_batch, C.SHAPES[shape].seq_len))
        assert st["cache_bytes"] + 4 == sh.sharded_bytes(tree, sh.cache_specs(tree, mesh), mesh)
        assert not any(k.endswith(" data") and k.startswith("all_gather")
                       for k in r["collectives"]["by_axis"])             # no weight moves


def test_decode_cell_from_the_command_line(tmp_path, capsys):
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "llama3.2-1b__decode_32k__single.json").read_text())
    assert rec["ok"] and rec["state"]["params_bytes"] > 0 and rec["flops"] > 0
    assert rec["collectives"]["all_reduce"]["bytes"] > 0
    assert json.loads(capsys.readouterr().out)["ok"]


def test_retrieval_cell_and_skipped_cell(tmp_path):
    rec = dryrun.run_cell("retrieval-bigann1b", "search", False, out_dir=tmp_path)
    assert rec["ok"] and rec["meta_pass"] is None and rec["why_no_meta_pass"]
    n_loc = -(-1_000_000_000 // 16)
    assert rec["state"]["vectors"] == n_loc * 128 * 2
    assert rec["state"]["part_adj"] == 1_000_000_000 * 8 * 4
    skip = dryrun.run_cell("llama3.2-1b", "long_500k", False, out_dir=tmp_path)
    assert skip["skipped"] and not skip["ok"]


def test_report_renders(cells):
    d, _ = cells
    bad = dict(arch="qwen3-8b", shape="train_4k", mesh="16x16", ok=False, skipped=False,
               error="RuntimeError: planted")
    (d / "qwen3-8b__train_4k__single.json").write_text(json.dumps(bad))
    dryrun.run_cell("retrieval-bigann1b", "search", False, out_dir=d)
    table = report.dryrun_table(dry_dir=d)
    lines = table.splitlines()
    assert lines[0].split()[:4] == ["arch", "shape", "16x16", "2x16x16"]
    rows = {tuple(line.split()[:2]): line.split() for line in lines[1:]}
    assert rows[("llama3.2-1b", "decode_32k")][2:4] == ["OK", "-"]
    assert rows[("qwen3-8b", "train_4k")][2] == "FAIL"
    assert rows[("retrieval-bigann1b", "search")][2] == "OK"
    md = report.dryrun_table(markdown=True, dry_dir=d)
    assert md.startswith("| arch | shape |") and md.count("\n") == len(lines)
