"""Port offline build and Index API vs the JAX package's.

The same numpy arrays go into both packages' ``Index.build`` (the port on
the CPU).  The sPCA rotation, the FEE fit, the Dfloat config and the packed
bitstream are host numpy code in both, so they must agree exactly; the graph
takes its products in torch, so its levels must agree on >= 99% of rows (a
row may differ only where two distances tie within float32 rounding).
Artifacts written by either package load in the other.
"""
import dataclasses
import json
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.index as jix
from repro.data.synthetic import VecDB as JaxVecDB
from repro_torch.core.fee import FeeParams
from repro_torch.core.graph import build_graph
from repro_torch.data.synthetic import (DATASETS, VecDB, _generate, exact_topk,
                                        make_dataset)
from repro_torch.index import CorruptArtifactError, Index, IndexSpec, SearchParams

ROOT = Path(__file__).resolve().parents[1]
PARAMS = SearchParams(ef=48, k=10)


def _overlap(a, b):
    return float(np.mean([len(set(x.tolist()) & set(y.tolist())) / a.shape[1]
                          for x, y in zip(a, b)]))


@pytest.fixture(scope="module")
def built():
    """{metric: (port db, jax db, port index, jax index)} from one set of
    arrays per metric."""
    out = {}
    for metric, name in (("l2", "unit"), ("ip", "unit_ip")):
        spec = DATASETS[name]
        d = _generate(spec, 1, device="cpu")
        nq = spec.n_queries
        arrays = dict(name=name, vectors=d["vectors"], queries=d["queries"][:nq],
                      train_queries=d["queries"][nq:], metric=spec.metric,
                      gt=d["gt"])
        tdb, jdb = VecDB(**arrays), JaxVecDB(**arrays)
        fields = dict(m=8, dfloat_recall_target=0.8, dfloat_proxy=True)
        ref = jix.Index.build(jdb, jix.IndexSpec.for_db(jdb, **fields),
                              cache_key=f"torch-parity-build/{name}/"
                              f"{zlib.crc32(jdb.vectors.tobytes())}")
        port = Index.build(tdb, IndexSpec.for_db(tdb, **fields), device="cpu")
        out[metric] = (tdb, jdb, port, ref)
    return out


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_build_matches_jax(built, metric):
    _, _, port, ref = built[metric]
    for f in ("mean", "components", "eigvals"):
        assert np.array_equal(getattr(port.spca, f), getattr(ref.spca, f)), f
    for f in ("alpha", "beta", "margin", "var_k"):
        assert np.array_equal(getattr(port.fee, f), getattr(ref.fee, f)), f
    assert ([dataclasses.astuple(s) for s in port.dfloat_cfg.segments]
            == [dataclasses.astuple(s) for s in ref.dfloat_cfg.segments])
    assert port.dfloat_cfg.segments[0].n_man < 23         # not the fp32 layout
    assert np.array_equal(port.db_rot, ref.db_rot)
    assert np.array_equal(port.db_packed, ref.db_packed)
    assert port.graph.entry == ref.graph.entry
    assert len(port.graph.levels) == len(ref.graph.levels)
    for (pi, pa), (ri, ra) in zip(port.graph.levels, ref.graph.levels):
        assert np.array_equal(pi, ri)
        assert pa.shape == ra.shape and pa.dtype == np.int32
        assert (pa == ra).all(1).mean() >= 0.99


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_exact_topk_matches_jax(built, metric):
    from repro.data.synthetic import exact_topk as jax_exact_topk

    tdb, *_ = built[metric]
    got = exact_topk(tdb.vectors, tdb.queries, 20, metric, device="cpu")
    want = jax_exact_topk(tdb.vectors, tdb.queries, 20, metric)
    assert (got == want).mean() >= 0.99


def test_jax_artifact_serves_the_same_ids_in_the_port(built, tmp_path):
    tdb, _, _, ref = built["l2"]
    path = ref.save(tmp_path / "jax.naszip")
    loaded = Index.load(path, device="cpu")
    assert np.array_equal(loaded.db_packed, ref.db_packed)
    for storage in ("f32", "packed"):
        params = dataclasses.replace(PARAMS, storage=storage)
        want = ref.search(tdb.queries, jix.SearchParams(**dataclasses.asdict(params)))
        got = loaded.search(tdb.queries, params)
        assert _overlap(got.ids, want.ids) >= 0.99


def test_port_artifact_loads_in_jax(built, tmp_path):
    tdb, _, port, _ = built["ip"]
    path = port.save(tmp_path / "port.naszip")
    assert json.loads((path / "spec.json").read_text())["format_version"] == 3
    ref = jix.Index.load(path)
    assert np.array_equal(ref.db_packed, port.db_packed)
    assert ref.graph.entry == port.graph.entry
    got = port.search(tdb.queries, PARAMS)
    want = ref.search(tdb.queries, jix.SearchParams(**dataclasses.asdict(PARAMS)))
    assert _overlap(got.ids, want.ids) >= 0.99
    # and the port reads back its own artifact bit for bit
    again = Index.load(path, device="cpu")
    for a, b in zip(again.graph.levels, port.graph.levels):
        assert np.array_equal(a[1], b[1])
    assert np.array_equal(again.search(tdb.queries, PARAMS).ids, got.ids)


@pytest.mark.parametrize("version", [1, 2])
def test_older_formats_load(built, tmp_path, version):
    tdb, _, port, _ = built["l2"]
    path = port.save(tmp_path / f"v{version}.naszip")
    meta = json.loads((path / "spec.json").read_text())
    meta["format_version"] = version
    (path / "spec.json").write_text(json.dumps(meta))
    if version == 1:                     # v1 also carried the derived db_q
        with np.load(path / "arrays.npz") as z:
            arrays = {k: z[k] for k in z.files}
        np.savez_compressed(path / "arrays.npz", db_q=port.db_q, **arrays)
    loaded = Index.load(path, device="cpu")
    assert (loaded._db_q is not None) == (version == 1)
    assert np.array_equal(loaded.search(tdb.queries, PARAMS).ids,
                          port.search(tdb.queries, PARAMS).ids)


def test_corrupt_artifact_is_refused(built, tmp_path):
    _, _, port, _ = built["l2"]
    path = port.save(tmp_path / "bad.naszip")
    with np.load(path / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    arrays["db_packed"] = arrays["db_packed"].copy()
    arrays["db_packed"][3, 1] ^= np.uint32(1 << 7)
    np.savez_compressed(path / "arrays.npz", **arrays)
    with pytest.raises(CorruptArtifactError, match="db_packed"):
        Index.load(path, device="cpu")


def test_import_leaves_jax_and_repro_out():
    code = ("import sys; import repro_torch, repro_torch.index, repro_torch.kernels.ops, "
            "repro_torch.kernels._build, repro_torch.utils, repro_torch.ndpsim, "
            "repro_torch.obs, repro_torch.resilience.faults, repro_torch.ft.checkpoint, "
            "repro_torch.streaming, repro_torch.launch.churn, repro_torch.serve, "
            "repro_torch.index.device, repro_torch.launch.serve, repro_torch.launch.chaos, "
            "chip_smoke; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad")
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT,
                   timeout=120)


def test_entry_points_raise_without_a_card(built, tmp_path, monkeypatch):
    tdb, _, port, _ = built["l2"]
    path = port.save(tmp_path / "i.naszip")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Index.build(tdb, IndexSpec.for_db(tdb, m=8, dfloat_recall_target=None))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Index.load(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.searcher("local", PARAMS, device="cuda")
    # streaming: a MutableIndex over a card index, its loader and the churn
    # driver
    from repro_torch.launch import churn
    from repro_torch.streaming import MutableIndex

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MutableIndex(dataclasses.replace(port, device=torch.device("cuda")))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MutableIndex.load(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        churn.main([])
    # the serving and chaos drivers run on --device, default cuda
    from repro_torch.launch import chaos, serve

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        chaos.main(["--workdir", str(tmp_path / "chaos")])
    # the data and graph helpers and the FEE device views default to the card too
    for call in (lambda: make_dataset("unit", cache=False),
                 lambda: _generate(DATASETS["unit"]),
                 lambda: exact_topk(tdb.vectors, tdb.queries, 5, "l2"),
                 lambda: build_graph(tdb.vectors[:100], m=4),
                 lambda: port.fee.params(),
                 lambda: FeeParams.identity(4)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
