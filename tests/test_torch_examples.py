"""The port's package surface and its twins of the JAX package's examples.

- Surface: the ``data``, ``core`` and ``ft`` packages re-export what the
  reference's ``__init__``s name; every module of the port can be the first
  one a program imports (no import cycle); every public name of every
  reference module exists in its port, but for the JAX- and TPU-only ones
  (and one unused constant) listed in ``NO_COUNTERPART``; the only reference module without a port is
  ``distributed/compat.py`` (a JAX-version bridge).
- ``utils.tree_params`` / ``tree_bytes`` equal the reference's over the
  same weights (the 10 smoke configs, carried across with
  ``models/convert.py``), and ``tree_params`` equals ``param_count``;
  ``cached_json`` builds once, then reads back.
- ``kernels/ref.py::fee_search_semantics_ref`` against the reference's at
  ``tests/test_kernels.py``'s rtol 3e-5 / atol 2e-4 (exits exact but for
  lanes within that tolerance of the threshold:
  ``repro_torch.kernels.check.compare_fee``).
- ``launch/quickstart.py --tiny --device cpu`` against the same steps run
  through ``repro.index`` on the same arrays: Dfloat segments and bursts a
  vector equal, recall@10 within 0.01 (kNN ties, the 1% of
  ``test_torch_index.py::test_build_matches_jax``), packed ids == f32 ids
  in both.
- ``launch/distributed_search.py --device cpu``: DaM's partition width
  equals the reference's ``build_dam`` on the same adjacency; recall@10
  between the local search's at ``compact=0.5`` and at ``1.0``, +- 0.005
  (each shard keeps half of its own lanes, so the shards drop fewer than
  the local search's one budget).
"""
import ast
import dataclasses
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fee_cases import inputs
from repro import configs as JC
from repro import index as jix
from repro import utils as jutils
from repro.core import graph as jgraph
from repro.data.synthetic import VecDB as JaxVecDB
from repro.kernels import ref as jref
from repro.models.registry import get_model as jget_model
from repro_torch import configs as C
from repro_torch import utils
from repro_torch.data import make_dataset
from repro_torch.index import SearchParams
from repro_torch.kernels import ref
from repro_torch.kernels.check import SHAPES, compare_fee, near_threshold
from repro_torch.launch import distributed_search, quickstart
from repro_torch.models import get_model
from repro_torch.models.convert import from_jax_params

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
RECALL_TOL = 0.01
BAND = 0.005
# public names of the reference that serve JAX or a TPU and have no
# counterpart: Pallas kernels and jnp decoders, XLA lowering and HLO
# parsing, JAX mesh constructors and shardings, XLA's compilation cache, the
# TPU interconnect's rate; and one constant the reference defines but never
# reads (``kernels/fee_distance.py``'s ``BIG``: the port's sentinel is
# ``core.fee.BIG``)
NO_COUNTERPART = {
    "core/dfloat.py": {"decode_burst_quads_jnp", "decode_field_jnp", "unpack_rows_jnp"},
    "distributed/retrieval.py": {"abstract_db", "db_shardings"},
    "distributed/sharding.py": {"named"},
    "kernels/dfloat_unpack.py": {"dfloat_unpack_pallas"},
    "kernels/fee_distance.py": {"fee_distance_pallas", "fee_distance_skipdma_pallas",
                                "fee_distance_packed_pallas", "fee_distance_tiered_pallas",
                                "BIG"},
    "launch/dryrun.py": {"COLLECTIVES", "analyze", "build_cell", "build_retrieval_cell",
                         "parse_collectives", "sharded_bytes"},
    "launch/mesh.py": {"ICI_BW", "make_production_mesh"},
    "serve/__init__.py": {"enable_compilation_cache"},
    "serve/warmup.py": {"enable_compilation_cache"},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small models and indexes: run torch on one thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def modules(root: Path) -> set:
    return {p.relative_to(root).as_posix() for p in root.rglob("*.py")
            if "__pycache__" not in p.parts}


def public_names(path: Path) -> set:
    """Names a module binds at its top level (definitions, assignments and,
    in a package ``__init__``, its ``from`` imports: the re-exports),
    without a leading underscore."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            out.update(a.asname or a.name for a in node.names)
    return {n for n in out if not n.startswith("_")}


def module_name(rel: str) -> str:
    parts = ("repro_torch",) + Path(rel).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


@pytest.mark.parametrize("pkg", ["data", "core", "ft"])
def test_package_init_names_match_reference(pkg):
    import importlib

    want = public_names(REF / pkg / "__init__.py")
    assert want and public_names(PORT / pkg / "__init__.py") == want
    mod = importlib.import_module(f"repro_torch.{pkg}")
    assert all(hasattr(mod, n) for n in want), want


def test_module_list_and_public_names_match_reference():
    import importlib

    assert modules(REF) - modules(PORT) == {"distributed/compat.py"}
    missing = {}
    for rel in sorted(modules(REF) & modules(PORT)):
        mod = importlib.import_module(module_name(rel))
        gone = {n for n in public_names(REF / rel) if not hasattr(mod, n)}
        gone -= NO_COUNTERPART.get(rel, set())
        if gone:
            missing[rel] = sorted(gone)
    assert not missing, missing


def test_every_module_imports_first():
    """Each module of the port, imported first into a fresh package state,
    loads; then ``core``, ``ft`` and ``data`` carry their re-exports."""
    code = (
        "import importlib, pathlib, sys\n"
        f"root = pathlib.Path({str(PORT)!r})\n"
        "mods = sorted('.'.join(('repro_torch',) + p.relative_to(root).with_suffix('').parts)"
        ".removesuffix('.__init__') for p in root.rglob('*.py') if '__pycache__' not in p.parts)\n"
        "for m in mods:\n"
        "    for k in [k for k in sys.modules if k.split('.')[0] == 'repro_torch']:\n"
        "        del sys.modules[k]\n"
        "    importlib.import_module(m)\n"
        "    import repro_torch.core as c, repro_torch.ft as f\n"
        "    from repro_torch.data import DATASETS, VecDB, make_dataset\n"
        "    assert all(hasattr(c, n) for n in ('baselines', 'dfloat', 'fee', 'graph', 'pca', "
        "'search')), m\n"
        "    assert f.checkpoint and f.elastic, m\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = {"PYTHONPATH": f"{ROOT / 'src'}", "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert int(out.stdout.strip()) == len(modules(PORT))


@pytest.mark.parametrize("arch", list(C.ARCHS))
def test_tree_params_and_bytes_match_reference(arch):
    from repro_torch.utils import param_count

    cfg, jcfg = C.get_smoke(arch), JC.get_smoke(arch)
    tree = jax.device_get(jget_model(jcfg).init(jax.random.key(0)))
    params = from_jax_params(cfg, tree, "cpu")
    api = get_model(cfg, "cpu")
    want_params, want_bytes = jutils.tree_params(tree), jutils.tree_bytes(tree)
    for port_tree in (params, api.param_tree(params)):
        assert utils.tree_params(port_tree) == want_params
        assert utils.tree_bytes(port_tree) == want_bytes
    assert utils.tree_params(params) == param_count(params)
    # numpy leaves count as the reference's
    assert utils.tree_params({"a": [np.zeros((2, 3)), (np.ones(4, np.float16),)]}) == 10
    assert utils.tree_bytes({"a": [np.zeros((2, 3)), (np.ones(4, np.float16),)]}) == 56


def test_cached_json_builds_once(tmp_path, monkeypatch):
    monkeypatch.setattr(utils, "CACHE_DIR", tmp_path)
    calls = []

    def make():
        calls.append(1)
        return {"recall": 0.5, "ids": [1, 2, 3]}

    assert utils.cached_json("torch/test/json", make) == make()
    calls.clear()
    assert utils.cached_json("torch/test/json", make) == {"recall": 0.5, "ids": [1, 2, 3]}
    assert not calls
    assert utils.cache_path("torch/test/json", ".json").exists()


@pytest.mark.parametrize("c,d,seg", SHAPES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_fee_search_semantics_ref_matches_reference(c, d, seg, metric):
    q, x, thr, alpha, beta, margin = inputs(c, d, seg, metric, c + d)
    want = jref.fee_search_semantics_ref(q, x, np.float32(thr), alpha, beta, margin,
                                         seg=seg, metric=metric)
    t = lambda a: torch.from_numpy(np.array(a))
    got = ref.fee_search_semantics_ref(t(q), t(x), thr, t(alpha), t(beta), t(margin),
                                       seg=seg, metric=metric)
    near = near_threshold(x, q, thr, alpha, beta, margin, seg=seg, metric=metric)
    compare_fee(got, [np.asarray(a) for a in want], near, "fee_search_semantics_ref")
    # survivors score their full distance, as the early-exit contract's do
    early = ref.fee_distance_ref(t(q), t(x), thr, t(alpha), t(beta), t(margin),
                                 seg=seg, metric=metric)
    alive = ~got[1]
    assert torch.equal(got[0][alive], early[0][alive])


def test_quickstart_tiny_matches_reference(capsys):
    got = quickstart.main(["--tiny", "--device", "cpu"])
    out = capsys.readouterr().out
    for step in ("[1/4] dataset unit", "[2/4] index built", "[3/4] save/load round trip",
                 "[4/4] search ef=64", "dims touched per eval", "neighbor ids bit-identical"):
        assert step in out, step
    db = make_dataset("unit", device="cpu")
    jdb = JaxVecDB(**{f.name: getattr(db, f.name) for f in dataclasses.fields(db)})
    spec = jix.IndexSpec.for_db(jdb, m=8, dfloat_recall_target=0.85, dfloat_proxy=True)
    # a key of these arrays: the reference caches a graph by name and size
    # when given none, and its own "unit" rows differ from the port's
    idx = jix.Index.build(jdb, spec, cache_key="torch-parity/quickstart/"
                          f"{zlib.crc32(jdb.vectors.tobytes())}")
    assert got["dfloat_segments"] == [(s.width, s.n_dims) for s in idx.dfloat_cfg.segments]
    assert got["bursts_per_vector"] == idx.dfloat_cfg.bursts_per_vector()
    assert got["packed_bytes_per_vector"] == 4 * idx.db_packed.shape[1]
    want = idx.evaluate(jdb, jix.SearchParams(ef=64, k=10))["recall"]
    assert abs(got["recall_at_10"] - want) <= RECALL_TOL, (got["recall_at_10"], want)
    f32 = idx.search(jdb.queries[:48], jix.SearchParams(ef=64, k=10))
    pk = idx.search(jdb.queries[:48], jix.SearchParams(ef=64, k=10, storage="packed"))
    assert np.array_equal(pk.ids, f32.ids) and got["packed_ids_equal"]


def test_distributed_search_matches_reference(capsys):
    got = distributed_search.main(["--device", "cpu"])
    assert "sharded search recall@10" in capsys.readouterr().out
    db, idx = distributed_search.build("cpu")
    owner = jgraph.map_owners(db.n, 4, "shuffle")
    dam = jgraph.build_dam(idx.graph.base_adjacency, owner, 4)
    assert got["partition_width"] == dam.max_part_width()
    local = {c: idx.search(db.queries, SearchParams(ef=48, k=10, use_dfloat=False,
                                                    compact=c), device="cpu").recall(db.gt, 10)
             for c in (0.5, 1.0)}
    assert local[0.5] - BAND <= got["recall_at_10"] <= local[1.0] + BAND, (got, local)
    assert got == distributed_search.report(db, idx, 4, "cpu")
