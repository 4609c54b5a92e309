"""The port's sharded search against the JAX package's sharded search.

The JAX package's sharded search needs a mesh of 4 devices, which its own
tests get from fake XLA host devices in a subprocess (the main test process
holds one).  One subprocess here loads the saved unit index, runs the
reference's ``searcher("sharded")`` on mesh (1, 4) for every case and writes
the results to an npz; the port's ``LocalShards`` search at C = 4 over the
same artifact must match each case: mean id overlap@10 >= 0.99 and
distances of shared ids within rtol 3e-5 / atol 2e-4.  At ``compact=0.5``
and with ``overlap=True`` the sharded and local searches differ, so only
this comparison shows the port's per-shard compaction and overlap pipeline
are the reference's.
"""
import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.index as jix
from repro.data.synthetic import VecDB as JaxVecDB
from repro_torch.data.synthetic import DATASETS, _generate
from repro_torch.index import SearchParams, from_arrays
from repro_torch.kernels.check import ATOL, RTOL

SRC = str(Path(__file__).parent.parent / "src")
N_Q = 32
# case: (SearchParams fields, overlap)
CASES = {
    "f32-compact0.5": (dict(), False),
    "f32-overlap": (dict(), True),
    "f32-overlap-compact1": (dict(compact=1.0), True),
    "packed-compact0.5": (dict(storage="packed"), False),
    "tiered-compact0.5": (dict(storage="tiered"), False),
}

_RUN = r"""
import json, sys
import numpy as np, jax
from repro.index import Index, SearchParams
path, out, cases = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
idx = Index.load(path)
q = np.load(path + "/queries.npy")
mesh = jax.make_mesh((1, 4), ("data", "model"))
res = {}
for name, (fields, overlap) in cases.items():
    params = SearchParams(ef=48, k=10, **fields)
    r = idx.searcher("sharded", params, mesh=mesh, overlap=overlap)(q)
    res[name + "/ids"], res[name + "/dists"] = r.ids, r.dists
np.savez(out, **res)
print("DONE", len(jax.devices()))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(port index, queries, {case: JAX sharded result}) over the unit index
    the JAX package built."""
    spec = DATASETS["unit"]
    d = _generate(spec, 0, device="cpu")
    nq = spec.n_queries
    db = JaxVecDB(name="unit", vectors=d["vectors"], queries=d["queries"][:nq],
                  train_queries=d["queries"][nq:], metric=spec.metric, gt=d["gt"])
    ref = jix.Index.build(db, jix.IndexSpec.for_db(db, m=8, dfloat_recall_target=0.8,
                                                   dfloat_proxy=True),
                          cache_key=f"torch-parity/unit/{zlib.crc32(db.vectors.tobytes())}")
    path = tmp_path_factory.mktemp("jax_unit_sharded")
    ref.save(path)
    q = db.queries[:N_Q]
    np.save(path / "queries.npy", q)
    out = path / "sharded.npz"
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    r = subprocess.run([sys.executable, "-c", _RUN, str(path), str(out), json.dumps(CASES)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0 and "DONE 4" in r.stdout, (r.stdout[-1500:], r.stderr[-2500:])
    meta = json.loads((path / "spec.json").read_text())
    with np.load(path / "arrays.npz") as z:
        port = from_arrays(meta, {k: z[k] for k in z.files}, "cpu")
    with np.load(out) as z:
        want = {name: (z[name + "/ids"], z[name + "/dists"]) for name in CASES}
    return port, q, want


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_matches_jax_sharded(reference, case):
    port, q, want = reference
    fields, overlap = CASES[case]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = port.searcher("sharded", SearchParams(ef=48, k=10, **fields),
                            n_shards=4, overlap=overlap)(q)
    finally:
        torch.set_num_threads(n)
    ids, dists = want[case]
    frac = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                    for a, b in zip(got.ids, ids)])
    assert frac >= 0.99, frac
    for gi, gd, wi, wd in zip(got.ids, got.dists, ids, dists):
        shared = np.intersect1d(gi[gi >= 0], wi[wi >= 0])
        np.testing.assert_allclose(gd[[gi.tolist().index(s) for s in shared]],
                                   wd[[wi.tolist().index(s) for s in shared]],
                                   rtol=RTOL, atol=ATOL)
