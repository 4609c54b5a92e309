"""The port's train step on a (data, model) mesh of gloo ranks against its
one-process step and against the reference's jitted one-process step.

The layouts of one rank count run in one spawn of ranks
(``tests/torch_mesh_ranks.py``, ``repro_torch.training.mesh_check.
step_case``), each mesh built in turn over the same ranks and holding every
case of its layout (starting a rank costs more than its cases): all ranks
draw the same seeded smoke weights and keep their blocks of the sharding
rules' layout, take 3 steps (B = 4, T = 16, lr 1e-3) on the same global
batches, and rank 0 holds the loss, ``grad_norm`` and every gathered
parameter against the port's one-process step from the same weights on
the same batches, and writes the initial and final weights.  Bounds
(``test_torch_train_step.py``'s): the loss within 1e-5 relative,
``grad_norm`` within 1e-3, the parameters within ``rtol=2e-4, atol=2e-5``
on all but 1e-4 of the elements (2e-4 with compression) and every element
within that plus 0.25 lr (2 lr with compression).

``test_mesh_step_matches_reference`` holds them to the reference's jitted
one-process ``make_train_step`` from the same weights (carried across as
the reference's tree; every run's initial weights are checked equal to
them) on the same batches, run once a case in a subprocess alongside the
ranks, for every layout that ran the case: every case but MoE on D > 1
data ranks (below), with the bounds above except that every element is
held within the tight bound plus 2 lr (``test_torch_train_step.py``'s cap
with a bfloat16 accumulator or compression).  AdamW moves an element whose gradient is at
the level of float32 rounding by up to lr a step in a direction rounding
sets, and these inputs hold such elements: llava's ``blocks/pos0/mlp/wg``
[1, 37, 24] has a first gradient of 2e-9 (3e-8 of its leaf's largest) and
ends 0.565 lr beyond the tight bound in the port's one-process step as in
the mesh step, one element of 65,536.  (The reference's own mesh trainer
raises ``ShardingTypeError`` on this JAX.)

Layouts: every smoke architecture with its config's optimizer at (2, 1)
and (1, 2); llama3.2-1b, qwen2-moe-a2.7b and jamba at (2, 2), (4, 1) and
(1, 4); at (2, 2) also a dense and a MoE architecture with Adafactor, with
gradient compression and at microbatch 2; at (1, 4) a GQA llama whose wq
the rules split over ``model`` and whose wk and wv they leave whole.  MoE
on D > 1 data ranks groups its tokens into D chunks (a rank's rows are
its chunk), so the one-process
step runs under a ``MeshShape`` of the layout (``dp_size()`` = D), and the
port's ``moe_ffn`` under it, and its gradients, are held against the
reference's ``moe_ffn`` under a (D, 1) mesh of fake XLA devices in a
subprocess.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as C
from repro_torch.distributed.axes import use_mesh
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import convert
from repro_torch.models import moe
from torch_mesh_ranks import arrays_path

HERE = Path(__file__).parent
SRC = str(HERE.parent / "src")
LOSS_TOL, GNORM_TOL = 1e-5, 1e-3
REF_CAP = 2.0        # against the reference: every element within the tight bound + 2 lr

THREE = ("llama3.2-1b", "qwen2-moe-a2.7b", "jamba-1.5-large-398b")
# one KV head of 6: at model 4 the rules split wq (48 outputs) and leave wk
# and wv (6) whole
GQA = dict(n_heads=8, n_kv_heads=1, d_head=6)
EXTRA = ([dict(arch=a, optimizer="adafactor") for a in ("llama3.2-1b", "qwen2-moe-a2.7b")]
         + [dict(arch=a, compress=True) for a in ("llama3.2-1b", "qwen2-moe-a2.7b")]
         + [dict(arch=a, microbatch=2) for a in ("llama3.2-1b", "qwen2-moe-a2.7b")])
LAYOUTS = {
    "2x1": [dict(arch=a) for a in C.ARCHS],
    "1x2": [dict(arch=a) for a in C.ARCHS],
    "2x2": [dict(arch=a) for a in THREE] + EXTRA,
    "4x1": [dict(arch=a) for a in THREE],
    "1x4": [dict(arch=a) for a in THREE] + [dict(arch="llama3.2-1b", config=GQA)],
}
CASES = [(layout, i) for layout, cases in LAYOUTS.items() for i in range(len(cases))]


def _name(case: dict) -> str:
    return "-".join([case["arch"]] + [f"{k}={v}" for k, v in case.items()
                                      if k not in ("arch", "config")]
                    + (["gqa-split-wq-whole-wk"] if case.get("config") else []))


def test_gqa_case_splits_wq_and_not_wk():
    """The GQA case of the (1, 4) layout stores wq split over ``model`` and
    wk whole (the rules leave a dimension the axis does not divide)."""
    import dataclasses

    from repro_torch.distributed import sharding as sh
    from repro_torch.models import get_model

    cfg = dataclasses.replace(C.get_smoke("llama3.2-1b"), **GQA)
    api = get_model(cfg, "cpu")
    specs = sh.param_specs(api.param_tree(api.abstract_params()),
                           MeshShape((1, 4), ("data", "model")))
    attn = specs["blocks"]["pos0"]["attn"]
    assert attn["wq"][2] == "model" and attn["wk"][2] is None and attn["wv"][2] is None


def _ranks(layout: str) -> int:
    return int(np.prod([int(x) for x in layout.split("x")]))


@pytest.fixture(scope="module")
def layout_results(tmp_path_factory, reference_steps):
    """The spawn of the layouts of one rank count (2 or 4), run when a case
    of one of them first asks for it (after the reference's steps have
    started alongside)."""
    cache, outs = {}, {}

    def get(layout):
        if layout not in cache:
            n = _ranks(layout)
            group = {k: v for k, v in LAYOUTS.items() if _ranks(k) == n}
            out = tmp_path_factory.mktemp(f"mesh_{n}_ranks") / "res.json"
            r = subprocess.run([sys.executable, str(HERE / "torch_mesh_ranks.py"), "steps",
                                str(out), json.dumps(group)],
                               capture_output=True, text=True, timeout=400,
                               env={**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"})
            assert r.returncode == 0, r.stderr[-3000:]
            cache.update(json.loads(out.read_text()))
            outs.update({k: out for k in group})
        return cache[layout]

    def arrays(layout, i):
        get(layout)
        return arrays_path(outs[layout], layout, i)

    get.arrays = arrays
    return get


@pytest.mark.parametrize("layout,i", CASES,
                         ids=[f"{lay}-{_name(LAYOUTS[lay][i])}" for lay, i in CASES])
def test_mesh_step_matches_one_process(layout_results, layout, i):
    res = layout_results(layout)[i]
    case = LAYOUTS[layout][i]
    assert res["case"]["arch"] == case["arch"] and res["mesh"] == [int(x) for x in
                                                                    layout.split("x")]
    loose = case.get("compress", False)
    share, c = (2e-4, 2.0) if loose else (1e-4, 0.25)
    assert res["loss"] <= LOSS_TOL, res
    assert res["grad_norm"] <= GNORM_TOL, res
    assert res["share"] <= share, res
    assert res["over_lr"] <= c, res


MOE = {a for a in C.ARCHS if C.get_smoke(a).moe_experts}


def _key(case: dict) -> str:
    return json.dumps(case, sort_keys=True)


# the runs the reference's one-process jitted step is held against, by case:
# every case but MoE on D > 1 data ranks (which groups its tokens into D
# chunks where the reference's one-process step groups them in one; held
# by the port's step under the layout's shape and the gradient of the
# reference's moe_ffn under a (D, 1) mesh below)
REF_RUNS = {}
for _layout, _cases in LAYOUTS.items():
    for _i, _case in enumerate(_cases):
        if _layout.startswith("1x") or _case["arch"] not in MOE:
            REF_RUNS.setdefault(_key(_case), []).append((_layout, _i))


# the reference's jitted one-process step from the port's seeded smoke
# weights (``mesh_check.step_case``'s, carried across as the reference's
# tree) on a case's batches, one request a case; writes the initial
# weights ("init/" + the leaf's path), the losses, the grad norms and the
# final weights ("final/" + the path) of each
_JAX_STEPS = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs as JC
from repro.models.registry import get_model as jget_model
from repro.training import GradCompressor, OptConfig, init_state, make_train_step
from repro_torch import configs as C
from repro_torch.distributed.sharding import flat
from repro_torch.models import get_model
from repro_torch.models.convert import params_to_numpy
from repro_torch.training.check import train_batch
from repro_torch.training.mesh_check import Case

for r in json.loads(open(sys.argv[1]).read()):
    c = Case(**r["case"])
    jcfg = dataclasses.replace(JC.get_smoke(c.arch), **c.config)
    cfg = dataclasses.replace(C.get_smoke(c.arch), **c.config)
    api = get_model(cfg, "cpu")
    init = params_to_numpy(cfg, api.init(api.generator(0)))
    jo = OptConfig(name=c.optimizer or jcfg.optimizer, lr=c.lr)
    jc = GradCompressor() if c.compress else None
    state = init_state(jax.tree.map(jnp.asarray, init), jo, jc)
    step = jax.jit(make_train_step(jget_model(jcfg).loss, jo, microbatch=c.microbatch,
                                   compressor=jc))
    losses, gnorms = [], []
    for s in range(c.steps):
        x = {k: v.astype(np.int32) if v.dtype.kind == "i" else v
             for k, v in train_batch(cfg, 1000 + s, c.batch, c.seq).items()}
        state, m = step(state, x)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    final = flat(jax.device_get(state.params))
    np.savez(r["out"], losses=losses, grad_norms=gnorms,
             **{"init/" + k: np.asarray(v, np.float32) for k, v in flat(init).items()},
             **{"final/" + k: np.asarray(v, np.float32) for k, v in final.items()})
"""


@pytest.fixture(scope="module")
def reference_steps(tmp_path_factory):
    """The reference's steps of every case of ``REF_RUNS``, in one
    subprocess started before the ranks (``layout_results`` asks for this
    first) and waited for at the first comparison: single-threaded XLA at
    a lower priority, so that a suite run in parallel keeps its
    timing-sensitive tests' share of the CPU."""
    d = tmp_path_factory.mktemp("reference_steps")
    reqs = [dict(case=json.loads(key), out=str(d / f"ref{n}.npz"))
            for n, key in enumerate(REF_RUNS)]
    (d / "reqs.json").write_text(json.dumps(reqs))
    err = open(d / "stderr.txt", "w")
    proc = subprocess.Popen([sys.executable, "-c", _JAX_STEPS, str(d / "reqs.json")],
                            stdout=subprocess.DEVNULL, stderr=err,
                            preexec_fn=lambda: os.nice(10),
                            env={**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
                                 "OMP_NUM_THREADS": "1",
                                 "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false "
                                              "intra_op_parallelism_threads=1"})

    def get(key):
        if proc.returncode is None:
            rc = proc.wait(timeout=900)
            err.close()
            assert rc == 0, (d / "stderr.txt").read_text()[-3000:]
        return np.load(dict(zip(REF_RUNS, (r["out"] for r in reqs)))[key])

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    err.close()


@pytest.mark.parametrize("key", list(REF_RUNS),
                         ids=[_name(json.loads(k)) for k in REF_RUNS])
def test_mesh_step_matches_reference(layout_results, reference_steps, key):
    """The reference's jitted one-process ``make_train_step`` from each
    mesh run's initial weights, on its batches: every layout that ran the
    case takes the reference's losses and ``grad_norm`` and ends at its
    weights (the module docstring's bounds)."""
    from torch_train_cases import ATOL, RTOL

    c = json.loads(key)
    runs = [(layout_results(lay)[i], np.load(layout_results.arrays(lay, i)))
            for lay, i in REF_RUNS[key]]
    lr = runs[0][0]["case"]["lr"]
    want = reference_steps(key)
    for _, z in runs:       # the mesh runs started from the reference's weights
        assert sorted(k for k in z.files if k.startswith("init/")) == sorted(
            k for k in want.files if k.startswith("init/"))
        assert all(np.array_equal(z[k], want[k]) for k in z.files if k.startswith("init/"))
    ref = {k[len("final/"):]: want[k] for k in want.files if k.startswith("final/")}
    share = 2e-4 if c.get("compress") else 1e-4
    for res, z in runs:
        for loss, gnorm, wl, wg in zip(res["losses"], res["grad_norms"], want["losses"],
                                       want["grad_norms"]):
            assert abs(loss - wl) <= LOSS_TOL * abs(wl), (res["mesh"], loss, wl)
            assert abs(gnorm - wg) <= GNORM_TOL * wg, (res["mesh"], gnorm, wg)
        assert len(res["losses"]) == len(want["losses"]) == res["case"]["steps"]
        n_out = n = 0
        for path, w in ref.items():
            diff, tight = np.abs(z["final/" + path] - w), ATOL + RTOL * np.abs(w)
            n_out += int((diff > tight).sum())
            n += w.size
            assert np.all(diff <= tight + REF_CAP * lr), (
                res["mesh"], path, float((diff - tight).max() / lr))
        assert n_out <= share * n, (res["mesh"], n_out, n)
        assert n == sum(z[k].size for k in z.files if k.startswith("final/"))


_JAX_MOE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np, dataclasses
from repro import configs as JC
from repro.distributed import compat
from repro.models import moe as jmoe
d, out = int(sys.argv[1]), sys.argv[2]
cfg = dataclasses.replace(JC.get_smoke("qwen2-moe-a2.7b"), capacity_factor=0.5)
p = jmoe.init_moe(jax.random.key(4), cfg, jnp.float32)
x = np.random.default_rng(4).standard_normal((4, 16, cfg.d_model)).astype(np.float32)
cot = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)


def f(p, x):
    y, aux = jmoe.moe_ffn(x, p, cfg)
    return jnp.sum(y * cot) + aux


mesh = jax.make_mesh((d, 1), ("data", "model"))
with compat.set_mesh(mesh):
    y, aux = jax.jit(lambda x, p: jmoe.moe_ffn(x, p, cfg))(x, p)
    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(p, x)
np.savez(out, x=x, cot=cot, y=np.asarray(y), aux=np.asarray(aux), gx=np.asarray(gx),
         **{"p/" + k: np.asarray(v) for k, v in p.items()},
         **{"g/" + k: np.asarray(v) for k, v in gp.items()})
"""


@pytest.mark.parametrize("d", [2, 4])
def test_moe_chunks_match_reference_under_data_mesh(tmp_path, d):
    """The port's ``moe_ffn`` under a (D, 1) ``MeshShape`` (D token chunks,
    capacity per chunk) equals the reference's under a (D, 1) mesh, and so
    do the gradients of ``sum(y * cot) + aux`` with respect to the input
    and every weight (within 1e-4 of each one's largest value, the port's
    gradient bound); at capacity factor 0.5 the chunking changes which
    pairs drop, so the one-chunk output differs."""
    out = tmp_path / "moe.npz"
    r = subprocess.run([sys.executable, "-c", _JAX_MOE, str(d), str(out)],
                       capture_output=True, text=True, timeout=300,
                       preexec_fn=lambda: os.nice(10),      # yield to other tests
                       env={**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
                            "XLA_FLAGS": f"--xla_force_host_platform_device_count={d}"})
    assert r.returncode == 0, r.stderr[-3000:]
    z = np.load(out)
    import dataclasses
    cfg = dataclasses.replace(C.get_smoke("qwen2-moe-a2.7b"), capacity_factor=0.5)
    p = convert._module({k[2:]: z[k] for k in z.files if k.startswith("p/")}, "cpu")
    p.requires_grad_(True)
    x = torch.from_numpy(z["x"]).requires_grad_(True)
    with use_mesh(MeshShape((d, 1), ("data", "model"))):
        y, aux = moe.moe_ffn(x, p, cfg)
        names, ws = zip(*p.named_parameters())
        gs = torch.autograd.grad((y * torch.from_numpy(z["cot"])).sum() + aux, (x, *ws))
    with torch.no_grad():
        y1, _ = moe.moe_ffn(x, p, cfg)
    scale = np.abs(z["y"]).max()
    assert np.abs(y.detach().numpy() - z["y"]).max() < 1e-4 * scale
    assert abs(float(aux.detach()) - float(z["aux"])) < 1e-4 * float(z["aux"])
    assert np.abs(y1.numpy() - z["y"]).max() > 1e-2 * scale
    for name, g, want in zip(("x",) + names, gs, [z["gx"]] + [z["g/" + n] for n in names]):
        assert np.abs(want).max() > 0, name
        assert np.abs(g.numpy() - want).max() <= 1e-4 * np.abs(want).max(), name
