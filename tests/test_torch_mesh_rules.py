"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's, spec for spec.

For the 10 smoke and the 10 full configurations, at mesh shapes (1, 1),
(1, 4), (2, 4), (4, 2), (1, 16), (16, 16) and (2, 16, 16): ``param_specs``
in train and serve mode, ``opt_specs`` over AdamW's and Adafactor's state,
``cache_specs`` and ``batch_specs`` equal the reference's leaf for leaf.
Both sides see shapes only: the reference ``jax.eval_shape`` trees under a
duck-typed mesh (``axis_names`` and ``devices.shape``, no devices), the
port its own trees on the meta device (``param_tree`` of
``abstract_params``, ``init_opt_state`` over it, ``input_specs``) and, for
the cache, the reference cache's shapes as meta tensors (the port's
decode cache is per layer; the rules read the reference's layout).
Nothing is allocated at full width.
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.distributed import sharding as jsh
from repro.models.registry import get_model as jget_model
from repro.training import OptConfig as JOptConfig
from repro.training import optim as joptim
from repro_torch import configs as C
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import MeshShape, axis_names, production_mesh_shape
from repro_torch.models import get_model
from repro_torch.training import OptConfig, init_opt_state

SHAPES = ((1, 1), (1, 4), (2, 4), (4, 2), (1, 16), (16, 16), (2, 16, 16))
CACHE = dict(batch=32, kv_len=64)


def _jmesh(shape):
    return types.SimpleNamespace(axis_names=axis_names(len(shape)),
                                 devices=np.empty(shape, object))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


def _jflat(specs):
    """(path, spec as a tuple) of the reference's spec tree."""
    out = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return [(jsh._path_str(p), tuple(s)) for p, s in out]


def _meta(tree):
    return jax.tree.map(lambda x: torch.empty(x.shape, device="meta"), tree)


def _same(port, ref):
    got = list(_flat(port))
    assert [p for p, _ in got] == [p for p, _ in ref]
    bad = [(p, g, w) for (p, g), (_, w) in zip(got, ref) if tuple(g) != w]
    assert not bad, bad[:5]


def _sides(cfg_fn, jcfg_fn, arch):
    cfg, jcfg = cfg_fn(arch), jcfg_fn(arch)
    api, japi = get_model(cfg, "cpu"), jget_model(jcfg)
    tree = api.param_tree(api.abstract_params())
    jabs = japi.abstract_params()
    return cfg, jcfg, api, japi, tree, jabs


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", list(C.ARCHS))
def test_specs_match_reference(arch, full):
    cfg, jcfg, api, japi, tree, jabs = _sides(C.get_config if full else C.get_smoke,
                                              JC.get_config if full else JC.get_smoke, arch)
    opt = {n: init_opt_state(tree, OptConfig(name=n)) for n in ("adamw", "adafactor")}
    jopt = {n: jax.eval_shape(lambda p, n=n: joptim.init_opt_state(p, JOptConfig(name=n)),
                              jabs) for n in opt}
    jcache = japi.abstract_cache(CACHE["batch"], CACHE["kv_len"])
    shape_spec = JC.SHAPES["train_4k"]
    batch = C.input_specs(cfg, C.SHAPES["train_4k"])
    jbatch = JC.input_specs(jcfg, shape_spec)
    for shape in SHAPES:
        mesh, jmesh = MeshShape(shape, axis_names(len(shape))), _jmesh(shape)
        for mode in ("train", "serve"):
            _same(sh.param_specs(tree, mesh, mode), _jflat(jsh.param_specs(jabs, jmesh, mode)))
        pspecs = sh.param_specs(tree, mesh)
        jpspecs = jsh.param_specs(jabs, jmesh)
        for n in opt:
            _same(sh.opt_specs(opt[n], pspecs, mesh),
                  _jflat(jsh.opt_specs(jopt[n], jpspecs, jmesh)))
        _same(sh.cache_specs(_meta(jcache), mesh), _jflat(jsh.cache_specs(jcache, jmesh)))
        _same(sh.batch_specs(batch, mesh), _jflat(jsh.batch_specs(jbatch, jmesh)))


def test_llama_full_model_axis_moves_between_storage_and_use():
    """llama3.2-1b at (2, 16): the rules store the model axis on the input
    of wi/wg and on the output of wq/wk/wv/wo and of the FFN's wo, where
    the use sites ask for the other dimension of wi/wg/wo."""
    tree = get_model(C.get_config("llama3.2-1b"), "cpu").abstract_params()
    api = get_model(C.get_config("llama3.2-1b"), "cpu")
    specs = sh.param_specs(api.param_tree(tree), MeshShape((2, 16), ("data", "model")))
    blk = specs["blocks"]["pos0"]
    assert blk["mlp"]["wi"] == blk["mlp"]["wg"] == (None, "model", "data")
    assert blk["mlp"]["wo"] == (None, "data", "model")
    assert all(blk["attn"][k] == (None, "data", "model") for k in ("wq", "wk", "wv", "wo"))
    assert specs["embed"] == ("model", "data")


def test_production_shapes_and_placements():
    assert production_mesh_shape() == ((16, 16), ("data", "model"))
    assert production_mesh_shape(True) == ((2, 16, 16), ("pod", "data", "model"))
    dp, model = sh.mesh_axes(production_mesh_shape(True))
    assert dp == ("pod", "data") and model == "model"


def test_shard_blocks_tile_the_array():
    """Every rank's ``shard`` of a (2, 2, 4) mesh's spec, put back at its
    coordinates, is the array."""
    shape = (2, 2, 4)
    x = torch.arange(8 * 8 * 3).reshape(8, 8, 3)
    for spec in ((("pod", "data"), "model", None), ("model", None, None), (None, None, None)):
        got = torch.zeros_like(x)
        for rank in range(16):
            mesh = types.SimpleNamespace(axis_names=axis_names(3), shape=shape, rank=rank)
            block = sh.shard(x, spec, mesh)
            assert all(n * sh.axis_size(mesh, e) == m
                       for n, m, e in zip(block.shape, x.shape, spec))
            idx = tuple(slice(sh.coordinate(mesh, e) * n, (sh.coordinate(mesh, e) + 1) * n)
                        for e, n in zip(spec, block.shape))
            got[idx] = block
        assert torch.equal(got, x)


def test_mesh_entry_points_raise_without_a_card(monkeypatch):
    """The mesh trainer and the rank spawner default to the card and raise
    without one; NCCL is never asked of CPU ranks (no silent gloo)."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--smoke", "--steps", "1", "--devices", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_mod.spawn(print, 2)
    with pytest.raises(ValueError, match="CPU ranks run gloo"):
        mesh_mod.spawn(print, 2, device="cpu", backend="nccl")


@pytest.mark.parametrize("arch", C.ARCHS)
def test_init_sharded_is_init_then_shard(arch):
    """``models.convert.init_sharded`` (each weight cut to a rank's block as
    it is drawn) gives every rank of (2, 2), (1, 4) and (4, 1) the blocks,
    specs and values of ``shard_params`` over the whole model drawn from
    the same seed, and cuts every weight the rules split while drawing."""
    from repro_torch.models import common
    from repro_torch.models.convert import init_sharded, shard_params

    cfg = C.get_smoke(arch)
    api = get_model(cfg, "cpu")
    for shape in ((2, 2), (1, 4), (4, 1)):
        for rank in range(4):
            mesh = types.SimpleNamespace(shape=shape, axis_names=("data", "model"), rank=rank)
            cuts = []
            real_shard = sh.shard
            try:
                # count the cuts made while ``uinit`` draws
                sh.shard = lambda x, spec, m: (cuts.append(common._EACH_DRAW["fn"] is not None)
                                               or real_shard(x, spec, m))
                got = init_sharded(api, api.generator(3), mesh)
            finally:
                sh.shard = real_shard
            want = shard_params(cfg, api.init(api.generator(3)), mesh)
            split = [t for t in want.parameters()
                     if any(e is not None and sh.axis_size(mesh, e) > 1 for e in t.mesh_spec)]
            assert sum(cuts) >= len(split) > 0
            for (k, a), (k2, b) in zip(got.named_parameters(), want.named_parameters()):
                assert k == k2 and a.mesh_spec == b.mesh_spec and torch.equal(a, b), k
