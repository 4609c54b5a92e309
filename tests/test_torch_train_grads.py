"""The port's models take the reference's gradients: for each of the 10
``SMOKE`` configs the reference is initialised with ``jax.random.key(0)``,
its weights carried across with ``models/convert.py::from_jax_params``, and
both packages get the same seeded numpy batch.  ``loss.backward()`` (here
``torch.autograd.grad`` over ``convert.param_tree``'s tensors) against
``jax.grad`` of the reference's loss.

Tolerances (float32): the loss within 1e-5 relative; each gradient leaf
(a ``Stacked`` group stacked to the reference's shape) within 1e-4 of its
largest |g|.  ``remat=True`` (a ``torch.utils.checkpoint`` around each
block) gives the gradients of ``remat=False`` bit for bit.

bfloat16: llama within 3e-2 of each leaf's largest |g| (both packages
round every product to bfloat16 in other orders: about one bfloat16 step,
0.4%, per rounding; 2.0e-2 measured) and the loss within 1e-4.  This file
holds the dense architectures, ``test_torch_train_grads_mixed.py`` the
MoE, SSM, hybrid and encoder-decoder ones and the bfloat16 MoE model.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro_torch import configs as C
from torch_train_cases import batch, flat, port_grads, reference

ARCHS = ["llama3.2-1b", "qwen2-72b", "qwen3-8b", "yi-9b", "llava-next-34b"]
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
BF16_TOL = 3e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg, cfg = JC.get_smoke(arch), C.get_smoke(arch)
            x = batch(cfg)
            tree, jloss, jgrads = reference(jcfg, x)
            cache[arch] = (tree, x, jloss, jgrads, port_grads(cfg, tree, x))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(runs, arch):
    _, _, jloss, jgrads, (loss, grads) = runs(arch)
    assert abs(loss - jloss) <= LOSS_TOL * abs(jloss), (loss, jloss)
    ref = list(flat(jgrads))
    assert len(grads) == len(ref)
    errs = {}
    for (path, want), got in zip(ref, grads):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32, path
        errs[path] = float(np.abs(got.numpy() - want).max() / (np.abs(want).max() + 1e-30))
    assert max(errs.values()) < GRAD_TOL, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradients_bit_for_bit(runs, arch):
    tree, x, _, _, (loss, grads) = runs(arch)
    cfg = dataclasses.replace(C.get_smoke(arch), remat=True)
    loss_r, grads_r = port_grads(cfg, tree, x)
    assert loss_r == loss
    for a, b in zip(grads_r, grads):
        assert torch.equal(a, b)


def _bf16(arch):
    return (dataclasses.replace(JC.get_smoke(arch), dtype=jnp.bfloat16),
            dataclasses.replace(C.get_smoke(arch), dtype=torch.bfloat16))


def _bf16_run(arch):
    jcfg, cfg = _bf16(arch)
    x = batch(cfg)
    tree, jloss, jgrads = reference(jcfg, x)
    loss, grads = port_grads(cfg, tree, x)
    pairs = [(path, got.float().numpy(), np.asarray(want, np.float32))
             for (path, want), got in zip(flat(jgrads), grads)]
    for path, got, want in pairs:
        assert got.shape == want.shape, path
    for g, (path, _, _), (_, want) in zip(grads, pairs, flat(jgrads)):
        assert str(g.dtype).split(".")[-1] == str(want.dtype), path   # the weights' dtype
    return loss, jloss, pairs


def test_bf16_llama_grads_match_jax():
    loss, jloss, pairs = _bf16_run("llama3.2-1b")
    assert abs(loss - jloss) <= 1e-4 * abs(jloss), (loss, jloss)
    errs = {p: float(np.abs(g - w).max() / np.abs(w).max()) for p, g, w in pairs}
    assert max(errs.values()) < BF16_TOL, errs
