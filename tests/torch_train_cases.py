"""Shared by the ``test_torch_train*.py`` files: seeded batches, the
reference's and the port's loss and gradients of a smoke model, and a
:class:`Pair` that steps both packages' train steps from the same weights,
with the bounds its checks hold them to (``test_torch_train_step.py``'s
docstring states them)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as JC
from repro.models.registry import get_model as jget_model
from repro.training import GradCompressor as JCompressor
from repro.training import OptConfig as JOptConfig
from repro.training import init_state as jinit_state
from repro.training import make_train_step as jmake_train_step
from repro_torch import configs as C
from repro_torch.models import get_model
from repro_torch.models.convert import from_jax_params
from repro_torch.training import GradCompressor, OptConfig, init_state, make_train_step
from repro_torch.training.tree import Stacked, leaves, tensors

B, T, ENC_LEN = 2, 16, 24
STEP_B, LR = 4, 1e-3                # the train-step cases' batch and learning rate
LOSS_TOL, GNORM_TOL = 1e-5, 1e-3
RTOL, ATOL = 2e-4, 2e-5


def batch(cfg, seed=0, b=B):
    rng = np.random.default_rng(seed)
    out = dict(tokens=rng.integers(0, cfg.vocab, (b, T)).astype(np.int32),
               labels=rng.integers(0, cfg.vocab, (b, T)).astype(np.int32))
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal((b, ENC_LEN, cfg.d_model)).astype(np.float32)
    elif cfg.frontend == "vision":
        out["prefix_embeds"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def flat(tree, prefix=""):
    """(path, array) of a nested dict, keys sorted (JAX's leaf order)."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from flat(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, tree[k]


def reference(jcfg, x):
    """The reference's weights, loss and gradients (numpy)."""
    api = jget_model(jcfg)
    params = api.init(jax.random.key(0))
    (loss, _), grads = jax.jit(jax.value_and_grad(api.loss, has_aux=True))(params, x)
    return jax.device_get(params), float(loss), jax.device_get(grads)


def port_grads(cfg, tree_np, x):
    """The port's loss and gradients (``Stacked`` groups stacked), in the
    reference's leaf order."""
    api = get_model(cfg, "cpu")
    params = from_jax_params(cfg, tree_np, "cpu")
    params.requires_grad_(True)
    tree = api.param_tree(params)
    loss, _ = api.tree_loss(tree, {k: torch.from_numpy(v) for k, v in x.items()})
    ts = tensors(tree)
    gs = iter(g if g is not None else torch.zeros_like(t)
              for t, g in zip(ts, torch.autograd.grad(loss, ts, allow_unused=True)))
    out = [torch.stack([next(gs) for _ in leaf]) if isinstance(leaf, Stacked) else next(gs)
           for leaf in leaves(tree)]
    return float(loss.detach()), out


def tensors_of(x: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in x.items()}


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


class Pair:
    """The reference and the port from the same weights, stepped alike."""

    def __init__(self, arch, opt, mb=1, acc="f32", compress=False, bf16=False):
        self.jcfg, self.cfg = JC.get_smoke(arch), C.get_smoke(arch)
        if bf16:
            self.jcfg = dataclasses.replace(self.jcfg, dtype=jnp.bfloat16)
            self.cfg = dataclasses.replace(self.cfg, dtype=torch.bfloat16)
        japi = jget_model(self.jcfg)
        jparams = japi.init(jax.random.key(0))
        jo, po = JOptConfig(name=opt, lr=LR), OptConfig(name=opt, lr=LR)
        jc, pc = (JCompressor(), GradCompressor()) if compress else (None, None)
        self.jstate = jinit_state(jparams, jo, jc)
        self.jstep = jax.jit(jmake_train_step(japi.loss, jo, microbatch=mb, compressor=jc,
                                              grad_acc_dtype=acc))
        self.api = get_model(self.cfg, "cpu")
        params = from_jax_params(self.cfg, jax.device_get(jparams), "cpu")
        self.state = init_state(self.api.param_tree(params), po, pc)
        self.step = make_train_step(self.api.tree_loss, po, microbatch=mb, compressor=pc,
                                    grad_acc_dtype=acc)

    def run(self, seeds):
        out = []
        for s in seeds:
            x = batch(self.cfg, s, STEP_B)
            self.jstate, jm = self.jstep(self.jstate, x)
            self.state, m = self.step(self.state, tensors_of(x))
            out.append(({k: float(v) for k, v in m.items()},
                        {k: float(v) for k, v in jm.items()}))
        return out


def check_metrics(out, loss_tol=LOSS_TOL, gnorm_tol=GNORM_TOL):
    for m, jm in out:
        assert sorted(m) == sorted(jm)
        assert abs(m["loss"] - jm["loss"]) <= loss_tol * abs(jm["loss"]), (m, jm)
        assert abs(m["grad_norm"] - jm["grad_norm"]) <= gnorm_tol * jm["grad_norm"], (m, jm)
        if "aux" in jm:
            assert abs(m["aux"] - jm["aux"]) <= loss_tol * max(1.0, abs(jm["aux"])), (m, jm)


def check_params(port: dict, ref: dict, loose: bool):
    c, share = (2.0, 2e-4) if loose else (0.25, 1e-4)
    n_out = n = 0
    for (path, want), (path2, got) in zip(flat(ref), flat(port)):
        assert path == path2
        got, want = f32(got), f32(want)
        assert got.shape == want.shape, path
        diff = np.abs(got - want)
        tight = ATOL + RTOL * np.abs(want)
        n_out += int((diff > tight).sum())
        n += want.size
        assert np.all(diff <= tight + c * LR), (path, float((diff - tight).max() / LR))
    assert n_out <= share * n, (n_out, n)
