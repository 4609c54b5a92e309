"""The port's train step (``repro_torch.training.make_train_step``) against
the reference's under ``jax.jit``.

Each case starts both packages from the reference's smoke weights
(``jax.random.key(0)``, carried across with ``from_jax_params``) and runs 3
steps on the same seeded batches (B = 4, T = 16).  Tolerances:

- the loss within 1e-5 relative (4e-7 measured);
- ``grad_norm`` within 1e-3 relative: the reference sums its squares with
  ``jnp.vdot`` in float32, which loses 1.1e-4 on the smoke llama's 65,536
  embedding gradients against a float64 sum; the port's ``torch.sum`` is
  within 3e-8 of it;
- the parameters within ``rtol=2e-4, atol=2e-5`` (the reference's own
  microbatch bound) on all but a few elements, and every element within
  that plus ``c * lr``.  AdamW and Adafactor divide each element's gradient
  by its own running RMS, so an element whose gradient is at the level of
  the two packages' float32 rounding difference (about 1e-6 of the leaf's
  largest |g|; qwen2-moe's key bias ``bk``, whose gradient is zero in exact
  arithmetic since the softmax ignores a shift shared by all keys) moves
  by up to ``lr`` a step in a direction that rounding sets; a bfloat16
  accumulator or an int8 level that rounds the other way does the same.
  Measured: at most 17 of 344,704 elements outside the tight bound (with
  compression), at most 0.061 lr with float32 accumulation, 1.007 lr with
  a bfloat16 accumulator and 0.195 lr with compression.  Bounds: at most
  1e-4 of the elements outside (2e-4 with a bfloat16 accumulator or
  compression), ``c`` = 0.25 (2 with a bfloat16 accumulator or compression).

The helpers and bounds are ``tests/torch_train_cases.py``; checkpoints and
the trainer are ``test_torch_train_ckpt.py``.
"""
import gc

import jax
import numpy as np
import pytest
import torch

from repro_torch import configs as C
from repro_torch.models import get_model
from repro_torch.models.convert import train_state_tree
from repro_torch.training import OptConfig, init_state, make_train_step
from torch_train_cases import Pair, check_metrics, check_params, flat, tensors_of

STEPS = 3

# case: (arch, optimizer, microbatch, grad_acc_dtype, compress)
CASES = {
    "llama-adamw-mb1": ("llama3.2-1b", "adamw", 1, "f32", False),
    "llama-adamw-mb2": ("llama3.2-1b", "adamw", 2, "f32", False),
    "llama-adamw-mb4": ("llama3.2-1b", "adamw", 4, "f32", False),
    "moe-adafactor": ("qwen2-moe-a2.7b", "adafactor", 1, "f32", False),
    "mamba-adafactor": ("mamba2-780m", "adafactor", 1, "f32", False),
    "llama-bf16-acc": ("llama3.2-1b", "adamw", 2, "bf16", False),
    "llama-compress": ("llama3.2-1b", "adamw", 1, "f32", True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case):
    arch, opt, mb, acc, compress = CASES[case]
    pair = Pair(arch, opt, mb, acc, compress)
    check_metrics(pair.run(range(STEPS)))
    ref = jax.device_get(pair.jstate)
    tree = train_state_tree(pair.state)
    assert int(tree[".step"]) == int(ref.step) == STEPS
    assert int(tree[".opt_state"]["step"]) == int(ref.opt_state["step"]) == STEPS
    check_params(tree[".params"], ref.params, loose=acc == "bf16" or compress)
    # the optimizer's state leaves in the reference's shapes
    for (path, want), (_, got) in zip(flat(ref.opt_state), flat(tree[".opt_state"])):
        assert tuple(got.shape) == np.shape(want), path
    if compress:
        for (path, want), (_, got) in zip(flat(ref.error_fb), flat(tree[".error_fb"])):
            assert tuple(got.shape) == want.shape, path


def test_microbatch_metrics_are_the_loss_and_grad_norm_only():
    pair = Pair("qwen2-moe-a2.7b", "adamw", mb=2)
    (m, jm), = pair.run([0])
    assert sorted(m) == sorted(jm) == ["grad_norm", "loss"]
    pair1 = Pair("qwen2-moe-a2.7b", "adamw", mb=1)
    (m1, jm1), = pair1.run([0])
    assert sorted(m1) == sorted(jm1) == ["aux", "grad_norm", "loss"]


def test_init_state_turns_gradients_on_and_inference_stays_off():
    api = get_model(C.get_smoke("llama3.2-1b"), "cpu")
    params = api.init(torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in params.parameters())
    init_state(api.param_tree(params), OptConfig())
    assert all(p.requires_grad for p in params.parameters())


def test_smoke_arch_loss_decreases():
    """20 steps on a tiny llama: loss strictly improves (the reference
    test's end-to-end check, on the port's weights and trainer)."""
    from repro_torch.data.pipeline import TokenPipeline

    cfg = C.get_smoke("llama3.2-1b")
    api = get_model(cfg, "cpu")
    params = api.init(api.generator(0))
    opt_cfg = OptConfig(name="adamw", lr=1e-3)
    state = init_state(api.param_tree(params), opt_cfg)
    step = make_train_step(api.tree_loss, opt_cfg)
    pipe = TokenPipeline(cfg.vocab, 8, 32, seed=0)
    first = last = None
    for _ in range(20):
        state, m = step(state, tensors_of(pipe.batch_at(0)))     # overfit one batch
        if first is None:
            first = float(m["loss"])
        last = float(m["loss"])
    assert last < first - 0.5, (first, last)


def test_train_step_leaves_no_tensor_in_a_reference_cycle():
    """A step's gradients are freed when it returns, not when the garbage
    collector next runs: a reference cycle around them held 4.9 GB of the
    card between llama3.2-1b's full-width steps."""
    cfg = C.get_smoke("llama3.2-1b")
    api = get_model(cfg, "cpu")
    params = api.init(api.generator(0))
    opt_cfg = OptConfig(name="adamw", lr=1e-3)
    state = init_state(api.param_tree(params), opt_cfg)
    x = {k: torch.from_numpy(v).long() for k, v in
         dict(tokens=np.arange(32).reshape(2, 16) % cfg.vocab,
              labels=np.arange(1, 33).reshape(2, 16) % cfg.vocab).items()}
    for microbatch in (1, 2):
        step = make_train_step(api.tree_loss, opt_cfg, microbatch=microbatch)
        gc.collect()
        gc.set_debug(gc.DEBUG_SAVEALL)
        try:
            state, _ = step(state, x)
            gc.collect()
            in_cycles = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
        finally:
            gc.set_debug(0)
            gc.garbage.clear()
        assert not in_cycles, (microbatch, len(in_cycles))
