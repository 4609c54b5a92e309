"""Small shared utilities: artifact caching, timing, tree sizes and
parameter counts."""
from __future__ import annotations

import hashlib
import json
import os
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

# the checkout's .cache/ unless REPRO_CACHE names another directory
CACHE_DIR = Path(os.environ.get("REPRO_CACHE",
                                Path(__file__).resolve().parents[2] / ".cache"))


def cache_path(key: str, suffix: str = ".npz") -> Path:
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    h = hashlib.sha1(key.encode()).hexdigest()[:16]
    return CACHE_DIR / f"{h}{suffix}"


def cached_npz(key: str, make):
    """Build-once npz artifact cache keyed by a string."""
    p = cache_path(key)
    if p.exists():
        with np.load(p, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    out = make()
    np.savez(p, **out)
    return out


def cached_json(key: str, make):
    """Build-once JSON artifact cache keyed by a string."""
    p = cache_path(key, ".json")
    if p.exists():
        return json.loads(p.read_text())
    out = make()
    p.write_text(json.dumps(out))
    return out


@contextmanager
def timer(name: str, sink: dict | None = None):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[name] = sink.get(name, 0.0) + dt


def param_count(module) -> int:
    """Number of weights of a model (every parameter's element count)."""
    return sum(p.numel() for p in module.parameters())


def _arrays(tree):
    """The arrays of a tree: tensors and numpy arrays, in dicts, lists,
    tuples (``training.tree.Stacked`` groups among them) and modules (their
    parameters and buffers)."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _arrays(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _arrays(v)


def tree_bytes(tree) -> int:
    """Bytes of every array of ``tree`` (the reference's ``tree_bytes``)."""
    return sum(x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes
               for x in _arrays(tree))


def tree_params(tree) -> int:
    """Elements of every array of ``tree`` (the reference's ``tree_params``)."""
    return sum(x.numel() if isinstance(x, torch.Tensor) else x.size for x in _arrays(tree))
