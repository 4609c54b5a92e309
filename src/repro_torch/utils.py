"""Small shared utilities: artifact caching and timing."""
from __future__ import annotations

import hashlib
import os
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

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


@contextmanager
def timer(name: str, sink: dict | None = None):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[name] = sink.get(name, 0.0) + dt
