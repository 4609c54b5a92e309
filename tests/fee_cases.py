"""Numpy inputs for the FEE kernel tests (no JAX, so the tests that run on a
card can use them).  The shapes, the tolerance and the comparison are the
port's own: ``repro_torch.kernels.check``."""
import numpy as np


def inputs(c, d, seg, metric, seed):
    """q (D,), x (C, D), the median score as threshold, alpha/beta/margin."""
    rng = np.random.default_rng(seed)
    s = d // seg
    q = rng.standard_normal(d).astype(np.float32)
    x = rng.standard_normal((c, d)).astype(np.float32)
    alpha = (1.0 + 1.0 / np.arange(1, s + 1)).astype(np.float32)
    beta = (1.0 + 0.2 / np.arange(1, s + 1)).astype(np.float32)
    margin = np.zeros(s, np.float32)
    return q, x, threshold(q, x, metric), alpha, beta, margin


def threshold(q, x, metric):
    return np.float32(np.median(((x - q) ** 2).sum(1)) if metric == "l2"
                      else -np.median(x @ q))
