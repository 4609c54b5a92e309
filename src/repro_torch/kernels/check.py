"""How a FEE kernel is held against its plain version: the shapes, the
tolerance and the comparison, shared by the kernel tests and
``chip_smoke.py``.

Tolerance: the CUDA kernels, the plain versions and the JAX package sum each
segment's distance in different orders (on the CPU only about a third of
per-segment float32 sums come out bit-equal between XLA and torch), so
distances are held to rtol 3e-5 / atol 2e-4, and exit flags / ``segs_used``
must be exact except for lanes whose estimate lies within that tolerance of
the threshold.  The Dfloat decode is integer work and must be bit-exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import dfloat as dfl

# (C rows, D dims, seg): the cases of the JAX package's kernel tests (C not a
# multiple of any tile, D=960, seg=32), and gist's 960 dims in 60 segments of
# 16 over C rows that fill no tile
SHAPES = [(7, 32, 8), (100, 128, 16), (129, 128, 16), (64, 960, 32), (256, 64, 16),
          (97, 960, 16)]
# seg % 4 != 0: the f32 kernel reads these one float at a time
SCALAR_SHAPES = [(50, 32, 2), (33, 36, 6)]
RTOL, ATOL = 3e-5, 2e-4


class Mismatch(AssertionError):
    """A kernel's outputs disagree with its plain version's beyond the
    tolerance."""


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def near_threshold(x, q, thr, alpha, beta, margin, *, seg: int, metric: str):
    """Lanes whose float64 estimate at some exit checkpoint lies within the
    distance tolerance of the threshold: their exit may legitimately flip.

    ``x`` (..., L, D) rows, ``q`` (..., D) queries, ``thr`` (...) thresholds
    (numpy arrays or tensors) -> (..., L) bool, on ``x``'s device."""
    x64 = _tensor(x).double()
    dev = x64.device
    q64 = _tensor(q).to(dev).double().unsqueeze(-2)
    alpha, beta, margin = (_tensor(a).to(dev).double() for a in (alpha, beta, margin))
    per = (x64 - q64) ** 2 if metric == "l2" else -(x64 * q64)
    d = x64.shape[-1]
    cum = per.unflatten(-1, (d // seg, seg)).sum(-1).cumsum(-1)
    est = alpha * cum / beta - margin
    t = _tensor(thr).to(dev).double()[..., None, None]
    return ((est[..., :-1] - t).abs() <= ATOL + RTOL * t.abs()).any(-1)


def compare_fee(got, want, near, what: str = "fee_distance"):
    """Hold FEE outputs ``got`` = (dist, rejected, segs_used) against
    ``want``: exit flags and ``segs_used`` equal except on ``near`` lanes,
    distances within tolerance wherever the exits agree.  Any array-likes of
    one shape.  Raises :class:`Mismatch`; returns (max |dist error|, lanes
    whose exit differs, near-threshold lanes)."""
    dist, rej, segs = (_tensor(a).reshape(-1).cpu() for a in got)
    wd, wr, ws = (_tensor(a).reshape(-1).cpu() for a in want)
    near = _tensor(near).reshape(-1).cpu()
    same = (rej == wr) & (segs == ws)
    bad = int((~same & ~near).sum())
    if bad:
        raise Mismatch(f"{what}: {bad} lanes disagree on exits away from the threshold")
    err = (dist[same].double() - wd[same].double()).abs()
    if not bool((err <= ATOL + RTOL * wd[same].double().abs()).all()):
        raise Mismatch(f"{what}: distance beyond tolerance (max err {float(err.max()):.3g})")
    return (float(err.max()) if err.numel() else 0.0, int((~same).sum()),
            int(near.sum()))


def random_layout(rng: np.random.Generator, d: int, x: np.ndarray):
    """A random Dfloat layout of ``d`` features in up to three runs of the
    width palette, biased to the data ``x``: returns (config, runs)."""
    widths = sorted(set(rng.choice(dfl.WIDTH_PALETTE, rng.integers(1, 4))),
                    reverse=True)
    cuts = sorted(rng.choice(np.arange(1, d), len(widths) - 1, replace=False))
    bounds = [0, *cuts, d]
    runs = [(int(w), dfl.EXP_BITS[int(w)], int(b - a))
            for w, a, b in zip(widths, bounds[:-1], bounds[1:])]
    return dfl.make_config(d, runs, x), runs
