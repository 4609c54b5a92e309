"""The PQ / RaBitQ baselines on one device against another: the comparisons
that ``chip_smoke.py`` (phase 15a) and the ``cuda`` tests make between the
card and the CPU, at the bounds ``tests/test_torch_baselines.py`` states for
the port against the JAX package.  Each raises :class:`Mismatch` and returns
what it measured."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.baselines import PQ, RaBitQ

CB_RTOL, CB_ATOL = 1e-5, 1e-6      # codebooks
CODE_SHARE = 0.999                 # rows (PQ) or bits (RaBitQ) equal
TIE_REL = 1e-6                     # a differing code's two distances tie within
RTOL = 1e-5                        # center, norms, ip_unit; ADC distances, estimates


class Mismatch(AssertionError):
    """The two devices' baselines disagree beyond the stated bounds."""


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def rel_err(got, want, atol: float = 0.0) -> float:
    """The largest |got - want| / (atol + rtol-scale |want|) as an rtol: the
    smallest rtol at which ``np.allclose(got, want, rtol, atol)`` holds."""
    a, b = _np(got).astype(np.float64), _np(want).astype(np.float64)
    excess = np.maximum(np.abs(a - b) - atol, 0.0)
    scale = np.abs(b)
    if np.any((excess > 0) & (scale == 0)):
        return float("inf")
    return float(np.max(np.where(excess > 0, excess / np.where(scale > 0, scale, 1), 0.0),
                        initial=0.0))


def close(got, want, what: str, rtol: float = RTOL, atol: float = 0.0) -> float:
    err = rel_err(got, want, atol)
    if err > rtol:
        raise Mismatch(f"{what}: off by {err:.3g} relative (bound {rtol}, atol {atol})")
    return err


def codes_agree(got, want, codebooks, rows, what: str = "codes") -> dict:
    """PQ codes ``got`` against ``want`` (N, n_sub) for ``rows`` (N, D):
    equal on >= CODE_SHARE of the rows, and at every differing (row,
    sub-space) the two centroids' squared distances to the row within
    TIE_REL of each other."""
    got, want, books, rows = _np(got), _np(want), _np(codebooks), _np(rows)
    share = float((got == want).all(1).mean()) if len(got) else 1.0
    if share < CODE_SHARE:
        raise Mismatch(f"{what}: {share:.6f} of rows equal < {CODE_SHARE}")
    d_sub = books.shape[2]
    worst = 0.0
    for r, s in zip(*np.nonzero(got != want)):
        sub = rows[r, s * d_sub:(s + 1) * d_sub].astype(np.float64)
        da, db = (float(((books[s, c] - sub) ** 2).sum()) for c in (got[r, s], want[r, s]))
        worst = max(worst, abs(da - db) / max(da, db, 1e-30))
    if worst > TIE_REL:
        raise Mismatch(f"{what}: a differing code is no tie ({worst:.3g} > {TIE_REL})")
    return dict(rows_equal=share, differing=int((got != want).sum()), worst_tie=worst)


def signs_agree(got, want, rows, rq: RaBitQ, what: str = "signs") -> dict:
    """Packed sign bits equal on >= CODE_SHARE of the bits, and every
    differing bit's rotated residual within 2 D 2^-24 of the row's norm of
    0: a float32 product of D terms with a unit column is within D 2^-24 of
    the norm on each device, so only a sign that close to 0 may flip."""
    got, want = _np(got), _np(want)
    d = rq.rotation.shape[0]
    diff = np.unpackbits(got, axis=1)[:, :d] != np.unpackbits(want, axis=1)[:, :d]
    share = 1.0 - float(diff.mean()) if diff.size else 1.0
    if share < CODE_SHARE:
        raise Mismatch(f"{what}: {share:.6f} of bits equal < {CODE_SHARE}")
    worst = 0.0
    r_idx = np.unique(np.nonzero(diff)[0])
    if len(r_idx):
        res = ((_np(rows)[r_idx].astype(np.float64) - _np(rq.center))
               @ _np(rq.rotation).astype(np.float64))
        norms = np.linalg.norm(res, axis=1, keepdims=True)
        worst = float(np.max((np.abs(res) / norms)[diff[r_idx]]))
    tie = 2 * d * 2.0 ** -24
    if worst > tie:
        raise Mismatch(f"{what}: a differing sign is no tie ({worst:.3g} > {tie:.3g})")
    return dict(bits_equal=share, differing=int(diff.sum()), worst_tie=worst)


def compare_pq(got: PQ, want_books, want_codes, rows, what: str = "pq") -> dict:
    """A fit on one device against the codebooks and codes (of the same
    ``rows``) of another."""
    out = dict(codebooks_rel=close(got.codebooks, want_books, f"{what} codebooks", CB_RTOL,
                                   CB_ATOL))
    out.update(codes_agree(got.codes[:len(rows)], want_codes, want_books, rows, f"{what} codes"))
    return out


def compare_rabitq(got: RaBitQ, want: RaBitQ, rows, what: str = "rabitq") -> dict:
    """Two fits of the same rows: rotation bit-equal, center / norms /
    ip_unit within RTOL, the signs of ``rows`` (a prefix) by
    :func:`signs_agree`."""
    if not np.array_equal(_np(got.rotation), _np(want.rotation)):
        raise Mismatch(f"{what}: rotations differ")
    out = {f: close(getattr(got, f), getattr(want, f), f"{what} {f}")
           for f in ("center", "norms", "ip_unit")}
    n = len(rows)
    out.update(signs_agree(got.signs[:n], want.signs[:n], rows, want, f"{what} signs"))
    return out


def same_bits(a, b) -> bool:
    """Two fits' every tensor field equal bit for bit."""
    fields = (("codebooks", "codes") if isinstance(a, PQ)
              else ("rotation", "center", "signs", "norms", "ip_unit"))
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)

