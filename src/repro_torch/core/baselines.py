"""Compression baselines the paper compares against (Fig. 20), on the card.

* PQ (product quantization, Jégou'11): k-means codebooks per sub-space, ADC
  lookup distances.  High compression but lossy -> needs weak compression at
  high recall, i.e. more memory traffic (the paper's point).
* RaBitQ-lite (Gao & Long'24, simplified): 1-bit sign code of the centered,
  rotated vector + per-vector norm; used as a *filter* whose survivors are
  re-ranked with exact full-dimension distances (so memory traffic = code
  bytes + rerank full-vector bytes, matching the paper's accounting).

The JAX package's ``core/baselines.py`` is host numpy; here the passes over
rows run in torch on ``device`` (default ``"cuda"``, which raises without a
card), and the dataclasses hold tensors there.  Same names, signatures and
semantics, with these rules for parity:

- The random draws stay numpy ``Generator`` draws on the host in the
  reference's order (the sample rows, then one centroid draw a sub-space;
  the rotation's Gaussian matrix and its QR), so a seed picks the same rows
  and the same rotation bit for bit.
- Every sum that an argmin or an ADC table reads is taken in numpy's
  float32 order (:func:`np_sum`; a centroid's mean sums its members one by
  one in row order, as numpy's axis-0 reduction does).  Elementwise float32
  arithmetic rounds the same on both devices, so codebooks, codes and ADC
  distances equal the reference's bit for bit; nothing accumulates through
  ``index_add_`` / ``scatter_add_``, whose CUDA atomics would make two fits
  from one seed differ.
- RaBitQ's center is numpy's own row mean on the host (a sequential float32
  sum: a float64 or a parallel sum differs from it by up to 1.5e-5 relative
  on 20,000 rows of ``sift``), and a query's rotated residual is numpy's
  float32 product (its estimates sum that vector in float64, and for the ip
  metric they cross zero).  The rows' rotation runs on ``device`` in float32
  with TF32 off.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from repro_torch import resolve_device

K = 256                     # centroids a sub-space (one uint8 code)
# the largest temporary of a pass over rows: about 1 GB on the card (few
# launches), 4 MB on the host (a chunk stays in cache: 3-4x faster there)
CHUNK_BYTES = {"cuda": 1 << 30, "cpu": 1 << 22}
PW_BLOCK = 128              # numpy's PW_BLOCKSIZE


def np_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in numpy's float32 order (``pairwise_sum`` of
    numpy's ``loops_utils.h.src``): under 8 terms one by one; up to 128
    eight running sums over strided terms, joined as a tree, then the tail;
    beyond, the two halves split at a multiple of 8.  Equal to numpy's
    ``.sum(-1)`` bit for bit (but for the sign of a zero sum)."""
    n = x.shape[-1]
    if n < 8:
        out = x[..., 0]
        for i in range(1, n):
            out = out + x[..., i]
        return out
    if n <= PW_BLOCK:
        m = n - n % 8
        r = x[..., 0:8]
        for i in range(8, m, 8):
            r = r + x[..., i:i + 8]
        out = (((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3]))
               + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7])))
        for i in range(m, n):
            out = out + x[..., i]
        return out
    n2 = n // 2
    n2 -= n2 % 8
    return np_sum(x[..., :n2]) + np_sum(x[..., n2:])


@contextlib.contextmanager
def _full_float32():
    """float32 products in full float32 (no TF32) inside the block; the
    caller's setting comes back after it."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


# ------------------------------- PQ ----------------------------------------


@dataclasses.dataclass
class PQ:
    codebooks: torch.Tensor   # (n_sub, 256, d_sub) f32
    codes: torch.Tensor       # (N, n_sub) uint8
    d_sub: int
    metric: str

    @property
    def bits_per_vector(self) -> int:
        return self.codes.shape[1] * 8


def assign(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each row of ``x`` (S, d): the argmin over ``c``
    (256, d) of ``((x - c) ** 2).sum(-1)``, that same expression (not its
    ``|x|^2 - 2 x.c + |c|^2`` expansion), rows chunked (CHUNK_BYTES).
    Returns (S,) int64; ties go to the lower centroid, as numpy's argmin."""
    rows = max(1, CHUNK_BYTES[x.device.type] // (4 * c.shape[0] * c.shape[1]))
    out = []
    for s in range(0, x.shape[0], rows):
        diff = x[s:s + rows, None, :] - c[None]
        out.append(np_sum(diff.mul_(diff)).argmin(1))
    return torch.cat(out)


def lloyd_means(x: torch.Tensor, a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Lloyd's update: each centroid the mean of its members (``x`` rows
    with ``a == j``), summed one by one in row order then divided once, as
    numpy's ``x[m].mean(0)``; a centroid with no member keeps its value.
    The members are sorted by centroid (stably) into a zero-padded (256,
    width, d) block whose rank slices are added in turn: adding a zero
    leaves a sum unchanged, and no two rows write one slot."""
    k, d = c.shape
    order = torch.argsort(a, stable=True)
    sa = a[order]
    starts = torch.searchsorted(sa, torch.arange(k + 1, device=a.device))
    counts = starts[1:] - starts[:-1]
    rank = torch.arange(len(sa), device=a.device) - starts[sa]
    width = int(counts.max())
    pad = x.new_zeros((k, width, d))
    pad[sa, rank] = x[order]
    total = pad[:, 0]
    for r in range(1, width):
        total = total + pad[:, r]
    counts = counts[:, None]
    return torch.where(counts > 0, total / counts.to(x.dtype), c)


def pq_codebooks(db: np.ndarray, n_sub: int, iters: int = 8, seed: int = 0,
                 sample: int = 20000, device="cuda") -> torch.Tensor:
    """The codebooks of :func:`fit_pq`, (n_sub, 256, d_sub) f32 on
    ``device``: ``iters`` Lloyd steps on ``sample`` rows of ``db`` (N, D)
    from centroids drawn by ``seed``."""
    dev = resolve_device(device)
    n, d = db.shape
    if d % n_sub:
        raise ValueError(f"n_sub={n_sub} must divide dim={d}")
    d_sub = d // n_sub
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, min(sample, n), replace=False)
    xs = torch.from_numpy(db[idx]).to(dev)
    books = torch.empty((n_sub, K, d_sub), dtype=torch.float32, device=dev)
    for s in range(n_sub):
        x = xs[:, s * d_sub:(s + 1) * d_sub].contiguous()
        pick = rng.choice(len(x), K, replace=len(x) < K)
        c = x[torch.from_numpy(pick).to(dev)]
        for _ in range(iters):  # lloyd
            c = lloyd_means(x, assign(x, c), c)
        books[s] = c
    return books


def pq_encode(codebooks: torch.Tensor, rows) -> torch.Tensor:
    """Codes (N, n_sub) uint8 of ``rows`` (N, D) under ``codebooks``, on the
    codebooks' device."""
    dev = codebooks.device
    n_sub, _, d_sub = codebooks.shape
    full = torch.as_tensor(rows, device=dev)
    codes = torch.empty((full.shape[0], n_sub), dtype=torch.uint8, device=dev)
    for s in range(n_sub):
        codes[:, s] = assign(full[:, s * d_sub:(s + 1) * d_sub], codebooks[s]).to(torch.uint8)
    return codes


def fit_pq(db: np.ndarray, n_sub: int, metric: str = "l2", iters: int = 8,
           seed: int = 0, sample: int = 20000, device="cuda") -> PQ:
    """Train ``n_sub`` k-means codebooks of 256 centroids on ``sample`` rows
    of ``db`` (N, D), then encode every row; everything past the host's
    random draws runs on ``device``."""
    books = pq_codebooks(db, n_sub, iters, seed, sample, device)
    return PQ(books, pq_encode(books, db), books.shape[2], metric)


def pq_distances(pq: PQ, query, ids) -> torch.Tensor:
    """ADC: one table build per query, then code lookups.  ``query`` (D,),
    ``ids`` (C,) -> (C,) on the codes' device."""
    dev = pq.codebooks.device
    n_sub = pq.codebooks.shape[0]
    qs = torch.as_tensor(query, device=dev).reshape(n_sub, pq.d_sub)
    if pq.metric == "l2":
        diff = pq.codebooks - qs[:, None, :]
        tab = np_sum(diff * diff)                                 # (n_sub, 256)
    else:
        tab = -np_sum(pq.codebooks * qs[:, None, :])
    c = pq.codes[torch.as_tensor(ids, device=dev).long()].long()   # (C, n_sub)
    return np_sum(tab[torch.arange(n_sub, device=dev)[None, :], c])


def pq_from_numpy(ref, device="cuda") -> PQ:
    """A PQ of the JAX package (numpy fields) as the port's, on ``device``."""
    dev = resolve_device(device)
    return PQ(torch.from_numpy(np.asarray(ref.codebooks)).to(dev),
              torch.from_numpy(np.asarray(ref.codes)).to(dev), int(ref.d_sub), ref.metric)


def pq_to_numpy(pq: PQ) -> dict:
    """The fields of the JAX package's ``PQ`` (numpy arrays)."""
    return dict(codebooks=pq.codebooks.cpu().numpy(), codes=pq.codes.cpu().numpy(),
                d_sub=pq.d_sub, metric=pq.metric)


# ---------------------------- RaBitQ-lite -----------------------------------


@dataclasses.dataclass
class RaBitQ:
    rotation: torch.Tensor   # (D, D) random orthogonal
    center: torch.Tensor     # (D,)
    signs: torch.Tensor      # (N, D) packed as uint8 bits -> (N, D//8)
    norms: torch.Tensor      # (N,) residual norms
    ip_unit: torch.Tensor    # (N,) <residual_unit, sign_unit> correction factor
    metric: str

    @property
    def bits_per_vector(self) -> int:
        return self.signs.shape[1] * 8 + 64  # code + norm/correction scalars


def _shifts(dev) -> torch.Tensor:
    return torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)   # MSB first


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, D) bool -> (N, ceil(D / 8)) uint8, ``np.packbits(axis=1)``'s
    order: the first bit the most significant, the last byte zero-padded."""
    n, d = bits.shape
    b = torch.nn.functional.pad(bits.to(torch.uint8), (0, -d % 8))
    return (b.view(n, -1, 8) << _shifts(bits.device)).sum(-1).to(torch.uint8)


def unpack_bits(packed: torch.Tensor, d: int) -> torch.Tensor:
    """(N, W) uint8 -> (N, d) uint8 0/1, ``np.unpackbits(axis=1)[:, :d]``."""
    bits = (packed[..., None] >> _shifts(packed.device)) & 1
    return bits.reshape(packed.shape[0], -1)[:, :d]


def fit_rabitq(db: np.ndarray, metric: str = "l2", seed: int = 0, device="cuda") -> RaBitQ:
    """Center (l2: the row mean; ip: zeros), rotate by a seeded random
    orthogonal matrix, and keep each row's sign bits, residual norm and the
    estimator's correction ``<unit, sign unit>``; the rows' passes run on
    ``device`` in chunks."""
    dev = resolve_device(device)
    n, d = db.shape
    rng = np.random.default_rng(seed)
    rot = np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
    center = db.mean(0) if metric == "l2" else np.zeros(d, np.float32)
    rot_d = torch.from_numpy(rot).to(dev)
    center_d = torch.from_numpy(np.asarray(center)).to(dev)
    rows = max(1, CHUNK_BYTES[dev.type] // (16 * d))   # float32 and float64 (rows, D) temporaries
    signs, norms, ip_unit = [], [], []
    for s in range(0, n, rows):
        x = torch.from_numpy(np.ascontiguousarray(db[s:s + rows])).to(dev)
        with _full_float32():
            res = (x - center_d) @ rot_d
        nrm = np_sum(res * res).sqrt() + 1e-12
        unit = res / nrm[:, None]
        positive = ~(res < 0)                          # a sign of 0 counts as +1
        pm = torch.where(positive, 1.0, -1.0).double()
        ip_unit.append(np_sum(unit.double() * (pm / math.sqrt(d))).float())
        signs.append(pack_bits(positive))
        norms.append(nrm)
    return RaBitQ(rot_d, center_d, torch.cat(signs), torch.cat(norms), torch.cat(ip_unit),
                  metric)


def rabitq_estimate(rq: RaBitQ, query, ids) -> torch.Tensor:
    """Estimated distance from the 1-bit code (the filter stage): (C,)
    float64 on the codes' device, as the reference's float64 result."""
    dev = rq.signs.device
    d = rq.rotation.shape[0]
    qr = (np.asarray(query) - rq.center.cpu().numpy()) @ rq.rotation.cpu().numpy()
    qn = np.linalg.norm(qr) + 1e-12
    ids = torch.as_tensor(ids, device=dev).long()
    qr_d = torch.from_numpy(np.asarray(qr, np.float64)).to(dev)
    ip_code = torch.empty(len(ids), dtype=torch.float64, device=dev)
    rows = max(1, CHUNK_BYTES[dev.type] // (8 * d))
    for s in range(0, len(ids), rows):
        bits = unpack_bits(rq.signs[ids[s:s + rows]], d).double()
        sgn = (bits * 2 - 1) / math.sqrt(d)                # sign unit code
        ip_code[s:s + rows] = sgn @ qr_d                   # <code, q>
    # <o_unit, q> ~ ip_code / <o_unit, code>  (RaBitQ's unbiased estimator)
    ip_est = ip_code / rq.ip_unit[ids].clamp(min=1e-3)
    norms = rq.norms[ids]
    if rq.metric == "l2":
        # centered both sides
        return (norms ** 2 + float(np.float32(qn) ** 2)).double() - (2 * norms).double() * ip_est
    return -(ip_est * norms)


def rabitq_from_numpy(ref, device="cuda") -> RaBitQ:
    """A RaBitQ of the JAX package (numpy fields) as the port's, on ``device``."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    return RaBitQ(t(ref.rotation), t(ref.center), t(ref.signs), t(ref.norms),
                  t(ref.ip_unit), ref.metric)


def rabitq_to_numpy(rq: RaBitQ) -> dict:
    """The fields of the JAX package's ``RaBitQ`` (numpy arrays)."""
    return dict(rotation=rq.rotation.cpu().numpy(), center=rq.center.cpu().numpy(),
                signs=rq.signs.cpu().numpy(), norms=rq.norms.cpu().numpy(),
                ip_unit=rq.ip_unit.cpu().numpy(), metric=rq.metric)
