"""Feature-level early exiting with statistics-based PCA (FEE-sPCA, paper §IV-A).

Distances are accumulated segment by segment; after segment k the estimated
full distance

    est_k = alpha_k * part_k / beta_k - margin_k

is compared with the beam threshold; the first segment where est_k >= threshold
rejects the candidate and stops its remaining feature traffic.

This module is the plain-PyTorch oracle of the search semantics (full score
for every lane); ``kernels/ref.py`` holds the kernels' contract (partial score
for rejected lanes), and ``kernels/fee_distance.py`` the CUDA kernels.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device

BIG = 3.0e38


@dataclasses.dataclass
class FeeParams:
    """Typed FEE-sPCA estimation parameters (one (S,) f32 tensor per field).

    Static config (seg width, metric) lives in ``SearchConfig`` /
    ``IndexSpec``, not here — this is pure device data.
    """

    alpha: torch.Tensor   # (S,) energy ratios, Eq. 3
    beta: torch.Tensor    # (S,) Chebyshev correction, >= 1 (l2)
    margin: torch.Tensor  # (S,) additive margin (ip); zeros for l2

    @property
    def n_seg(self) -> int:
        return self.alpha.shape[0]

    @classmethod
    def identity(cls, n_seg: int, device="cuda") -> "FeeParams":
        """alpha=beta=1, margin=0: plain d_part early exit (no estimation)."""
        ones = torch.ones(n_seg, dtype=torch.float32, device=resolve_device(device))
        return cls(alpha=ones, beta=ones.clone(), margin=torch.zeros_like(ones))

    @classmethod
    def coerce(cls, obj, device=None) -> "FeeParams | None":
        """Accept FeeParams, an alpha/beta/margin dict (numpy or tensors), or
        None; ``device`` moves the fields there."""
        if obj is None:
            return None
        if isinstance(obj, cls):
            obj = obj.as_dict()
        return cls(**{k: torch.as_tensor(obj[k], dtype=torch.float32,
                                         device=device)
                      for k in ("alpha", "beta", "margin")})

    def as_dict(self) -> dict:
        return dict(alpha=self.alpha, beta=self.beta, margin=self.margin)

    def split(self, n_coarse: int) -> "tuple[FeeParams, FeeParams]":
        """Per-tier parameter views for tiered storage: checkpoints
        ``[0, n_coarse)`` drive the coarse tier's exit decisions, the rest
        the residual continuation; their concatenation is the unsplit fit."""
        return (FeeParams(self.alpha[:n_coarse], self.beta[:n_coarse],
                          self.margin[:n_coarse]),
                FeeParams(self.alpha[n_coarse:], self.beta[n_coarse:],
                          self.margin[n_coarse:]))


def fee_distance(q, x, threshold, alpha, beta, margin, *, seg: int,
                 metric: str = "l2"):
    """FEE-sPCA distance of candidates ``x`` (C, D) against query ``q`` (D,).

    Returns (score, rejected, segs_used):
      score     (C,) full score (squared L2 / negated IP) — exact for survivors
      rejected  (C,) bool, True if early exit triggered before the last segment
      segs_used (C,) int32, number of segments actually touched (memory model)
    """
    c, d = x.shape
    s = d // seg
    if metric == "l2":
        per = ((x - q[None, :]) ** 2).reshape(c, s, seg).sum(-1)
    elif metric == "ip":
        per = -(x * q[None, :]).reshape(c, s, seg).sum(-1)
    else:
        raise ValueError(metric)
    cum = torch.cumsum(per, dim=1)
    est = alpha[None, :] * cum / beta[None, :] - margin[None, :]
    exit_mask = est[:, : s - 1] >= threshold
    any_exit = exit_mask.any(dim=1)
    first_exit = torch.argmax(exit_mask.to(torch.uint8), dim=1)
    segs_used = torch.where(any_exit, first_exit + 1, s).to(torch.int32)
    return cum[:, -1], any_exit, segs_used


def exact_distance(q, x, *, metric: str = "l2"):
    """Exact score of rows ``x`` (..., C, D) against ``q`` (..., D)."""
    if metric == "l2":
        return ((x - q[..., None, :]) ** 2).sum(-1)
    return -(x * q[..., None, :]).sum(-1)
