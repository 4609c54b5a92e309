"""FEE-sPCA offline preprocessing (paper §IV-A).

Host numpy code, identical to the JAX package's, so the rotation and the
alpha/beta fit are bit-identical between the two packages.

PCA-rotate the vector database so that leading dimensions carry most of the
energy, then derive the estimation parameters:

  alpha_k = sum_{i<=D} lambda_i / sum_{i<=k} lambda_i          (Eq. 3)
  d_est^k = alpha_k * d_part^k / beta_k                        (Fig. 6)

beta_k >= 1 is the statistics-based correction from Chebyshev's inequality
(Eq. 5/6): with Var_k = Var(alpha_k * d_part^k / d_all) measured on sampled
(query, vector) pairs during index construction,

  eps_k = sqrt(Var_k / (2 * (1 - p_target)));  beta_k = 1 + eps_k

so that P(alpha_k * d_part^k / beta_k < d_all) >= p_target.

For L2 the rotation is applied to mean-centered data (translation+rotation
preserve L2 distances exactly).  For inner-product (IP) "distance" the data is
rotated by the eigenvectors of the *second-moment* matrix without centering
(rotation preserves inner products; centering would not).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SPCA:
    mean: np.ndarray        # (D,)  zeros for IP
    components: np.ndarray  # (D, D) columns = eigvecs, descending eigenvalue
    eigvals: np.ndarray     # (D,)  descending, >= 0
    metric: str             # "l2" | "ip"

    @property
    def dim(self) -> int:
        return self.components.shape[0]

    def transform(self, x: np.ndarray) -> np.ndarray:
        if self.metric == "l2":
            x = x - self.mean
        return np.asarray(x, np.float32) @ self.components.astype(np.float32)

    def alpha(self, prefix_lens: np.ndarray) -> np.ndarray:
        """alpha_k for k in prefix_lens (Eq. 3)."""
        lam = np.maximum(self.eigvals, 0.0)
        csum = np.cumsum(lam)
        total = csum[-1]
        k = np.clip(np.asarray(prefix_lens, np.int64), 1, self.dim)
        return (total / np.maximum(csum[k - 1], 1e-30)).astype(np.float32)


def fit_spca(x: np.ndarray, metric: str = "l2") -> SPCA:
    x = np.asarray(x, np.float64)
    n, d = x.shape
    if metric == "l2":
        mean = x.mean(axis=0)
        xc = x - mean
        cov = (xc.T @ xc) / max(n - 1, 1)
    elif metric == "ip":
        mean = np.zeros(d)
        cov = (x.T @ x) / max(n, 1)  # second moment: rotation-only PCA
    else:
        raise ValueError(f"unknown metric {metric!r}")
    w, v = np.linalg.eigh(cov)          # ascending
    order = np.argsort(w)[::-1]
    return SPCA(
        mean=mean.astype(np.float32),
        components=np.ascontiguousarray(v[:, order]).astype(np.float32),
        eigvals=np.maximum(w[order], 0.0).astype(np.float64),
        metric=metric,
    )


def partial_scores(db: np.ndarray, queries: np.ndarray, seg: int, metric: str):
    """Segment-cumulative scores.

    Returns (cum, full): cum[(Q, C, S)] = score over first (s+1)*seg dims,
    full[(Q, C)] = score over all dims.  Score convention: lower = better
    (squared L2, or negated inner product).
    """
    q, c = queries.shape[0], db.shape[0]
    d = db.shape[1]
    s = d // seg
    assert s * seg == d, (d, seg)
    if metric == "l2":
        diff2 = (queries[:, None, :] - db[None, :, :]) ** 2
        per_seg = diff2.reshape(q, c, s, seg).sum(-1)
    else:
        prod = queries[:, None, :] * db[None, :, :]
        per_seg = -prod.reshape(q, c, s, seg).sum(-1)
    cum = np.cumsum(per_seg, axis=2)
    return cum, cum[:, :, -1]


def fit_beta(
    db_rot: np.ndarray,
    sample_queries_rot: np.ndarray,
    eigvals: np.ndarray,
    seg: int,
    metric: str = "l2",
    p_target: float = 0.9,
    n_pairs: int = 4096,
    seed: int = 0,
) -> dict:
    """Measure Var_k of (alpha_k * d_part^k / d_all) and derive beta_k (Eq. 6).

    For IP the ratio statistic is ill-conditioned (scores cross zero), so we
    additionally fit an *additive* margin m_k = c * std(alpha_k*s_part - s_all)
    with c from the same Chebyshev budget; the online rule uses
      est = alpha_k * s_part / beta_k          (l2, paper-faithful)
      est = alpha_k * s_part - m_k             (ip)
    """
    rng = np.random.default_rng(seed)
    nq = min(len(sample_queries_rot), 256)
    per_q = max(4, n_pairs // nq)
    qi = rng.choice(len(sample_queries_rot), nq, replace=False)
    ci = rng.choice(len(db_rot), (nq, per_q))
    d = db_rot.shape[1]
    s = d // seg
    lam = np.maximum(np.asarray(eigvals, np.float64), 0.0)
    csum = np.cumsum(lam)
    alpha = (csum[-1] / np.maximum(csum[np.arange(1, s + 1) * seg - 1], 1e-30))

    cums = np.empty((nq, per_q, s), np.float64)
    fulls = np.empty((nq, per_q), np.float64)
    for j in range(nq):
        cum, full = partial_scores(db_rot[ci[j]], sample_queries_rot[qi[j]][None], seg, metric)
        cums[j], fulls[j] = cum[0], full[0]

    est_raw = alpha[None, None, :] * cums                     # (nq, per_q, s)
    if metric == "l2":
        ratio = est_raw / np.maximum(fulls[..., None], 1e-30)
        var_k = ratio.reshape(-1, s).var(axis=0)
        eps_k = np.sqrt(var_k / (2.0 * max(1e-6, 1.0 - p_target)))
        beta = 1.0 + eps_k
        margin = np.zeros(s)
    else:
        err = est_raw - fulls[..., None]                      # est - true, >0 = overshoot
        std_k = err.reshape(-1, s).std(axis=0)
        c = 1.0 / np.sqrt(2.0 * max(1e-6, 1.0 - p_target))    # Chebyshev one-sided budget
        margin = c * std_k
        beta = np.ones(s)
        var_k = err.reshape(-1, s).var(axis=0)
    # final segment: estimate is exact
    beta[-1] = 1.0
    margin[-1] = 0.0
    return dict(
        alpha=alpha.astype(np.float32),
        beta=beta.astype(np.float32),
        margin=margin.astype(np.float32),
        var_k=var_k.astype(np.float32),
        seg=seg,
        p_target=p_target,
        metric=metric,
    )
