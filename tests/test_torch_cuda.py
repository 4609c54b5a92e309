"""The CUDA kernels against their plain PyTorch versions on the same inputs.

These need an NVIDIA GPU and ``nvcc`` (the kernels are built at first use);
without a card they skip.  The file imports no JAX, so it runs on the machine
with the card:  ``python -m pytest -m cuda tests/test_torch_cuda.py``.
Tolerance as in ``repro_torch.kernels.check``; the decode and packed-vs-f32
scores are bit-exact.  ``SCALAR_SHAPES`` (seg % 4 != 0) run the f32 kernel's
one-float-at-a-time loads, every other shape its float4 loads.
"""
import numpy as np
import pytest
import torch

from fee_cases import inputs
from repro_torch.core import dfloat as dfl
from repro_torch.kernels import dfloat_unpack as unpack_kernel
from repro_torch.kernels import fee_distance as fee_kernel
from repro_torch.kernels import ref
from repro_torch.kernels.check import SCALAR_SHAPES, SHAPES, compare_fee, near_threshold


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c,d,seg", SHAPES + SCALAR_SHAPES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_fee_kernels_match_plain(cuda, c, d, seg, metric):
    q, x, thr, alpha, beta, margin = inputs(c, d, seg, metric, c + d)
    rng = np.random.default_rng(c)
    n_q = 3
    ids = torch.from_numpy(rng.integers(0, c, (n_q, c)).astype(np.int32)).to(cuda)
    qs = torch.from_numpy(np.stack([q, -q, q * 0.5])).to(cuda)
    thrs = torch.full((n_q,), float(thr), device=cuda)
    xt, at, bt, mt = (torch.from_numpy(a).to(cuda) for a in (x, alpha, beta, margin))
    mask = torch.from_numpy(rng.random((n_q, c)) < 0.8).to(cuda)
    got = fee_kernel.fee_distance(xt, ids, qs, thrs, at, bt, mt, seg=seg,
                                  metric=metric, lane_mask=mask)
    want = ref.fee_distance_gather_ref(xt, ids, qs, thrs, at, bt, mt, seg=seg,
                                       metric=metric, lane_mask=mask)
    near = near_threshold(xt[ids.long()], qs, thrs, at, bt, mt, seg=seg, metric=metric)
    compare_fee(got, want, near)
    cfg = dfl.make_config(d, [(16, 5, d // 2), (12, 4, d - d // 2)], x)
    packed = torch.from_numpy(dfl.pack_db(x, cfg).view(np.int32)).to(cuda)
    pk = fee_kernel.fee_distance_packed(packed, ids, qs, thrs, at, bt, mt,
                                        dfloat_cfg=cfg, seg=seg, metric=metric,
                                        lane_mask=mask)
    xq = unpack_kernel.dfloat_unpack(packed, cfg)
    assert torch.equal(xq.cpu(), dfl.unpack_rows(packed.cpu(), cfg))
    f32 = fee_kernel.fee_distance(xq, ids, qs, thrs, at, bt, mt, seg=seg,
                                  metric=metric, lane_mask=mask)
    for a, b in zip(pk, f32):          # packed == f32 over the decoded rows
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_wrappers_reject_badinputs(cuda):
    x = torch.zeros((8, 32), device=cuda)
    ones = torch.ones(2, device=cuda)
    q = torch.zeros((1, 32), device=cuda)
    thr = torch.zeros(1, device=cuda)
    with pytest.raises(TypeError):
        fee_kernel.fee_distance(x, torch.zeros((1, 4), dtype=torch.int64, device=cuda),
                                q, thr, ones, ones, ones, seg=16)
    with pytest.raises(ValueError):
        fee_kernel.fee_distance(x, torch.zeros((1, 4), dtype=torch.int32, device=cuda),
                                q[:, :16], thr, ones, ones, ones, seg=16)
