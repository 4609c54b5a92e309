"""The reference against brute force at a tiny size, and the judge."""
import numpy as np
import pytest
import torch

from perfbench.ref import exact, judge


def _data(metric, n=300, d=16, q=25, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g)
    qs = torch.randn(q, d, generator=g)
    if metric == "ip":
        x, qs = x / x.norm(dim=1, keepdim=True), qs / qs.norm(dim=1, keepdim=True)
    return x, qs


def _brute(x, qs, metric):
    xd, qd = x.double().numpy(), qs.double().numpy()
    if metric == "l2":
        return ((qd[:, None, :] - xd[None]) ** 2).sum(-1)
    return -(qd @ xd.T)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_topk_is_brute_force(metric):
    x, qs = _data(metric)
    d = _brute(x, qs, metric)
    want = np.stack([np.lexsort((np.arange(len(r)), r))[:10] for r in d])
    got = exact.topk(x, qs, 10, metric, block_bytes=4 * 300 * 7).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_distances_are_float64_exact(metric):
    x, qs = _data(metric)
    d = _brute(x, qs, metric)
    qidx = np.array([3, 0, 24])
    ids = np.array([[5, 6], [0, 299], [7, -1]])
    got = exact.distances(x, qs, qidx, ids, metric, block=4).numpy()
    assert got[0, 0] == pytest.approx(d[3, 5], rel=1e-12)
    assert got[1, 1] == pytest.approx(d[0, 299], rel=1e-12)
    assert np.isnan(got[2, 1])


def test_judge_finds_malformed_answers_and_gaps():
    x, qs = _data("l2")
    truth = exact.topk(x, qs, 5, "l2").numpy()
    qidx = np.arange(len(qs))
    dists = exact.distances(x, qs, qidx, truth, "l2").numpy()
    sound = judge.judge(x, qs, qidx, truth, dists.astype(np.float32), "l2")
    assert sound["malformed"] == 0 and sound["gap_max"] < 1e-6
    ids, d = truth.copy(), dists.copy()
    ids[0, 1] = ids[0, 0]                # a repeated id
    ids[1, 0] = 300                      # outside the rows
    d[2, 0], d[2, 1] = d[2, 1], d[2, 0] + 1e-3 if d[2, 1] == d[2, 0] else d[2, 0]
    d[3, 4] = np.inf
    ids[4, 2] = truth[4, 4] if truth[4, 4] not in ids[4] else ids[4, 2]
    bad = judge.judge(x, qs, qidx, ids, d, "l2")
    assert bad["malformed"] == 4
    ids2 = truth.copy()
    ids2[5, 0] = (ids2[5, 0] + 1) % 300 if (ids2[5, 0] + 1) % 300 not in ids2[5] else 299
    altered = judge.judge(x, qs, qidx, ids2, dists, "l2")
    assert altered["malformed"] == 0 and altered["gap_max"] > 1e-2
    ok, checks = judge.verdict(altered, dict(missing=0, malformed=0,
                                             gap_max=1e-3, gap_mean=1e-3))
    assert not ok and checks["gap_max"]["value"] > checks["gap_max"]["limit"]


def test_recall_counts_shared_ids():
    gt = np.array([[0, 1, 2, 9], [3, 4, 5, 9]])
    ids = np.array([[2, 1, 7], [5, 8, 3], [0, 9, 1]])
    assert judge.recall(ids, [0, 1, 0], gt, 3) == pytest.approx((2 + 2 + 2) / 9)


def test_control_is_the_search_in_bfloat16():
    x, qs = _data("l2", n=200, d=64)
    ids, d = exact.control_topk(x, qs, 10, "l2")
    assert ids.shape == (25, 10) and d.dtype == torch.float32
    numbers = judge.judge(x, qs, np.arange(25), ids.numpy(), d.numpy(), "l2")
    assert numbers["gap_max"] > 1e-3     # bfloat16's 8 significant bits


def test_recall_floor_holds_from_below():
    x, qs = _data("l2")
    truth = exact.topk(x, qs, 10, "l2").numpy()
    qidx = np.arange(len(qs))
    dists = exact.distances(x, qs, qidx, truth, "l2").numpy()
    limits = dict(missing=0, malformed=0, gap_max=1e-3, recall_at_10=0.9)
    sound = judge.judge(x, qs, qidx, truth, dists, "l2", gt=truth, k=10)
    ok, checks = judge.verdict(sound, limits)
    assert ok and sound["recall_at_10"] == 1.0 and checks["recall_at_10"]["at_least"]
    # a beam cut short: each answer's last two neighbours swapped for the
    # next ones out, every distance still exact and in order
    wide = exact.topk(x, qs, 12, "l2").numpy()
    short = np.concatenate([wide[:, :8], wide[:, 10:12]], axis=1)
    d = exact.distances(x, qs, qidx, short, "l2").numpy()
    cut = judge.judge(x, qs, qidx, short, d, "l2", gt=truth, k=10)
    ok, checks = judge.verdict(cut, limits)
    assert cut["malformed"] == 0 and cut["gap_max"] < 1e-6
    assert not ok and cut["recall_at_10"] == pytest.approx(0.8)
    # a number held that the run could not read fails
    assert not judge.verdict(dict(sound, recall_at_10=None), limits)[0]
