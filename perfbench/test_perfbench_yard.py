"""The metrics' arithmetic on hand-made timelines and counters."""
import pytest

from perfbench.yard import fee_bytes, intervals, launches, peaks


def test_union_merges_overlaps_and_clips():
    iv = [(5, 7), (0, 2), (1, 3), (6, 9), (9, 9), (20, 30)]
    assert intervals.union(iv) == [(0, 3), (5, 9), (20, 30)]
    assert intervals.union(iv, 2, 25) == [(2, 3), (5, 9), (20, 25)]
    assert intervals.busy(iv, 0, 10) == 7
    assert intervals.idle_share(iv, 0, 10) == pytest.approx(0.3)


def test_idle_share_of_an_empty_window_and_of_no_work():
    assert intervals.idle_share([(0, 5)], 3, 3) is None
    assert intervals.idle_share([], 0, 4) == 1.0
    assert intervals.idle_share([(-5, 50)], 0, 4) == 0.0
    assert intervals.gaps([], 0, 4) == [(0, 4)]


def test_gaps_longest_first():
    iv = [(1, 2), (2, 3), (6, 7), (7.5, 10)]
    assert intervals.gaps(iv, 0, 10) == [(3, 6), (0, 1), (7, 7.5)]


def test_launch_calls_counted_by_name():
    names = ["cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
             "cudaGraphLaunch", "cudaMemcpyAsync", "aten::add",
             "cudaStreamSynchronize", "cuLaunchKernelEx"]
    assert launches.count(names) == 5
    assert launches.per_query(names, 10) == 0.5
    assert launches.per_query(names, 0) is None
    assert launches.per_query(["aten::add"], 10) is None


def test_fee_bytes_f32_and_packed():
    assert fee_bytes.bytes_per_dim("f32", None, 128) == 4.0
    assert fee_bytes.bytes_per_dim("packed", 128 * 16, 128) == 2.0
    with pytest.raises(ValueError):
        fee_bytes.bytes_per_dim("packed", None, 128)
    b, f = fee_bytes.fee_work(lanes=100, dims=6400, queries=10, dim=128,
                              bpd=2.0, metric="l2")
    assert b == 6400 * 2.0 + 100 * 13 + 10 * 128 * 4
    assert f == 6400 * 3
    _, f_ip = fee_bytes.fee_work(100, 6400, 10, 128, 4.0, "ip")
    assert f_ip == 6400 * 2


def test_least_time_takes_the_binding_bound():
    t, which = peaks.least_seconds(3.35e12, 1.0)
    assert t == pytest.approx(1.0) and which == "bytes"
    t, which = peaks.least_seconds(1.0, 67e12 * 2)
    assert t == pytest.approx(2.0) and which == "flops"
