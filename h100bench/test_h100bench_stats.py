"""The harness's statistics and its reading of a device trace, on
synthetic inputs."""

import pytest

from h100bench import stats
from h100bench.trace import Trace, short_name


def test_rate_over_a_window_with_a_stall():
    # 10 calls of 30 frames, one of them stalled for 2 s: the rate keeps the stall
    lat = [0.16] * 9 + [2.16]
    assert stats.rate(300, sum(lat)) == pytest.approx(300 / 3.6)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_p95_over_all_clips():
    lat = list(range(1, 201))  # 200 clips
    assert stats.p95(lat) == pytest.approx(190.05)
    assert stats.p95([7.0]) == 7.0
    # one slow clip in twenty moves the tail, not the median
    assert stats.p95([1.0] * 19 + [9.0]) == pytest.approx(1.4)


def test_union_of_intervals():
    assert stats.intervals_union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_idle_share_from_a_synthetic_kernel_list():
    events = [
        _ev("kernel", "void at::native::vectorized_elementwise_kernel<4, X>(int, Y)", 0, 100),
        _ev("kernel", "upsample_argmax_kernel<19>", 50, 100),  # overlaps the first
        _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 400, 100),
        _ev("cuda_runtime", "cudaStreamSynchronize", 150, 240),
        _ev("cpu_op", "aten::add", 0, 1000),  # host ops are not device time
    ]
    tr = Trace(events)
    assert tr.busy_s() == pytest.approx(250e-6)
    assert tr.seconds_where(r"at::native::") == pytest.approx(100e-6)
    assert tr.count_where(r"upsample_argmax") == 1
    gaps = dict(tr.idle_gaps())
    assert gaps == {"cudaStreamSynchronize": pytest.approx(240e-6),
                    "host code (no CUDA call)": pytest.approx(10e-6)}
    assert dict(tr.top_ops()) == {
        "at::native::vectorized_elementwise_kernel": pytest.approx(100e-6),
        "upsample_argmax_kernel": pytest.approx(100e-6), "Memcpy HtoD": pytest.approx(100e-6)}


def test_gaps_are_split_by_what_the_host_was_doing():
    tr = Trace([_ev("kernel", "k", 0, 10), _ev("kernel", "k", 30, 10),
                _ev("cuda_runtime", "cudaMemcpyAsync", 32, 18),
                _ev("cuda_runtime", "cudaDeviceSynchronize", 60, 5)])
    # 10..30: host code; 40..50: the copy call; 50..60 host code; 60..65 the sync
    assert dict(tr.idle_gaps()) == {"host code (no CUDA call)": pytest.approx(30e-6),
                                    "cudaMemcpyAsync": pytest.approx(10e-6),
                                    "cudaDeviceSynchronize": pytest.approx(5e-6)}


def test_short_name():
    assert short_name("void cutlass::Kernel<a<b>>(c)") == "cutlass::Kernel"
    assert short_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"
