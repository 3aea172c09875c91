"""Reading a device trace: the window, the busy union, device time by the
benchmark range that launched it, the idle gaps and what the host did."""

from __future__ import annotations

import pytest

from harness import profile


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_summary_of_a_small_trace():
    events = [
        _x("bench.window", "user_annotation", 0, 1000),
        _x("bench.scatter", "user_annotation", 0, 100),
        _x("cudaLaunchKernel", "cuda_runtime", 10, 5, corr=1),
        _x("bench.dispatch", "user_annotation", 400, 100),
        _x("cudaLaunchKernel", "cuda_runtime", 410, 5, tid=2, corr=2),
        _x("cudaLaunchKernel", "cuda_runtime", 420, 5, corr=3),
        _x("apply_kernel", "kernel", 20, 200, tid=7, corr=1),
        _x("void knn_topk_kernel<1, 12>", "kernel", 430, 300, tid=7, corr=3),
        _x("worker_kernel", "kernel", 500, 100, tid=7, corr=2),
        _x("Memcpy DtoH", "gpu_memcpy", 990, 50, tid=8),
    ]
    s = profile.summarize(events)
    assert s["window_s"] == pytest.approx(1000e-6)
    # busy: [20, 220] + [430, 730] + [990, 1000] (clipped to the window)
    assert s["busy_s"] == pytest.approx((200 + 300 + 10) * 1e-6)
    assert s["by_range_s"]["bench.scatter"] == pytest.approx(200e-6)
    assert s["by_range_s"]["bench.dispatch"] == pytest.approx(300e-6)
    assert profile.kernel_seconds(s, "knn_topk") == pytest.approx(300e-6)
    assert profile.kernel_seconds(s, "forest_proba") is None
    gaps = dict((round(v * 1e6), k) for k, v in s["idle_gaps"])
    assert gaps[210] == "host: no benchmark range"  # 220..430
    assert gaps[20] == "host: bench.scatter"  # 0..20
    assert s["device_ops"][0][0] == "void knn_topk_kernel<1, 12>"


def test_no_window_no_summary():
    assert profile.summarize([_x("k", "kernel", 0, 1)]) is None
