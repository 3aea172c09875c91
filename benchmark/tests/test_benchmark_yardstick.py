"""The work counts and bounds against sums worked by hand."""

from __future__ import annotations

import pytest

from harness import yardstick as y


def test_least_time_takes_the_larger_bound():
    ms, kind = y.least_ms(3.35e9, 0)
    assert kind == "bytes" and ms == pytest.approx(1.0)
    ms, kind = y.least_ms(0, 67e9)
    assert kind == "operations" and ms == pytest.approx(1.0)


def test_forest_counts():
    # 10 rows, 12 features, 6 classes, 100 trees, 700 visits;
    # 50 internal nodes (8 bytes each) and 60 leaves (6 floats each)
    assert y.forest_ops(10, 700, 100, 6) == 700 + 10 * 100 * 6
    assert y.forest_bytes(10, 12, 6, 50, 60) == (
        10 * 12 * 4 + 10 * 6 * 4 + 50 * 8 + 60 * 6 * 4)
    ms, kind = y.forest_bound(10, 700, 12, 100, 6, 50, 60)
    assert kind == "bytes"
    assert ms == pytest.approx((480 + 240 + 400 + 1440) / 3.35e12 * 1e3)


def test_knn_counts():
    # 65,536 rows against 61,440 corpus rows of 12 features, k = 5
    assert y.knn_pair_ops(12) == 25
    assert y.knn_ops(65536, 61440, 12) == 65536 * 61440 * 25
    assert y.knn_bytes(65536, 61440, 12, 5) == (
        65536 * 48 + 65536 * 40 + 61440 * 52)
    ms, kind = y.knn_bound(65536, 61440, 12, 5)
    assert kind == "operations"
    assert ms == pytest.approx(65536 * 61440 * 25 / 67e12 * 1e3)
    assert ms == pytest.approx(1.50241, rel=1e-4)


def test_svc_counts_the_function_not_the_kernel_layout():
    # 2,281 support vectors, 12 features, 6 classes: 15 pairs
    assert y.svc_pair_ops(12, 15) == 3 * 12 + 1 + 30
    assert y.svc_bytes(100, 2281, 12, 6, 15) == (
        100 * 48 + 100 * 60 + 2281 * 48 + 2281 * 5 * 4 + 15 * 4)
    ms, kind = y.svc_bound(65536, 2281, 12, 6)
    assert kind == "operations"
    assert ms == pytest.approx(65536 * 2281 * 67 / 67e12 * 1e3)
