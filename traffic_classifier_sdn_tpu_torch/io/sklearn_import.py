"""Threshold rounding shared by every forest path of the port — a copy of
``f32_safe_thresholds`` from ``traffic_classifier_sdn_tpu/io/sklearn_import.py``
(the sklearn pickle importers themselves are not ported)."""

from __future__ import annotations

import numpy as np


def f32_safe_thresholds(thr: np.ndarray) -> np.ndarray:
    """Round float64 split thresholds DOWN to float32 so that
    ``x ≤ f32(thr)`` agrees with sklearn's ``f32(x) ≤ f64(thr)`` for every
    float32 x: sklearn stores float64 midpoints of adjacent float32 feature
    values, and a midpoint that rounds *up* under f32 would flip the
    decision for a sample sitting exactly at the upper value."""
    t32 = thr.astype(np.float32)
    round_up = t32.astype(np.float64) > thr
    return np.where(
        round_up, np.nextafter(t32, np.float32(-np.inf)), t32
    ).astype(np.float32)
