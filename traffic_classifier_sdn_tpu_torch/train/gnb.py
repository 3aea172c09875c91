"""Gaussian naive Bayes training as closed-form segment moments — the torch
port of ``traffic_classifier_sdn_tpu/train/gnb.py``. The fit is
train/distributed.fit_gnb (float64 one-hot moments, two-pass variance,
sklearn's smoothing) on a one-device mesh.
"""

from __future__ import annotations

from ..models.gnb import GnbModel


def fit(X, y, n_classes: int, *, var_smoothing: float = 1e-9,
        device=None) -> GnbModel:
    """Fit on ``device`` (default CUDA, see device.py); returns the port's
    ``GnbModel`` (the float64 moments folded and rounded once to
    float32)."""
    from . import distributed

    return distributed.fit_gnb(distributed.single_device_mesh(device), X, y,
                               n_classes, var_smoothing=var_smoothing)
