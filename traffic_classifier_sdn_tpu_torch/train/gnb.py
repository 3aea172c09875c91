"""Gaussian naive Bayes training as closed-form segment moments — the torch
port of ``traffic_classifier_sdn_tpu/train/gnb.py`` and of its
single-device ``train/distributed.fit_gnb`` (the path the drift loop's
refit takes).

Per-class counts, means and variances as one-hot matmuls in float64 on
the given device, the variance in two passes (centering first: features
reach ~1e8, so E[x²]−E[x]² cancels), plus sklearn's smoothing
``var += var_smoothing · max(global per-feature variance)``. An empty
class has a 0/0 mean; ``nan_to_num`` keeps it out of the centering, and
the model's fold (models/gnb.fold) makes it absent (prior 0).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.gnb import GnbModel


def moments(X: torch.Tensor, y: torch.Tensor, n_classes: int):
    """Per-class (count, mean, var) via one-hot segment sums."""
    onehot = torch.nn.functional.one_hot(y, n_classes).to(X.dtype)  # (N, C)
    counts = onehot.sum(0)
    mean = (onehot.t() @ X) / counts[:, None]
    centered = X - torch.nan_to_num(mean)[y]
    var = (onehot.t() @ (centered * centered)) / counts[:, None]
    return counts, mean, var


def fit(X, y, n_classes: int, *, var_smoothing: float = 1e-9,
        device=None) -> GnbModel:
    """Fit on ``device`` (default CUDA, see device.py); returns the port's
    ``GnbModel`` (the float64 moments folded and rounded once to
    float32)."""
    device = resolve_device(device)
    X = torch.tensor(np.asarray(X, np.float64), device=device)
    y = torch.tensor(np.asarray(y, np.int64), device=device)
    counts, theta, var = moments(X, y, n_classes)
    total = counts.sum()
    mu_all = X.sum(0) / total
    global_var = ((X - mu_all) ** 2).sum(0) / total
    var = var + var_smoothing * global_var.max()
    return GnbModel.from_numpy({
        "theta": theta.cpu().numpy(),
        "var": var.cpu().numpy(),
        "class_prior": (counts / total).cpu().numpy(),
    }, device=device)
