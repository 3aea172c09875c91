"""KMeans nearest-centroid assignment — the torch port of
``traffic_classifier_sdn_tpu/models/kmeans.py``.

The score of centroid k is the negated squared distance ``−Σ_f (x_f −
μ_kf)²``, higher = closer, taken in the difference form, never the dot
expansion ``−2 x·μ + ‖μ‖²``: features reach ~8e8, where ‖x‖²-scale terms
cancel catastrophically in float32. K is 4, so the (N, K, F) difference
is small. Plain torch ops on the card too: the JAX package computes this
in XLA, in no hand-written kernel.

Cluster ids decode through ``CLUSTER_LABELS_CHECKPOINT``, the map of the
reference checkpoint's 4 clusters (derived in the reference notebook
``1_log_Kmeans.ipynb`` by matching cluster modes on the 4-class data); a
checkpoint that stores no class names is decoded with it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .base import argmax_labels

CLUSTER_LABELS_CHECKPOINT = ("dns", "ping", "telnet", "voice")


class KmeansModel(nn.Module):
    STATIC_FIELDS = ()  # non-array checkpoint fields

    def __init__(self, centers):
        super().__init__()
        self.register_buffer("centers", centers)  # (K, F) f32

    @classmethod
    def from_numpy(cls, d, device=None) -> "KmeansModel":
        """Build from an importer dict (``cluster_centers``) on ``device``
        (default CUDA, see device.py)."""
        device = resolve_device(device)
        return cls(centers=torch.tensor(np.asarray(d["cluster_centers"]),
                                        dtype=torch.float32, device=device))

    def scores(self, X: torch.Tensor) -> torch.Tensor:
        """Negated squared distance to each centroid, (N, K)."""
        diff = X[:, None, :] - self.centers[None, :, :]
        return -torch.sum(diff * diff, dim=-1)

    def predict(self, X: torch.Tensor) -> torch.Tensor:
        return argmax_labels(self.scores(X))

    def predict_scores(self, X: torch.Tensor):
        """(cluster ids, negated-inertia scores) from one score
        computation."""
        s = self.scores(X)
        return argmax_labels(s), s

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return self.predict(X)
