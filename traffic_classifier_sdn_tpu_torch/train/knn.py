"""KNN "training" — the torch port of
``traffic_classifier_sdn_tpu/train/knn.py``: the corpus is the labeled
window itself, registered on the device (the two-float split and the
half squared norms of ``KnnModel.from_numpy``)."""

from __future__ import annotations

import numpy as np

from ..models.knn import KnnModel


def fit(X, y, *, n_neighbors: int = 5, n_classes: int | None = None,
        device=None) -> KnnModel:
    """Register the corpus on ``device`` (default CUDA, see device.py)."""
    y = np.asarray(y)
    if n_classes is None:
        n_classes = int(y.max()) + 1
    return KnnModel.from_numpy({
        "fit_X": np.asarray(X, np.float64),
        "y": y.astype(np.int32),
        "n_neighbors": n_neighbors,
        "classes": np.arange(n_classes),
    }, device=device)
