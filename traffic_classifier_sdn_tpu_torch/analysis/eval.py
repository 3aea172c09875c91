"""Evaluation: accuracy, confusion matrix, cluster→label mode matching —
the torch port of ``traffic_classifier_sdn_tpu/analysis/eval.py``.

The reference's only quality control is notebook-side held-out accuracy
and confusion-matrix plots (SURVEY.md §4); the KMeans cluster→label map
is the mode of the true labels inside each cluster (1_log_Kmeans.ipynb
cell 116). Each function runs on the device of its inputs.
"""

from __future__ import annotations

import torch


def accuracy(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Fraction of exact matches (scalar float32)."""
    return (y_true == y_pred).to(torch.float32).mean()


def confusion_matrix(y_true: torch.Tensor, y_pred: torch.Tensor,
                     n_classes: int) -> torch.Tensor:
    """(n_classes, n_classes) int32; rows = true, cols = predicted —
    sklearn's orientation."""
    idx = y_true.to(torch.int64) * n_classes + y_pred.to(torch.int64)
    flat = torch.bincount(idx, minlength=n_classes * n_classes)
    return flat.to(torch.int32).reshape(n_classes, n_classes)


def match_clusters(cluster_ids: torch.Tensor, y_true: torch.Tensor, k: int,
                   n_classes: int) -> torch.Tensor:
    """cluster → label map by majority vote (the notebook's mode
    matching): entry c is the most frequent true label among samples
    assigned to cluster c. Ties resolve to the smallest label, matching
    scipy.stats.mode. Empty clusters map to label 0."""
    idx = cluster_ids.to(torch.int64) * n_classes + y_true.to(torch.int64)
    counts = torch.bincount(idx, minlength=k * n_classes).reshape(
        k, n_classes)
    # torch.argmax returns the first maximal index, as jnp.argmax does
    return torch.argmax(counts, dim=1).to(torch.int32)


def clustering_accuracy(cluster_ids: torch.Tensor, y_true: torch.Tensor,
                        k: int, n_classes: int) -> torch.Tensor:
    """Accuracy after mode matching — the notebook's KMeans score
    (1_log_Kmeans.ipynb cell 118: 46.38% on the 4-class data)."""
    remap = match_clusters(cluster_ids, y_true, k, n_classes)
    return accuracy(y_true, remap[cluster_ids.to(torch.int64)])
