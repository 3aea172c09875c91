"""KMeans training — the torch port of
``traffic_classifier_sdn_tpu/train/kmeans.py``: k-means++ seeding, Lloyd
iterations (assignment, one-hot matmul sums, empty clusters keep their
center) and ``n_init`` restarts, the one of least inertia kept.

It runs on the device of its input. The restarts run one after another
(JAX vmaps them), and k-means++ draws from a ``torch.Generator`` of that
device seeded by ``seed``, so the draws are not ``jax.random``'s: what
carries over from JAX is Lloyd's step from given initial centers
(``_lloyd``). Distances are taken in the difference form, summed over
features in ascending order: at this data's ~8e8 feature scale the dot
expansion cancels in float32, and its d² can go negative and corrupt the
k-means++ weights.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.kmeans import KmeansModel


def _sq_dist(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(N, K) ``Σ_f (x_f − c_f)²``, summed over features in order."""
    d2 = None
    for f in range(X.shape[1]):
        diff = X[:, f, None] - centers[None, :, f]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    return d2


def _assign(X: torch.Tensor, centers: torch.Tensor):
    """((N,) nearest-center ids, lowest index on ties; (N, K) d²)."""
    d2 = _sq_dist(X, centers)
    return torch.argmin(d2, dim=1), d2


def _plusplus_init(gen: torch.Generator, X: torch.Tensor, k: int):
    """k-means++ seeding: the first center uniform, each next one drawn
    with odds proportional to the squared distance to its nearest chosen
    center (uniform again if every row sits on a chosen center)."""
    n = X.shape[0]
    first = torch.randint(0, n, (1,), generator=gen, device=X.device)
    centers = [X[first]]
    dmin = torch.clamp(_sq_dist(X, centers[0])[:, 0], min=0.0)
    for _ in range(1, k):
        w = torch.where(dmin.sum() > 0, dmin, torch.ones_like(dmin))
        idx = torch.multinomial(w, 1, generator=gen)
        centers.append(X[idx])
        dmin = torch.minimum(dmin, _sq_dist(X, centers[-1])[:, 0])
    return torch.cat(centers)


def _lloyd(X: torch.Tensor, centers0: torch.Tensor, n_iter: int):
    """(centers, inertia) after ``n_iter`` Lloyd steps from ``centers0``:
    per-cluster sums as one one-hot matmul, an empty cluster keeping its
    center (sklearn relocates it; JAX keeps it too)."""
    centers = centers0
    K = centers.shape[0]
    for _ in range(n_iter):
        labels, _ = _assign(X, centers)
        onehot = torch.nn.functional.one_hot(labels, K).to(X.dtype)
        counts = onehot.sum(0)
        sums = torch.matmul(onehot.t(), X)
        new = sums / torch.clamp(counts[:, None], min=1.0)
        centers = torch.where(counts[:, None] > 0, new, centers)
    labels, d2 = _assign(X, centers)
    inertia = torch.gather(d2, 1, labels[:, None]).sum()
    return centers, inertia


def fit(X, k: int = 4, *, n_init: int = 10, n_iter: int = 50,
        seed: int = 0, device=None) -> tuple[KmeansModel, float]:
    """(KmeansModel, inertia) of the best of ``n_init`` k-means++ + Lloyd
    runs on X (N, F). A tensor X runs on its own device unless ``device``
    is given; a numpy X on ``device`` (default CUDA, see device.py)."""
    if isinstance(X, torch.Tensor):
        dev = X.device if device is None else resolve_device(device)
        X = X.to(dev, torch.float32)
    else:
        dev = resolve_device(device)
        X = torch.tensor(np.asarray(X, np.float32), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    best = None
    for _ in range(n_init):
        centers, inertia = _lloyd(X, _plusplus_init(gen, X, k), n_iter)
        if best is None or float(inertia) < best[1]:
            best = (centers, float(inertia))
    return KmeansModel(centers=best[0].contiguous()), best[1]
