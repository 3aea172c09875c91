"""KMeans training — the torch port of
``traffic_classifier_sdn_tpu/train/kmeans.py``: k-means++ seeding, Lloyd
iterations (assignment, one-hot matmul sums, empty clusters keep their
center) and ``n_init`` restarts, the one of least inertia kept.

It runs on the device of its input. The restarts run one after another
(JAX vmaps them), and k-means++ draws from a host ``torch.Generator``
seeded by ``seed`` (the weights it samples by cross to the host), so a
fit on the card draws what one on the CPU draws. The draws are not
``jax.random``'s: what carries over from JAX is Lloyd's step from given
initial centers (``_lloyd``). Distances are taken in the difference form, summed over
features in ascending order: at this data's ~8e8 feature scale the dot
expansion cancels in float32, and its d² can go negative and corrupt the
k-means++ weights.
"""

from __future__ import annotations

import torch

from ..models.kmeans import KmeansModel
from ..parallel.mesh import shard_sum


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
    first = torch.randint(0, n, (1,), generator=gen)
    centers = [X[first.to(X.device)]]
    dmin = torch.clamp(_sq_dist(X, centers[0])[:, 0], min=0.0)
    for _ in range(1, k):
        w = torch.where(dmin.sum() > 0, dmin, torch.ones_like(dmin))
        idx = torch.multinomial(w.cpu(), 1, generator=gen)
        centers.append(X[idx.to(X.device)])
        dmin = torch.minimum(dmin, _sq_dist(X, centers[-1])[:, 0])
    return torch.cat(centers)


def _lloyd(X, centers0: torch.Tensor, n_iter: int, mesh=None):
    """(centers, inertia) after ``n_iter`` Lloyd steps from ``centers0``:
    per-cluster sums as one one-hot matmul, an empty cluster keeping its
    center (sklearn relocates it; JAX keeps it too). ``X`` may be a list
    of row shards (train/distributed.fit_kmeans): each shard assigns its
    rows and sums them, and the sums add in shard order
    (``parallel.mesh.shard_sum``; on a ``mesh`` spanning processes the
    list holds None in another rank's shards and the sums add across the
    ranks)."""
    shards = [X] if isinstance(X, torch.Tensor) else list(X)
    centers = centers0
    K = centers.shape[0]
    for _ in range(n_iter):
        counts: list = [None] * len(shards)
        sums: list = [None] * len(shards)
        for s, xs in enumerate(shards):
            if xs is None:
                continue
            labels, _ = _assign(xs, centers.to(xs.device))
            onehot = torch.nn.functional.one_hot(labels, K).to(xs.dtype)
            counts[s] = onehot.sum(0)
            sums[s] = torch.matmul(onehot.t(), xs)
        counts, sums = shard_sum(counts, mesh), shard_sum(sums, mesh)
        new = sums / torch.clamp(counts[:, None], min=1.0)
        centers = torch.where(counts[:, None] > 0, new, centers)
    return centers, inertia(shards, centers, mesh)


def inertia(X, centers: torch.Tensor, mesh=None) -> torch.Tensor:
    """Σ over the rows of ``X`` (a tensor or row shards, summed in shard
    order; across the ranks of a spanning ``mesh``) of the squared
    distance to the nearest of ``centers``."""
    shards = [X] if isinstance(X, torch.Tensor) else list(X)
    parts: list = [None] * len(shards)
    for s, xs in enumerate(shards):
        if xs is None:
            continue
        labels, d2 = _assign(xs, centers.to(xs.device))
        parts[s] = torch.gather(d2, 1, labels[:, None]).sum()
    return shard_sum(parts, mesh)


def fit(X, k: int = 4, *, n_init: int = 10, n_iter: int = 50,
        seed: int = 0, device=None) -> tuple[KmeansModel, float]:
    """(KmeansModel, inertia) of the best of ``n_init`` k-means++ + Lloyd
    runs on X (N, F): train/distributed.fit_kmeans on a one-device mesh.
    A tensor X runs on its own device unless ``device`` is given; a numpy
    X on ``device`` (default CUDA, see device.py)."""
    from . import distributed

    if isinstance(X, torch.Tensor) and device is None:
        device = X.device
    return distributed.fit_kmeans(distributed.single_device_mesh(device), X,
                                  k, n_init=n_init, n_iter=n_iter, seed=seed)
