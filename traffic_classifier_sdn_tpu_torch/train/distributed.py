"""Data-parallel training over the port's mesh — the torch port of
``traffic_classifier_sdn_tpu/train/distributed.py``.

The JAX package shards the flow batch over the mesh's data axis and lets
XLA place the cross-chip reductions (local partial sums + ``psum``). The
port's mesh (parallel/mesh.py) has no collective runtime: the batch is
split with ``batch_sharded``, each shard computes its partial sums on its
own device, and the partial sums add in shard order
(``mesh.shard_sum``), which stands for the ``psum``. The model state is
replicated; the result lands on the first shard's device.

- ``fit_gnb``: one pass of per-class segment moments, the variance
  centered in a second pass; padding rows carry ``y = -1`` (a zero
  one-hot row), so no count or sum includes them.
- ``fit_kmeans``: k-means++ seeding on the gathered rows (replicated),
  Lloyd's assignments and center sums per shard (train/kmeans._lloyd);
  N is trimmed to a multiple of the data axis, as in JAX.
- ``fit_forest``: per-level class-count histograms per shard, split
  decisions once (train/forest.build_tree over shards); bootstrap draws
  over the global row count, padding rows weight 0. Counts are
  integer-valued float32, so the forest equals train/forest.fit's on the
  gathered rows, given the same draws, bit for bit.
- ``fit_svc``: the one-vs-one box QPs spread over the STATE axis, each
  shard solving its pairs against the replicated kernel matrix; padding
  pairs are inert all-zero problems.

A mesh may repeat one device (N shards on one CPU or one card), as the
port's sharded serving does. These are the only bodies of the four fits:
train/{gnb,kmeans,forest,svc}.fit run them on ``single_device_mesh``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.forest import ForestModel
from ..models.gnb import GnbModel
from ..models.kmeans import KmeansModel
from ..parallel.mesh import (
    DATA_AXIS,
    STATE_AXIS,
    batch_sharded,
    make_mesh,
    replicated,
    require_one_process,
    shard_sum,
)
from . import forest as forest_train
from . import kmeans as kmeans_train
from . import svc as svc_train


def single_device_mesh(device=None):
    """The 1x1 mesh of ``device`` (default CUDA, see device.py)."""
    return make_mesh(n_data=1, n_state=1, devices=[resolve_device(device)])


def _pad_rows(a: np.ndarray, pad: int, value) -> np.ndarray:
    if not pad:
        return a
    fill = np.full((pad,) + a.shape[1:], value, a.dtype)
    return np.concatenate([a, fill], axis=0)


def fit_gnb(mesh, X, y, n_classes: int, *,
            var_smoothing: float = 1e-9) -> GnbModel:
    """Distributed GaussianNB fit: per-class counts, means and variances
    as one-hot matmuls in float64, the variance in two passes (centering
    first: features reach ~1e8, so E[x²]−E[x]² cancels), plus sklearn's
    smoothing ``var += var_smoothing · max(global per-feature variance)``,
    with N sharded over the data axis. N is padded to a multiple of the
    data axis with ``y = -1`` rows, which every count and sum excludes.
    An empty class has a 0/0 mean, which the model's fold
    (models/gnb.fold) makes absent (prior 0)."""
    require_one_process(mesh, "train/distributed.py (ROADMAP Queue 1 "
                              "item 13)")
    d = mesh.shape[DATA_AXIS]
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.int64)
    pad = (-len(y)) % d
    Xs = batch_sharded(mesh, torch.from_numpy(_pad_rows(X, pad, 0.0)))
    ys = batch_sharded(mesh, torch.from_numpy(_pad_rows(y, pad, -1)))
    dev = Xs[0].device
    onehot = [(ys_[:, None] == torch.arange(n_classes, device=ys_.device))
              .to(torch.float64) for ys_ in ys]
    counts = shard_sum([oh.sum(0) for oh in onehot])
    theta = shard_sum([oh.t() @ x for oh, x in zip(onehot, Xs)]) \
        / counts[:, None]
    # an absent class's 0/0 mean stays out of the centering (its rows do
    # not exist; padding rows gather class 0 under a zero one-hot row)
    safe = torch.nan_to_num(theta)
    sq = []
    for oh, x, ys_ in zip(onehot, Xs, ys):
        centered = x - safe.to(x.device)[ys_.clamp(min=0)]
        sq.append(oh.t() @ (centered * centered))
    var = shard_sum(sq) / counts[:, None]
    total = counts.sum()
    mask = [(ys_ >= 0).to(torch.float64)[:, None] for ys_ in ys]
    # the global mean from the masked rows, not from theta·counts, where
    # an absent class's NaN would poison the smoothing term
    mu_all = shard_sum([(m * x).sum(0) for m, x in zip(mask, Xs)]) / total
    global_var = shard_sum([
        (m * (x - mu_all.to(x.device)) ** 2).sum(0)
        for m, x in zip(mask, Xs)]) / total
    var = var + var_smoothing * global_var.max()
    return GnbModel.from_numpy({
        "theta": theta.cpu().numpy(),
        "var": var.cpu().numpy(),
        "class_prior": (counts / total).cpu().numpy(),
    }, device=dev)


def fit_kmeans(mesh, X, k: int = 4, *, n_init: int = 10, n_iter: int = 50,
               seed: int = 0) -> tuple[KmeansModel, float]:
    """Distributed Lloyd: ``(KmeansModel, inertia)`` of the best of
    ``n_init`` k-means++ + Lloyd runs, the assignments and center sums
    per shard. N is trimmed to a multiple of the data axis (at most
    devices−1 rows: padding cannot be made assignment-neutral). X is a
    numpy array or a tensor. The seeding draws come from a host
    generator seeded by ``seed`` (train/kmeans.py)."""
    require_one_process(mesh, "train/distributed.py (ROADMAP Queue 1 "
                              "item 13)")
    d = mesh.shape[DATA_AXIS]
    if not isinstance(X, torch.Tensor):
        X = torch.from_numpy(np.asarray(X, np.float32))
    dev = mesh.axis_devices(DATA_AXIS)[0]
    X_all = X[: X.shape[0] - X.shape[0] % d].to(dev, torch.float32)
    Xs = batch_sharded(mesh, X_all)
    gen = torch.Generator().manual_seed(seed)
    best = None
    for _ in range(n_init):
        centers0 = kmeans_train._plusplus_init(gen, X_all, k)
        centers, inertia = kmeans_train._lloyd(Xs, centers0, n_iter)
        if best is None or float(inertia) < best[1]:
            best = (centers, float(inertia))
    return KmeansModel(centers=best[0].contiguous()), best[1]


def fit_forest(mesh, X, y, n_classes: int, *, n_trees: int = 100,
               max_depth: int = 10, n_bins: int = 128,
               max_features: int | str = "sqrt", bootstrap: bool = True,
               seed: int = 0):
    """Distributed random-forest fit: rows sharded over the data axis,
    each level's histograms per shard and added in shard order, the
    split decisions once. Bin edges come from all rows (host side); the
    draws of tree t are ``forest.tree_draws`` over the GLOBAL row count
    on a generator of the first shard's device seeded by ``seed``, so
    the result is train/forest.fit's on the gathered rows. Rows are
    padded to a multiple of the data axis with weight-0 rows."""
    require_one_process(mesh, "train/distributed.py (ROADMAP Queue 1 "
                              "item 13)")
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.int64)
    n_real, F = X.shape
    max_features = forest_train.resolve_max_features(max_features, F)
    pad = (-n_real) % mesh.shape[DATA_AXIS]
    edges = forest_train.make_bins(X, n_bins)  # global edges
    Xb = forest_train.bin_features(X, edges).astype(np.int64)
    Xbs = batch_sharded(mesh, torch.from_numpy(_pad_rows(Xb, pad, 0)))
    ys = batch_sharded(mesh, torch.from_numpy(_pad_rows(y, pad, 0)))
    dev = Xbs[0].device
    et = torch.from_numpy(edges).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    trees = []
    for t in range(n_trees):
        weights, scores = forest_train.tree_draws(
            gen, t, n_real, F, max_depth, bootstrap=bootstrap,
            max_features=max_features, device=dev,
        )
        weights = torch.cat([weights, weights.new_zeros(pad)])
        trees.append(forest_train.build_tree(
            Xbs, ys, et, batch_sharded(mesh, weights), scores,
            n_classes=n_classes, max_depth=max_depth, n_bins=n_bins,
            max_features=max_features,
        ))
    left, right, feature, threshold, values = (
        torch.stack(a) for a in zip(*trees))
    return ForestModel(left=left, right=right, feature=feature,
                       threshold=threshold, values=values,
                       max_depth=max_depth)


def fit_svc(mesh, X, y, n_classes: int, *, C: float = 1.0,
            gamma: float | str = "scale", n_iters: int = 800,
            power_iters: int = 24, sv_tol: float = 1e-6):
    """Distributed RBF-SVC fit: the C·(C−1)/2 one-vs-one box QPs spread
    over the STATE axis, each shard solving its pairs (train/svc
    .solve_pairs) against the replicated (N, N) kernel; the α gather back
    in shard order. Pairs are padded to a multiple of the state axis with
    inert all-zero problems (their α clamps to the [0, 0] box)."""
    require_one_process(mesh, "train/distributed.py (ROADMAP Queue 1 "
                              "item 13)")
    devs = mesh.axis_devices(STATE_AXIS)
    prob = svc_train.prepare_ovo(X, y, n_classes, C, gamma, devs[0])
    pad = (-prob["idx"].shape[0]) % len(devs)
    ops = [torch.from_numpy(_pad_rows(prob[k], pad, 0))
           for k in ("idx", "t", "Cbox")]
    per = ops[0].shape[0] // len(devs)
    kernels = replicated(mesh, prob["K"], STATE_AXIS)
    alphas = []
    for s, (dev, K) in enumerate(zip(devs, kernels)):
        idx, t, Cbox = (a[s * per: (s + 1) * per].to(dev) for a in ops)
        alphas.append(svc_train.solve_pairs(
            K, idx, t, Cbox, n_iters=n_iters, power_iters=power_iters,
        ).cpu())
    return svc_train.pack_params(prob, torch.cat(alphas).numpy(), n_classes,
                                 sv_tol, devs[0])
