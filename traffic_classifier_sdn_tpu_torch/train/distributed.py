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

On a mesh spanning processes (``parallel.mesh.init_distributed``) every
rank passes the whole (X, y), as JAX's processes do, and keeps only its
own row or pair shards on its device; each ``shard_sum`` adds across the
ranks in shard order, so every rank returns the one-process mesh's
model bit for bit. The k-means++ draws come from the seeded host
generator on the full rows, the same on every rank. The forest's draws
are made by the rank owning data shard 0 alone and broadcast
(``mesh.broadcast``): a CUDA generator's stream depends on the card it
runs on, so each rank seeding its own would not promise the same draws.
The SVC's α blocks come back through ``mesh.exchange`` in shard order.
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
    broadcast,
    exchange,
    make_mesh,
    replicated,
    shard_sum,
)
from . import forest as forest_train
from . import kmeans as kmeans_train
from . import svc as svc_train


def single_device_mesh(device=None):
    """The 1x1 mesh of ``device`` (default CUDA, see device.py)."""
    return make_mesh(n_data=1, n_state=1, devices=[resolve_device(device)])


def _first_device(mesh, axis: str) -> torch.device:
    """This process's first shard's device along ``axis``: where its
    sums land and its model is placed."""
    return mesh.axis_devices(axis)[mesh.local_shards(axis)[0]]


def _owned(fn, *shards) -> list:
    """``fn`` over the entries of one or more per-shard lists, None where
    the first list has None (another rank's shard)."""
    return [None if a[0] is None else fn(*a) for a in zip(*shards)]


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
    d = mesh.shape[DATA_AXIS]
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.int64)
    pad = (-len(y)) % d
    Xs = batch_sharded(mesh, torch.from_numpy(_pad_rows(X, pad, 0.0)))
    ys = batch_sharded(mesh, torch.from_numpy(_pad_rows(y, pad, -1)))
    dev = _first_device(mesh, DATA_AXIS)
    onehot = _owned(lambda ys_: (ys_[:, None] == torch.arange(
        n_classes, device=ys_.device)).to(torch.float64), ys)
    counts = shard_sum(_owned(lambda oh: oh.sum(0), onehot), mesh)
    theta = shard_sum(_owned(lambda oh, x: oh.t() @ x, onehot, Xs),
                      mesh) / counts[:, None]
    # an absent class's 0/0 mean stays out of the centering (its rows do
    # not exist; padding rows gather class 0 under a zero one-hot row)
    safe = torch.nan_to_num(theta)

    def centered_sq(oh, x, ys_):
        centered = x - safe.to(x.device)[ys_.clamp(min=0)]
        return oh.t() @ (centered * centered)

    var = shard_sum(_owned(centered_sq, onehot, Xs, ys),
                    mesh) / counts[:, None]
    total = counts.sum()
    mask = _owned(lambda ys_: (ys_ >= 0).to(torch.float64)[:, None], ys)
    # the global mean from the masked rows, not from theta·counts, where
    # an absent class's NaN would poison the smoothing term
    mu_all = shard_sum(_owned(lambda m, x: (m * x).sum(0), mask, Xs),
                       mesh) / total
    global_var = shard_sum(_owned(
        lambda m, x: (m * (x - mu_all.to(x.device)) ** 2).sum(0),
        mask, Xs), mesh) / total
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
    generator seeded by ``seed`` (train/kmeans.py), on the full rows."""
    d = mesh.shape[DATA_AXIS]
    if not isinstance(X, torch.Tensor):
        X = torch.from_numpy(np.asarray(X, np.float32))
    dev = _first_device(mesh, DATA_AXIS)
    X_all = X[: X.shape[0] - X.shape[0] % d].to(dev, torch.float32)
    Xs = batch_sharded(mesh, X_all)
    gen = torch.Generator().manual_seed(seed)
    best = None
    for _ in range(n_init):
        centers0 = kmeans_train._plusplus_init(gen, X_all, k)
        centers, inertia = kmeans_train._lloyd(Xs, centers0, n_iter, mesh)
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
    the result is train/forest.fit's on the gathered rows. On a mesh
    spanning processes the rank owning data shard 0 draws and broadcasts
    each tree's draws (the others make none). Rows are padded to a
    multiple of the data axis with weight-0 rows."""
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.int64)
    n_real, F = X.shape
    max_features = forest_train.resolve_max_features(max_features, F)
    pad = (-n_real) % mesh.shape[DATA_AXIS]
    edges = forest_train.make_bins(X, n_bins)  # global edges
    Xb = forest_train.bin_features(X, edges).astype(np.int64)
    Xbs = batch_sharded(mesh, torch.from_numpy(_pad_rows(Xb, pad, 0)))
    ys = batch_sharded(mesh, torch.from_numpy(_pad_rows(y, pad, 0)))
    dev = _first_device(mesh, DATA_AXIS)
    et = torch.from_numpy(edges).to(dev)
    drawer = 0 in mesh.local_shards(DATA_AXIS)
    gen = torch.Generator(device=dev).manual_seed(seed) if drawer else None
    trees = []
    for t in range(n_trees):
        weights, scores = _tree_draws(
            mesh, gen, t, n_real, F, max_depth, bootstrap, max_features,
            dev)
        weights = torch.cat([weights, weights.new_zeros(pad)])
        trees.append(forest_train.build_tree(
            Xbs, ys, et, batch_sharded(mesh, weights), scores,
            n_classes=n_classes, max_depth=max_depth, n_bins=n_bins,
            max_features=max_features, mesh=mesh,
        ))
    left, right, feature, threshold, values = (
        torch.stack(a) for a in zip(*trees))
    return ForestModel(left=left, right=right, feature=feature,
                       threshold=threshold, values=values,
                       max_depth=max_depth)


def _tree_draws(mesh, gen, tree: int, n_rows: int, n_features: int,
                max_depth: int, bootstrap: bool, max_features: int, dev):
    """Tree ``tree``'s ``forest.tree_draws`` on ``dev``: drawn from
    ``gen`` here, or on a mesh spanning processes by the rank owning data
    shard 0 (``gen`` is None elsewhere) and broadcast to the others."""
    draws = None
    if gen is not None:
        draws = forest_train.tree_draws(
            gen, tree, n_rows, n_features, max_depth, bootstrap=bootstrap,
            max_features=max_features, device=dev)
    if not mesh.spans_processes:
        return draws
    host = None if draws is None else tuple(
        a.cpu().numpy() for a in (draws[0], *draws[1]))
    weights, *scores = (torch.from_numpy(a).to(dev)
                        for a in broadcast(mesh, DATA_AXIS, host))
    return weights, scores


def fit_svc(mesh, X, y, n_classes: int, *, C: float = 1.0,
            gamma: float | str = "scale", n_iters: int = 800,
            power_iters: int = 24, sv_tol: float = 1e-6):
    """Distributed RBF-SVC fit: the C·(C−1)/2 one-vs-one box QPs spread
    over the STATE axis, each shard solving its pairs (train/svc
    .solve_pairs) against the replicated (N, N) kernel; the α gather back
    in shard order (``mesh.exchange``: across the ranks of a spanning
    mesh, each solving its own pair shards). Pairs are padded to a
    multiple of the state axis with inert all-zero problems (their α
    clamps to the [0, 0] box)."""
    devs = mesh.axis_devices(STATE_AXIS)
    dev = _first_device(mesh, STATE_AXIS)
    prob = svc_train.prepare_ovo(X, y, n_classes, C, gamma, dev)
    pad = (-prob["idx"].shape[0]) % len(devs)
    ops = [torch.from_numpy(_pad_rows(prob[k], pad, 0))
           for k in ("idx", "t", "Cbox")]
    per = ops[0].shape[0] // len(devs)
    kernels = replicated(mesh, prob["K"], STATE_AXIS)
    alphas: list = [None] * len(devs)
    for s, (d, K) in enumerate(zip(devs, kernels)):
        if K is None:
            continue
        idx, t, Cbox = (a[s * per: (s + 1) * per].to(d) for a in ops)
        alphas[s] = (svc_train.solve_pairs(
            K, idx, t, Cbox, n_iters=n_iters, power_iters=power_iters,
        ).cpu().numpy(),)
    alphas = exchange(mesh, STATE_AXIS, alphas)
    return svc_train.pack_params(
        prob, np.concatenate([a[0] for a in alphas]), n_classes, sv_tol,
        dev)
