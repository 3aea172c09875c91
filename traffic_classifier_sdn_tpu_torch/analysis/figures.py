"""C13 analysis figures — the visual half of the reference's analysis
notebook; the torch port of ``traffic_classifier_sdn_tpu/analysis/
figures.py``.

Reproduces the four figure families of ``models/notebooks.zip!notebooks/
1_log_Kmeans.ipynb`` cells 70-129:

- cell 85: PCA-2 scatter of the scaled features, colored by traffic type;
- cell 98: logistic-regression decision boundaries in PCA-2 space
  (contourf over a meshgrid + the class scatter);
- cell 112: per-class cluster-center strips (each KMeans center as a
  1×12 heatmap);
- cell 126: side-by-side PCA-2 scatters of learned cluster ids vs true
  labels (the notebook's KMeans-on-raw-PCA comparison, cells 122-126).

The numbers come from the port's own modules (analysis.preprocess,
train.logreg, train.kmeans, analysis.eval) on the given device, in
float64 up to the float32 model predicts. The PCA-space logistic
regression runs L-BFGS to convergence (``PCA_LOGREG_MAX_ITER``): at the
notebook's 8,898 rows 200 iterations stop short of the optimum, where
the JAX package's optax L-BFGS and torch's (and torch's on the card and
on the CPU) stop at different points with different accuracies, while
the converged fit is one optimum (JAX's 200 iterations reach its
accuracy there; on smaller data they converge). matplotlib only draws, and is
imported inside the drawing functions: ``save_all(ds, None)`` computes
the numbers where matplotlib is not installed.
"""

from __future__ import annotations

import os

import numpy as np

# torch's L-BFGS stops on its own tolerances first (~390 iterations at
# 8,898 rows)
PCA_LOGREG_MAX_ITER = 1000


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _scatter_by_class(plt, ax, Z, y, classes):
    cmap = plt.get_cmap("tab10")
    for i, name in enumerate(classes):
        m = y == i
        ax.scatter(Z[m, 0], Z[m, 1], s=8, alpha=0.6,
                   color=cmap(i % 10), label=str(name))


def fig_pca_scatter(Z, y, classes, path: str) -> None:
    """Cell 85: PCA-2 embedding colored by true traffic type."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 6))
    _scatter_by_class(plt, ax, Z, y, classes)
    ax.set_xlabel("First Principal Component", fontsize=15)
    ax.set_ylabel("Second Principal Component", fontsize=15)
    ax.legend(fontsize=12)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def fig_decision_boundary(Z, y, classes, predict_grid, path: str,
                          spacing: float = 0.05) -> None:
    """Cell 98: contourf of a classifier's prediction over a PCA-2
    meshgrid, overlaid with the class scatter. ``predict_grid`` maps an
    (M, 2) float32 array of PCA coordinates to int class ids."""
    plt = _pyplot()
    x_min, x_max = Z[:, 0].min() - 1, Z[:, 0].max() + 1
    y_min, y_max = Z[:, 1].min() - 1, Z[:, 1].max() + 1
    xx, yy = np.meshgrid(
        np.arange(x_min, x_max, spacing), np.arange(y_min, y_max, spacing)
    )
    grid = np.stack([xx.ravel(), yy.ravel()], axis=1).astype(np.float32)
    zz = np.asarray(predict_grid(grid)).reshape(xx.shape)
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.contourf(xx, yy, zz, cmap=plt.cm.Spectral, alpha=0.8,
                levels=np.arange(len(classes) + 1) - 0.5)
    _scatter_by_class(plt, ax, Z, y, classes)
    ax.set_title("Decision Boundaries", fontsize=15)
    ax.set_xlabel("First Principal Component", fontsize=15)
    ax.set_ylabel("Second Principal Component", fontsize=15)
    ax.set_xlim(x_min, x_max)
    ax.set_ylim(y_min, y_max)
    ax.legend(fontsize=12)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def fig_cluster_centers(centers, names, path: str) -> None:
    """Cell 112: each cluster center as a 1×F binary-cmap strip."""
    plt = _pyplot()
    k = centers.shape[0]
    ncols = 2
    nrows = (k + ncols - 1) // ncols
    fig = plt.figure(figsize=(8, 1.6 * nrows))
    for i in range(k):
        ax = fig.add_subplot(nrows, ncols, 1 + i, xticks=[], yticks=[])
        ax.set_title(str(names[i]))
        ax.imshow(centers[i].reshape(1, -1), cmap=plt.cm.binary,
                  aspect="auto")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def fig_cluster_scatter(Z, clusters, y, path: str) -> None:
    """Cell 126: learned cluster ids vs true labels, side by side."""
    plt = _pyplot()
    k = int(max(clusters.max(), y.max())) + 1
    kwargs = dict(cmap=plt.get_cmap("rainbow", k), edgecolor="none",
                  alpha=0.6, s=8)
    fig, ax = plt.subplots(1, 2, figsize=(9, 4))
    ax[0].scatter(Z[:, 0], Z[:, 1], c=clusters, **kwargs)
    ax[0].set_title("learned cluster labels")
    ax[1].scatter(Z[:, 0], Z[:, 1], c=y, **kwargs)
    ax[1].set_title("true labels")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def save_all(ds, out_dir: str | None, seed: int = 101,
             device=None) -> dict:
    """The C13 analysis of a FlowDataset on ``device`` (default CUDA, see
    device.py): the headline numbers (PCA-2 explained variance,
    PCA-space logreg accuracy, cluster accuracy) and, unless ``out_dir``
    is None, every figure rendered into ``out_dir`` ({figure_name: path}
    under ``paths``)."""
    import torch

    from ..device import resolve_device
    from ..train import kmeans as kmeans_train
    from ..train import logreg as logreg_train
    from . import eval as ev
    from .preprocess import PCA, StandardScaler

    device = resolve_device(device)
    draw = out_dir is not None
    if draw:
        os.makedirs(out_dir, exist_ok=True)
    X = torch.tensor(np.asarray(ds.X, np.float64), device=device)
    y = np.asarray(ds.y)
    k = len(ds.classes)
    paths = {}

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    # scaled PCA-2 embedding (cells 70-85)
    sp = StandardScaler.fit(X)
    Xs = StandardScaler.transform(sp, X)
    pp = PCA.fit(Xs, 2)
    Z = PCA.transform(pp, Xs).cpu().numpy()
    evr = float(pp.explained_variance_ratio.sum())
    if draw:
        paths["pca_scatter"] = os.path.join(out_dir, "pca_scatter.png")
        fig_pca_scatter(Z, y, ds.classes, paths["pca_scatter"])

    # logreg decision boundary in PCA space (cells 89-98); split on the
    # embedded coordinates directly (70/30, notebook cell 91)
    rng = np.random.RandomState(seed)
    perm = rng.permutation(len(Z))
    n_te = int(round(len(Z) * 0.3))
    te_idx, tr_idx = perm[:n_te], perm[n_te:]
    lp = logreg_train.fit(Z[tr_idx], y[tr_idx], k,
                          max_iter=PCA_LOGREG_MAX_ITER, device=device)
    pred = lp.predict(f32(Z[te_idx])).cpu().numpy()
    pca_logreg_acc = float(np.mean(pred == y[te_idx]))
    if draw:
        paths["decision_boundary"] = os.path.join(
            out_dir, "decision_boundary.png")
        fig_decision_boundary(
            Z, y, ds.classes, lambda G: lp.predict(f32(G)).cpu().numpy(),
            paths["decision_boundary"],
        )

    # KMeans on scaled features: center strips (cells 104-112)
    if draw:
        kp, _ = kmeans_train.fit(Xs.cpu().numpy(), k=k, seed=0,
                                 device=device)
        paths["cluster_centers"] = os.path.join(out_dir,
                                                "cluster_centers.png")
        fig_cluster_centers(
            kp.centers.cpu().numpy(), [f"cluster {i}" for i in range(k)],
            paths["cluster_centers"],
        )

    # KMeans on raw-PCA coordinates: side-by-side scatter (cells 122-126)
    pr = PCA.fit(X, 2)
    Zr = PCA.transform(pr, X).cpu().numpy()
    kp2, _ = kmeans_train.fit(Zr, k=k, seed=0, device=device)
    clusters = kp2.predict(f32(Zr))
    cluster_acc = float(ev.clustering_accuracy(
        clusters, torch.tensor(y, device=device), k, len(ds.classes)))
    if draw:
        paths["cluster_scatter"] = os.path.join(out_dir,
                                                "cluster_scatter.png")
        fig_cluster_scatter(Zr, clusters.cpu().numpy(), y,
                            paths["cluster_scatter"])

    return {
        "paths": paths,
        "pca2_explained_variance": evr,
        "pca_logreg_accuracy": pca_logreg_acc,
        "cluster_accuracy": cluster_acc,
    }
