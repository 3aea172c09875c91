"""Random-forest training by histogram split search — the torch port of
``traffic_classifier_sdn_tpu/train/forest.py``.

The JAX package's method (LightGBM/XGBoost-style quantile histograms,
level-wise growth in a perfect binary layout):

- features are pre-binned on the host into ``n_bins`` quantile bins whose
  edges are data values (``make_bins``, ``bin_features``: numpy copies),
  so ``bin(x) <= b  ⟺  x <= edges[b]`` and the trained tree evaluates
  identically through the unbinned predict path and the forest kernel;
- at depth ``d`` one scatter-add builds the (nodes, features, bins,
  classes) class-count histogram for every node at once, a cumulative sum
  turns it into all left/right split candidates, and the gini surrogate
  ``Σc nL_c²/nL + Σc nR_c²/nR`` is scored for every (node, feature, bin);
  the split is the first maximal candidate (``jnp.argmax``'s tie rule);
- per-node feature subsampling keeps the ``max_features`` highest of
  uniform per-(node, feature) scores; bootstrap resampling becomes
  per-row integer weights.

Here each level is one batched torch program on the given device. Counts
are integer-valued float32, so histograms and cumsums are exact whatever
the accumulation order (the card's scatter-add is atomic), and so are the
gain's sums of squares while a node holds at most 4,096 weighted rows
(``Σc n_c² <= n² <= 2^24``); the gain is then one correctly rounded
division per side and one add, the JAX expression's. Beyond that a sum
of squares rounds, in torch's reduction order.

Randomness: a tree's draws are its bootstrap weights and its per-level
feature scores, made by ``tree_draws`` from one explicit
``torch.Generator``. ``build_tree`` takes them as tensors,
so a test can feed the JAX package's ``jax.random`` draws and compare node
stacks; the port's own draws are not ``jax.random``'s. JAX's
single-device ``train/distributed.fit_forest`` equals its
``train/forest.fit`` on the gathered data bit for bit, so this one fit
stands for both.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.forest import ForestModel


def make_bins(X: np.ndarray, n_bins: int) -> np.ndarray:
    """Per-feature candidate thresholds: (F, n_bins-1) sorted data values.

    Edges are taken from the data (quantile ``method='lower'``) so every
    threshold is exactly representable and the bin/raw comparisons agree.
    """
    X = np.asarray(X, np.float32)
    qs = np.linspace(0.0, 1.0, n_bins - 1)
    edges = np.quantile(X, qs, axis=0, method="lower").T.astype(np.float32)
    return np.sort(edges, axis=1)


def bin_features(X: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Map raw features to bin ids: bin(x) = #{edges < x} ∈ [0, n_bins-1]."""
    X = np.asarray(X, np.float32)
    out = np.empty(X.shape, np.int32)
    for f in range(X.shape[1]):
        out[:, f] = np.searchsorted(edges[f], X[:, f], side="left")
    return out


def resolve_max_features(max_features, n_features: int) -> int:
    """sklearn's ``max_features='sqrt'`` rule."""
    if max_features == "sqrt":
        return max(1, int(np.sqrt(n_features)))
    return int(max_features)


def tree_draws(gen: torch.Generator, tree: int, n_rows: int,
               n_features: int, max_depth: int, *, bootstrap: bool,
               max_features: int, device) -> tuple:
    """One tree's random draws: ``(weights, scores)``, the (N,) float32
    bootstrap multiplicities (ones without bootstrap) and, when features
    are subsampled, one (2^d, F) float32 uniform score matrix per split
    level d (else an empty list). ``tree`` is the tree's index, for a
    replacement that hands out recorded draws."""
    del tree
    if bootstrap:
        picks = torch.randint(0, n_rows, (n_rows,), generator=gen,
                              device=device)
        weights = torch.bincount(picks, minlength=n_rows).to(torch.float32)
    else:
        weights = torch.ones(n_rows, dtype=torch.float32, device=device)
    scores = []
    if max_features < n_features:
        scores = [torch.rand((2 ** d, n_features), generator=gen,
                             device=device)
                  for d in range(max_depth)]
    return weights, scores


def _first_argmax(a: torch.Tensor) -> torch.Tensor:
    """(rows,) index of the first maximum of each row of a 2-D float
    tensor (``jnp.argmax``'s tie rule), the same on every device."""
    m = a.max(dim=1, keepdim=True).values
    idx = torch.arange(a.shape[1], device=a.device).expand_as(a)
    return torch.where(a == m, idx, a.shape[1]).min(dim=1).values


def build_tree(Xb: torch.Tensor, y: torch.Tensor, edges: torch.Tensor,
               weights: torch.Tensor, scores: list, *, n_classes: int,
               max_depth: int, n_bins: int, max_features: int) -> tuple:
    """One tree from binned features ``Xb`` (N, F) int64, labels ``y``
    (N,) int64, candidate thresholds ``edges`` (F, n_bins-1) float32, the
    row ``weights`` and per-level feature ``scores`` (``tree_draws``).
    Returns the perfect-layout node arrays ``(left, right, feature,
    threshold, values)``: (M,) int32, int32, int32, float32 and (M, C)
    float32 class counts, M = 2^(max_depth+1) - 1."""
    N, F = Xb.shape
    E = n_bins - 1  # candidate split count per feature
    M = 2 ** (max_depth + 1) - 1
    dev = Xb.device
    left = torch.full((M,), -1, dtype=torch.int32, device=dev)
    right = torch.full((M,), -1, dtype=torch.int32, device=dev)
    feature = torch.zeros(M, dtype=torch.int32, device=dev)
    threshold = torch.zeros(M, dtype=torch.float32, device=dev)
    values = torch.zeros((M, n_classes), dtype=torch.float32, device=dev)
    pos = torch.zeros(N, dtype=torch.int64, device=dev)  # node in its level
    wa = weights  # per-row weight, zeroed once its node is a leaf
    fi = torch.arange(F, device=dev)
    for d in range(max_depth + 1):
        n_nodes = 2 ** d
        off = n_nodes - 1  # global offset of this level
        cnt = torch.zeros((n_nodes, n_classes), dtype=torch.float32,
                          device=dev)
        cnt.index_put_((pos, y), wa, accumulate=True)
        n_node = cnt.sum(1)
        values[off:off + n_nodes] = cnt
        if d == max_depth:
            break  # deepest level: all leaves
        H = torch.zeros((n_nodes, F, n_bins, n_classes), dtype=torch.float32,
                        device=dev)
        H.index_put_((pos[:, None].expand(N, F), fi[None, :].expand(N, F),
                      Xb, y[:, None].expand(N, F)),
                     wa[:, None].expand(N, F), accumulate=True)
        # every left/right candidate at once: L[n, f, b, c] counts bin <= b
        L = torch.cumsum(H, dim=2)[:, :, :E, :]
        nL = L.sum(-1)
        R = cnt[:, None, None, :] - L
        nR = n_node[:, None, None] - nL
        score = ((L * L).sum(-1) / torch.clamp(nL, min=1.0)
                 + (R * R).sum(-1) / torch.clamp(nR, min=1.0))
        score = torch.where((nL > 0) & (nR > 0), score, -torch.inf)
        if max_features < F:
            u = scores[d]
            kth = torch.topk(u, max_features, dim=1).values[:, -1]
            score = torch.where((u >= kth[:, None])[:, :, None], score,
                                -torch.inf)
        flat = score.reshape(n_nodes, F * E)
        best = _first_argmax(flat)
        best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
        f_star = best // E
        b_star = best % E
        # a positive impurity decrease beats the parent's Σc cnt²/n; pure
        # or < 2-row nodes become leaves
        parent_score = (cnt * cnt).sum(1) / torch.clamp(n_node, min=1.0)
        is_split = ((best_gain > parent_score + 1e-3) & (n_node >= 2.0)
                    & (cnt.max(1).values < n_node))
        kid = torch.arange(n_nodes, dtype=torch.int32, device=dev)
        child = 2 * n_nodes - 1 + 2 * kid
        left[off:off + n_nodes] = torch.where(is_split, child, -1)
        right[off:off + n_nodes] = torch.where(is_split, child + 1, -1)
        feature[off:off + n_nodes] = torch.where(
            is_split, f_star, 0).to(torch.int32)
        threshold[off:off + n_nodes] = torch.where(
            is_split, edges[f_star, b_star], 0.0)
        # route rows one level down; rows in leaf nodes go inert
        go_left = torch.gather(Xb, 1, f_star[pos][:, None])[:, 0] <= b_star[pos]
        wa = torch.where(is_split[pos], wa, 0.0)
        pos = 2 * pos + torch.where(go_left, 0, 1)
    return left, right, feature, threshold, values


def fit(X, y, n_classes: int, *, n_trees: int = 100, max_depth: int = 10,
        n_bins: int = 128, max_features: int | str = "sqrt",
        bootstrap: bool = True, seed: int = 0, device=None) -> ForestModel:
    """Fit a random forest on ``device`` (default CUDA, see device.py);
    returns a ``ForestModel`` of perfect-layout node stacks. The draws of
    tree t come from ``tree_draws`` on a generator seeded by ``seed``."""
    device = resolve_device(device)
    X = np.asarray(X, np.float32)
    y_np = np.asarray(y, np.int32)
    F = X.shape[1]
    max_features = resolve_max_features(max_features, F)
    edges = make_bins(X, n_bins)
    Xb = torch.from_numpy(bin_features(X, edges)).to(device, torch.int64)
    yt = torch.from_numpy(y_np).to(device, torch.int64)
    et = torch.from_numpy(edges).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    trees = []
    for t in range(n_trees):
        weights, scores = tree_draws(
            gen, t, X.shape[0], F, max_depth, bootstrap=bootstrap,
            max_features=max_features, device=device,
        )
        trees.append(build_tree(
            Xb, yt, et, weights, scores, n_classes=n_classes,
            max_depth=max_depth, n_bins=n_bins, max_features=max_features,
        ))
    left, right, feature, threshold, values = (
        torch.stack(a) for a in zip(*trees))
    # thresholds stay the float32 bin edges: no float64 round trip
    return ForestModel(left=left, right=right, feature=feature,
                       threshold=threshold, values=values,
                       max_depth=max_depth)
