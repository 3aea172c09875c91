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
stacks; the port's own draws are not ``jax.random``'s.
train/distributed.fit_forest drives the builder over row shards; ``fit`` is
it on a one-device mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.forest import ForestModel
from ..parallel.mesh import shard_sum


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


def build_tree(Xb, y, edges: torch.Tensor, weights, scores: list, *,
               n_classes: int, max_depth: int, n_bins: int,
               max_features: int, mesh=None) -> tuple:
    """One tree from binned features ``Xb`` (N, F) int64, labels ``y``
    (N,) int64, candidate thresholds ``edges`` (F, n_bins-1) float32, the
    row ``weights`` and per-level feature ``scores`` (``tree_draws``).
    Returns the perfect-layout node arrays ``(left, right, feature,
    threshold, values)``: (M,) int32, int32, int32, float32 and (M, C)
    float32 class counts, M = 2^(max_depth+1) - 1, on ``edges``' device.

    ``Xb``, ``y`` and ``weights`` may instead be lists of row shards
    (train/distributed.fit_forest): each level's class-count histograms
    are then built per shard and added in shard order
    (``parallel.mesh.shard_sum``), the split decisions made once on
    ``edges``' device, and each shard's rows routed on its own device.
    The counts are integer-valued, so the tree equals the one of the
    gathered rows bit for bit. On a ``mesh`` spanning processes the
    lists hold None in another rank's shards and the histograms add
    across the ranks (``shard_sum`` over the data axis)."""
    if isinstance(Xb, torch.Tensor):
        Xb, y, weights = [Xb], [y], [weights]
    F = next(x for x in Xb if x is not None).shape[1]
    E = n_bins - 1  # candidate split count per feature
    M = 2 ** (max_depth + 1) - 1
    dev = edges.device
    left = torch.full((M,), -1, dtype=torch.int32, device=dev)
    right = torch.full((M,), -1, dtype=torch.int32, device=dev)
    feature = torch.zeros(M, dtype=torch.int32, device=dev)
    threshold = torch.zeros(M, dtype=torch.float32, device=dev)
    values = torch.zeros((M, n_classes), dtype=torch.float32, device=dev)
    # node in its level, per row of each shard
    pos = [None if x is None
           else torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
           for x in Xb]
    wa = list(weights)  # per-row weight, zeroed once its node is a leaf
    for d in range(max_depth + 1):
        n_nodes = 2 ** d
        off = n_nodes - 1  # global offset of this level
        cnts: list = [None] * len(Xb)
        hists: list = [None] * len(Xb)
        for s, (xs, ys, ps, ws) in enumerate(zip(Xb, y, pos, wa)):
            if xs is None:
                continue
            c = torch.zeros((n_nodes, n_classes), dtype=torch.float32,
                            device=xs.device)
            c.index_put_((ps, ys), ws, accumulate=True)
            cnts[s] = c
            if d == max_depth:
                continue
            N = xs.shape[0]
            fi = torch.arange(F, device=xs.device)
            H = torch.zeros((n_nodes, F, n_bins, n_classes),
                            dtype=torch.float32, device=xs.device)
            H.index_put_((ps[:, None].expand(N, F),
                          fi[None, :].expand(N, F), xs,
                          ys[:, None].expand(N, F)),
                         ws[:, None].expand(N, F), accumulate=True)
            hists[s] = H
        cnt = shard_sum(cnts, mesh).to(dev)
        n_node = cnt.sum(1)
        values[off:off + n_nodes] = cnt
        if d == max_depth:
            break  # deepest level: all leaves
        # every left/right candidate at once: L[n, f, b, c] counts bin <= b
        L = torch.cumsum(shard_sum(hists, mesh).to(dev), dim=2)[:, :, :E, :]
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
        for s, xs in enumerate(Xb):
            if xs is None:
                continue
            fs, bs, sp = (a.to(xs.device) for a in (f_star, b_star, is_split))
            p = pos[s]
            go_left = torch.gather(xs, 1, fs[p][:, None])[:, 0] <= bs[p]
            wa[s] = torch.where(sp[p], wa[s], 0.0)
            pos[s] = 2 * p + torch.where(go_left, 0, 1)
    return left, right, feature, threshold, values


def fit(X, y, n_classes: int, *, n_trees: int = 100, max_depth: int = 10,
        n_bins: int = 128, max_features: int | str = "sqrt",
        bootstrap: bool = True, seed: int = 0, device=None) -> ForestModel:
    """Fit a random forest on ``device`` (default CUDA, see device.py):
    train/distributed.fit_forest on a one-device mesh. Returns a
    ``ForestModel`` of perfect-layout node stacks; the draws of tree t
    come from ``tree_draws`` on a generator seeded by ``seed``."""
    from . import distributed

    return distributed.fit_forest(
        distributed.single_device_mesh(device), X, y, n_classes,
        n_trees=n_trees, max_depth=max_depth, n_bins=n_bins,
        max_features=max_features, bootstrap=bootstrap, seed=seed,
    )
