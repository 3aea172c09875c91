"""GEMM-form decision-forest evaluation — the torch port of
``traffic_classifier_sdn_tpu/ops/tree_gemm.py`` (v1 form).

The numpy operand builder (``_reachable_nodes``, ``build_gemm_operands``,
``_tree_sizes``, ``split_tree_buckets``) is a verbatim copy, so the leaf
values (``v / tot / divisor``) and f32-safe thresholds are bitwise those
of the JAX package. The ensemble is three matrix products with exact
semantics:

  1. node comparisons:  cmp = (X @ A ≤ B)           A: one-hot feature
     selector (F, T·D) — column selection via an f32 matmul is exact
     (TF32 off, see device.py); pm = 2·cmp−1 ∈ {−1,+1}
  2. path aggregation:  S = pm @ P, P (T, D, L) holds +1/−1/0 for
     left/right/absent ancestor edges; a leaf is reached iff
     S[l] == depth[l]. All values are small integers, exact in f32.
  3. distribution select: per_tree = match @ V — one exact leaf row per
     tree — then ``acc += per_tree[t]`` **sequentially in tree order**.

The sequential tree-order sum is what makes this the plain version of the
CUDA forest kernel (ops/forest_kernel.py): the kernel adds the same leaf
rows in the same order, so the two agree bit for bit. Against JAX (whose
tree sum is an XLA reduction in its own order) the probabilities agree to
f32 reassociation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device


def _reachable_nodes(left, right, t: int) -> list[int]:
    """Nodes reachable from tree t's root (skips the importer's padding,
    which has ``left == -1`` and is unreachable): BFS from node 0."""
    reach = [0]
    seen = {0}
    for n in reach:
        if left[t, n] != -1:
            for ch in (int(left[t, n]), int(right[t, n])):
                if ch not in seen:
                    seen.add(ch)
                    reach.append(ch)
    return reach


def build_gemm_operands(d: dict, n_features: int | None = None,
                        n_trees_total: int | None = None) -> dict:
    """Extract per-tree GEMM operands (numpy) from importer node arrays
    (io/sklearn_import.import_forest format). Shared by the torch GEMM
    path below and the CUDA forest kernel (ops/forest_kernel.py).

    ``n_features`` must match the width of the X the forest will see; it
    defaults to the importer dict's value, else the widest feature id used
    by any split. ``n_trees_total`` sets the ensemble-mean divisor when
    ``d`` holds only a subset of the forest (size-bucketed compilation):
    per-leaf values are divided by the FULL tree count so group
    contributions sum to the ensemble mean."""
    left, right = d["left"], d["right"]
    feature, threshold, values = d["feature"], d["threshold"], d["values"]
    n_trees, M = left.shape
    n_classes = values.shape[2]
    if n_features is None:
        n_features = int(d.get("n_features", int(np.max(feature)) + 1))

    per_tree = []
    D_max = L_max = 0
    for t in range(n_trees):
        # node_count = nodes before padding (padding has left == -1 and zero
        # values; real leaves also have left == -1 but nonzero values)
        internal = []
        leaves = []
        # reconstruct parents to walk ancestor paths
        parent = {}
        for n in range(M):
            if left[t, n] != -1:
                parent[int(left[t, n])] = (n, +1)
                parent[int(right[t, n])] = (n, -1)
        reach = _reachable_nodes(left, right, t)
        node_slot = {}
        for n in reach:
            if left[t, n] != -1:
                node_slot[n] = len(internal)
                internal.append(n)
            else:
                leaves.append(n)
        # ancestor paths per leaf
        paths = []
        for leaf in leaves:
            edges = []
            n = leaf
            while n in parent:
                p, sign = parent[n]
                edges.append((node_slot[p], sign))
                n = p
            paths.append(edges)
        per_tree.append((internal, leaves, paths))
        D_max = max(D_max, max(len(internal), 1))
        L_max = max(L_max, len(leaves))

    TD = n_trees * D_max
    feat_onehot = np.zeros((n_features, TD), np.float32)
    thresholds = np.full(TD, np.inf, np.float64)
    path = np.zeros((n_trees, D_max, L_max), np.float32)
    leaf_depth = np.full((n_trees, L_max), 127.0, np.float32)
    leaf_values = np.zeros((n_trees, L_max, n_classes), np.float32)

    from ..io.sklearn_import import f32_safe_thresholds

    divisor = n_trees_total if n_trees_total is not None else n_trees
    for t, (internal, leaves, paths) in enumerate(per_tree):
        for s, n in enumerate(internal):
            col = t * D_max + s
            feat_onehot[feature[t, n], col] = 1.0
            thresholds[col] = threshold[t, n]
        for s, (leaf, edges) in enumerate(zip(leaves, paths)):
            leaf_depth[t, s] = len(edges)
            v = values[t, leaf]
            tot = v.sum()
            if tot > 0:
                leaf_values[t, s] = v / tot / divisor
            for node_s, sign in edges:
                path[t, node_s, s] = sign

    # f32 round-down keeps every decision identical to sklearn's
    # f32-feature vs f64-threshold comparison (io/sklearn_import).
    finite = np.isfinite(thresholds)
    thr32 = np.full(TD, np.inf, np.float32)
    thr32[finite] = f32_safe_thresholds(thresholds[finite])
    thresholds = thr32

    return {
        "feat_onehot": feat_onehot,  # (F, T*D)
        "thresholds": thresholds,  # (T*D,)
        "path": path,  # (T, D, L)
        "leaf_depth": leaf_depth,  # (T, L)
        "leaf_values": leaf_values,  # (T, L, C), pre-divided by T
        "n_trees": n_trees,
        "n_internal": D_max,
        "n_leaves": L_max,
        "n_classes": n_classes,
        "n_features": n_features,
    }


def _tree_sizes(d: dict) -> np.ndarray:
    """Per-tree (internal·leaf) size product — the stage-2 FLOP weight."""
    left, right = d["left"], d["right"]
    sizes = []
    for t in range(left.shape[0]):
        reach = _reachable_nodes(left, right, t)
        D = sum(1 for n in reach if left[t, n] != -1)
        sizes.append(D * (len(reach) - D))
    return np.asarray(sizes)


def split_tree_buckets(
    d: dict, n_buckets: int, n_features: int | None = None
) -> list[tuple[dict, int, int]]:
    """Partition an importer forest dict into size buckets for independent
    compilation: trees sorted by their D·L stage-2 FLOP weight, split into
    ``n_buckets`` equal-count groups. Returns
    ``[(sub_dict, n_features, n_trees_total), ...]`` — feature width is
    resolved ONCE over the whole forest, and the total tree count is the
    ensemble-mean divisor every bucket must share."""
    n_trees = d["left"].shape[0]
    n_buckets = max(1, min(n_buckets, n_trees))
    if n_features is None:
        n_features = int(
            d.get("n_features", int(np.max(d["feature"])) + 1)
        )
    if n_buckets == 1:
        return [(d, n_features, n_trees)]
    order = np.argsort(_tree_sizes(d), kind="stable")
    tree_keys = ("left", "right", "feature", "threshold", "values")
    out = []
    for part in np.array_split(order, n_buckets):
        if part.size == 0:
            continue
        sub = dict(d)
        for k in tree_keys:
            sub[k] = d[k][part]
        out.append((sub, n_features, n_trees))
    return out


@dataclass
class ForestGemm:
    feat_onehot: torch.Tensor  # (F, T*D) f32 one-hot feature selector
    thresholds: torch.Tensor  # (T*D,) f32 (+inf at padded node slots)
    path: torch.Tensor  # (T, D, L) f32 per-tree ±1/0 ancestor-edge matrices
    leaf_depth: torch.Tensor  # (T, L) f32 (127 at padded leaf slots)
    leaf_values: torch.Tensor  # (T, L, C) f32 normalized distributions / T
    n_classes: int
    row_chunk: int


def gemm_group(ops: dict, row_chunk: int, device) -> ForestGemm:
    """Device tensors of one ``build_gemm_operands`` group, all f32."""
    def t(name):
        return torch.as_tensor(ops[name], dtype=torch.float32, device=device)

    return ForestGemm(
        feat_onehot=t("feat_onehot"), thresholds=t("thresholds"),
        path=t("path"), leaf_depth=t("leaf_depth"),
        leaf_values=t("leaf_values"),
        n_classes=ops["n_classes"], row_chunk=row_chunk,
    )


def compile_forest(
    d: dict, row_chunk: int = 32768, n_features: int | None = None,
    n_buckets: int = 1, device=None,
) -> list[ForestGemm]:
    """GEMM groups from importer node arrays, on ``device`` (default
    CUDA). ``n_buckets > 1`` splits the trees into size buckets (as the
    JAX default serving form does); the default single group keeps the
    trees in their original order."""
    device = resolve_device(device)
    return [
        gemm_group(
            build_gemm_operands(sub, n_features=nf, n_trees_total=nt),
            row_chunk, device,
        )
        for sub, nf, nt in split_tree_buckets(d, n_buckets, n_features)
    ]


def _proba_chunk(g: ForestGemm, X: torch.Tensor) -> torch.Tensor:
    T, D, L = g.path.shape
    # 1. all node comparisons at once (exact column selection by matmul)
    xf = X @ g.feat_onehot  # (n, T*D)
    one = torch.ones((), dtype=torch.float32, device=X.device)
    pm = torch.where(xf <= g.thresholds, one, -one)
    pm = pm.reshape(-1, T, D).transpose(0, 1)  # (T, n, D)
    # 2. per-tree path aggregation — ±1 sums of ints ≤ depth, exact in f32
    S = torch.bmm(pm, g.path)  # (T, n, L)
    match = (S == g.leaf_depth[:, None, :]).to(torch.float32)
    # 3. one selected leaf distribution per tree, summed in tree order
    per_tree = torch.bmm(match, g.leaf_values)  # (T, n, C)
    acc = torch.zeros(
        (X.shape[0], g.n_classes), dtype=torch.float32, device=X.device
    )
    for t in range(T):
        acc += per_tree[t]
    return acc


def forest_proba_gemm(groups: list[ForestGemm], X: torch.Tensor) -> torch.Tensor:
    """(N, C) ensemble-mean class distributions, row-chunked; groups are
    summed in order."""
    out = None
    for g in groups:
        part = torch.cat([
            _proba_chunk(g, X[i: i + g.row_chunk])
            for i in range(0, X.shape[0], g.row_chunk)
        ]) if X.shape[0] else X.new_zeros((0, g.n_classes))
        out = part if out is None else out + part
    return out
