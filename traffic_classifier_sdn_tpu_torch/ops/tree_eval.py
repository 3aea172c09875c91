"""Tensorized decision-tree ensemble evaluation by lockstep gathers — the
torch port of ``traffic_classifier_sdn_tpu/ops/tree_eval.py`` and the
semantic reference the tests hold the other forest forms against.

All (sample, tree) pairs walk their tree in ``max_depth`` rounds of
vectorized gathers over dense (T, M) node stacks. Leaves are encoded
sklearn-style: ``left == right == -1``; a walker that reaches a leaf
self-loops, so running the full ``max_depth`` rounds is harmless.
"""

from __future__ import annotations

import torch


def traverse_gather(
    left: torch.Tensor,  # (T, M) int
    right: torch.Tensor,  # (T, M) int
    feature: torch.Tensor,  # (T, M) int (leaves/padding: 0)
    threshold: torch.Tensor,  # (T, M) f32
    X: torch.Tensor,  # (N, F) f32
    max_depth: int,
) -> torch.Tensor:
    """Return final leaf index per (sample, tree): (N, T) int64."""
    n_trees = left.shape[0]
    tree_ar = torch.arange(n_trees, device=X.device)[None, :]  # (1, T)
    idx = torch.zeros((X.shape[0], n_trees), dtype=torch.int64,
                      device=X.device)
    for _ in range(max_depth):
        f = feature[tree_ar, idx].to(torch.int64)  # (N, T)
        thr = threshold[tree_ar, idx]  # (N, T)
        xv = torch.gather(X, 1, f)  # (N, T)
        lch = left[tree_ar, idx].to(torch.int64)
        rch = right[tree_ar, idx].to(torch.int64)
        nxt = torch.where(xv <= thr, lch, rch)
        idx = torch.where(lch < 0, idx, nxt)  # leaf: stay put
    return idx


def forest_proba(
    left, right, feature, threshold, values, X, max_depth: int,
    tree_chunk: int = 16,
) -> torch.Tensor:
    """Mean of per-tree normalized leaf class distributions, (N, C) — the
    quantity sklearn's ``RandomForestClassifier.predict_proba`` averages
    before argmax. Trees are accumulated in chunks of ``tree_chunk``, as
    in the JAX reference."""
    leaf = traverse_gather(left, right, feature, threshold, X, max_depth)
    n_trees = left.shape[0]
    # Normalize leaf count rows into distributions once (tiny: T·M·C).
    norm = torch.sum(values, dim=-1, keepdim=True)
    values_n = values / torch.clamp_min(norm, 1e-30)
    probs = torch.zeros((X.shape[0], values.shape[-1]), dtype=values.dtype,
                        device=X.device)
    for t0 in range(0, n_trees, min(tree_chunk, n_trees)):
        t1 = min(t0 + tree_chunk, n_trees)
        tree_ar = torch.arange(t0, t1, device=X.device)[None, :]
        picked = values_n[tree_ar, leaf[:, t0:t1]]  # (N, c, C)
        probs = probs + torch.sum(picked, dim=1)
    return probs / n_trees
