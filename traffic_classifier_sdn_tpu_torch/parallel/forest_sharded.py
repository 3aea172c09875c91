"""Tree-sharded random forest: the ensemble split over the mesh's state
axis, class distributions summed across shards — the port of
``traffic_classifier_sdn_tpu/parallel/forest_sharded.py``.

Each shard holds T/D trees and evaluates its sub-ensemble with the port's
torch forms (``ops/tree_eval.py``'s gather traversal, or
``ops/tree_gemm.py``'s three GEMMs: the JAX package computes both in XLA,
in no hand-written kernel); the (N, C) per-shard sums are added in shard
order on the first shard's device — JAX's ``psum``, ``mesh.shard_sum`` —
and divided by the real tree count. The sum order differs from one
device's, so the ensemble mean agrees with it to ``atol=1e-5`` (ROADMAP
Queue 3 item 6), not bitwise. On a mesh spanning processes each rank
builds and holds only its own shards' trees or GEMM groups, and the
(N, C) sums cross through ``mesh.exchange``: every rank adds the same
host copies in shard order, so each gets the one-process mesh's bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.forest import ForestModel
from ..ops import tree_eval, tree_gemm
from .mesh import STATE_AXIS, shard_sum


def pad_trees(d: dict, n_shards: int) -> dict:
    """Pad the ensemble to a multiple of the state-axis size with inert
    single-leaf trees whose value rows are all zero (they add zero
    probability mass; the divisor uses the true tree count)."""
    T = d["left"].shape[0]
    pad = (-T) % n_shards
    if pad == 0:
        return d
    out = dict(d)
    for name in ("left", "right"):
        out[name] = np.concatenate(
            [d[name], np.full((pad,) + d[name].shape[1:], -1, d[name].dtype)]
        )
    for name in ("feature", "threshold", "values"):
        out[name] = np.concatenate(
            [d[name], np.zeros((pad,) + d[name].shape[1:], d[name].dtype)]
        )
    out["n_real_trees"] = T
    return out


def sharded_proba(mesh, params: ForestModel,
                  n_real_trees: int | None = None):
    """``fn(X) -> (N, C)`` ensemble-mean class probabilities, each shard's
    trees walked by the gather traversal."""
    devs = mesh.axis_devices(STATE_AXIS)
    D = len(devs)
    T = params.left.shape[0]
    if T % D:
        raise ValueError(
            f"{T} trees not divisible by {D} shards — pad_trees first"
        )
    n_real = n_real_trees if n_real_trees is not None else T
    per = T // D
    shards = {
        s: tuple(getattr(params, k)[s * per: (s + 1) * per].to(devs[s])
                 for k in ("left", "right", "feature", "threshold",
                           "values"))
        for s in mesh.local_shards(STATE_AXIS)
    }

    def local_sum(s: int, X: torch.Tensor) -> torch.Tensor:
        left, right, feature, threshold, values = shards[s]
        leaf = tree_eval.traverse_gather(left, right, feature, threshold,
                                         X, params.max_depth)
        tree_ar = torch.arange(left.shape[0], device=X.device)[None, :]
        leaf_vals = values[tree_ar, leaf]  # (N, T_local, C)
        norm = torch.sum(leaf_vals, dim=-1, keepdim=True)
        # padding trees have all-zero values: 0/max(0, eps) = 0
        probs = leaf_vals / torch.clamp_min(norm, 1e-30)
        return torch.sum(probs, dim=1)

    def fn(X: torch.Tensor) -> torch.Tensor:
        parts = [local_sum(s, X.to(dev)) if s in shards else None
                 for s, dev in enumerate(devs)]
        return shard_sum(parts, mesh, STATE_AXIS) / n_real

    return fn


def sharded_predict(mesh, params: ForestModel,
                    n_real_trees: int | None = None):
    """``fn(X) -> (N,) int32``: the argmax of ``sharded_proba``."""
    proba = sharded_proba(mesh, params, n_real_trees)
    return lambda X: torch.argmax(proba(X), dim=-1).to(torch.int32)


def gemm_sharded_proba(mesh, d: dict, n_features: int | None = None,
                       row_chunk: int = 65536):
    """``fn(X) -> (N, C)`` with the GEMM form per shard: ONE operand build
    over the whole (padded) ensemble — uniform (D_max, L_max) padding,
    leaf values pre-divided by the REAL tree count — then each shard takes
    its block of T/D trees. ``d`` is the node-array dict (``pad_trees``
    output). Only this process's shards get a group."""
    devs = mesh.axis_devices(STATE_AXIS)
    D_mesh = len(devs)
    T = d["left"].shape[0]
    if T % D_mesh:
        raise ValueError(
            f"{T} trees not divisible by {D_mesh} shards — pad_trees first"
        )
    n_real = int(d.get("n_real_trees", T))
    ops = tree_gemm.build_gemm_operands(d, n_features=n_features,
                                        n_trees_total=n_real)
    F = ops["feat_onehot"].shape[0]
    Dm = ops["n_internal"]
    per = T // D_mesh
    feat3 = np.asarray(ops["feat_onehot"]).reshape(F, T, Dm)
    thr2 = np.asarray(ops["thresholds"]).reshape(T, Dm)
    groups: list = [None] * D_mesh
    for s in mesh.local_shards(STATE_AXIS):
        sl = slice(s * per, (s + 1) * per)
        sub = dict(
            ops,
            feat_onehot=feat3[:, sl].reshape(F, per * Dm),
            thresholds=thr2[sl].reshape(per * Dm),
            path=np.asarray(ops["path"])[sl],
            leaf_depth=np.asarray(ops["leaf_depth"])[sl],
            leaf_values=np.asarray(ops["leaf_values"])[sl],
        )
        groups[s] = tree_gemm.gemm_group(sub, row_chunk, devs[s])

    def fn(X: torch.Tensor) -> torch.Tensor:
        return shard_sum([
            None if g is None else tree_gemm.forest_proba_gemm([g],
                                                              X.to(dev))
            for g, dev in zip(groups, devs)
        ], mesh, STATE_AXIS)

    return fn


def gemm_sharded_predict(mesh, d: dict, n_features: int | None = None,
                         row_chunk: int = 65536):
    """``fn(X) -> (N,) int32``: the argmax of ``gemm_sharded_proba``."""
    proba = gemm_sharded_proba(mesh, d, n_features, row_chunk)
    return lambda X: torch.argmax(proba(X), dim=-1).to(torch.int32)
