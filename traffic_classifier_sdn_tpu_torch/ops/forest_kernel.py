"""The forest evaluator of the serving path: the hand-written CUDA kernel
``csrc/forest_proba.cu``, its wrapper, and its plain PyTorch version.

It replaces the fused Pallas TPU kernel
``traffic_classifier_sdn_tpu/ops/pallas_forest.py``
(``forest_proba_pallas`` / ``_kernel``): the same (N, C) ensemble-mean
class probabilities, predict being the argmax. See the note at the top of
the CUDA source for what bounds it on the card and what the design does
about that.

Operands (``compile_forest``) come from the port's copy of the JAX
operand builder (ops/tree_gemm.build_gemm_operands, one group, trees in
their original order), so the kernel reads exactly the plain version's
f32-safe thresholds and pre-divided leaf values:

- ``nodes`` (T·D, 4) int32: one 16-byte record per internal node,
  ``{feature, threshold as f32 bits, left code, right code}``; a child
  code ``c >= 0`` is an internal node of the same tree, ``c < 0`` the leaf
  slot ``-1 - c``. A tree whose root is a leaf gets one always-true split
  (+inf threshold) whose two children are leaf 0.
- ``leaf_values`` (T, L, C) f32, normalized and pre-divided by T.

``forest_proba`` takes a CPU tensor to the plain version (the GEMM form,
summed in tree order, bit-identical to the kernel) and launches the
kernel on a CUDA tensor — or raises. There is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from . import cuda_build, tree_gemm

KERNEL = "forest_proba"
MAX_CLASSES = 16  # kMaxClasses in csrc/forest_proba.cu
ROW_CHUNK = 32768  # rows per step of the plain version's GEMM form


@dataclass
class ForestKernelOperands:
    nodes: torch.Tensor  # (T*D, 4) int32 node records
    leaf_values: torch.Tensor  # (T, L, C) f32, normalized / T
    gemm: list  # [tree_gemm.ForestGemm]: the plain version's operands
    n_trees: int
    n_internal: int  # D: node records per tree
    n_leaves: int  # L
    n_classes: int
    n_features: int


def node_records(d: dict, ops: dict) -> np.ndarray:
    """(T, D, 4) int32 node records in ``build_gemm_operands``' slot order
    (BFS over reachable nodes), thresholds taken from its f32-safe
    ``thresholds`` so kernel and GEMM form make the same decisions."""
    left, right, feature = d["left"], d["right"], d["feature"]
    T, D, F = ops["n_trees"], ops["n_internal"], ops["n_features"]
    thr_bits = ops["thresholds"].view(np.int32).reshape(T, D)
    rec = np.zeros((T, D, 4), np.int32)
    rec[:, :, 1] = thr_bits
    for t in range(T):
        reach = tree_gemm._reachable_nodes(left, right, t)
        internal = [n for n in reach if left[t, n] != -1]
        leaves = [n for n in reach if left[t, n] == -1]
        code = {n: s for s, n in enumerate(internal)}
        code.update({n: -1 - s for s, n in enumerate(leaves)})
        if not internal:  # root is a leaf: +inf split, both sides leaf 0
            rec[t, 0] = (0, thr_bits[t, 0], -1, -1)
        for s, n in enumerate(internal):
            if not 0 <= feature[t, n] < F:
                # the kernel reads x[feature] unchecked
                raise ValueError(
                    f"tree {t} node {n} splits on feature {feature[t, n]}, "
                    f"outside [0, {F})"
                )
            rec[t, s, 0] = feature[t, n]
            rec[t, s, 2] = code[int(left[t, n])]
            rec[t, s, 3] = code[int(right[t, n])]
    return rec


def compile_forest(d: dict, n_features: int | None = None,
                   device=None) -> ForestKernelOperands:
    """Kernel operands from importer node arrays (numpy), on ``device``
    (default CUDA, see device.py)."""
    device = resolve_device(device)
    ops = tree_gemm.build_gemm_operands(d, n_features=n_features)
    if ops["n_classes"] > MAX_CLASSES:
        raise ValueError(
            f"forest kernel supports at most {MAX_CLASSES} classes, "
            f"got {ops['n_classes']}"
        )
    rec = node_records(d, ops)
    T, D, L = ops["n_trees"], ops["n_internal"], ops["n_leaves"]
    return ForestKernelOperands(
        nodes=torch.from_numpy(rec.reshape(T * D, 4)).to(device),
        leaf_values=torch.from_numpy(ops["leaf_values"]).to(device),
        gemm=[tree_gemm.gemm_group(ops, ROW_CHUNK, device)],
        n_trees=T, n_internal=D, n_leaves=L,
        n_classes=ops["n_classes"], n_features=ops["n_features"],
    )


def forest_proba_plain(k: ForestKernelOperands, X: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the GEMM form over all trees in their
    original order, summed sequentially — bit-identical to the kernel."""
    return tree_gemm.forest_proba_gemm(k.gemm, X)


@functools.cache
def _launcher():
    fn = cuda_build.load_library(KERNEL).forest_proba_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # X, n_rows, n_features
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # nodes, T, D
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # leaf_values, L, C
        ctypes.c_void_p, ctypes.c_void_p,  # out, stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(k: ForestKernelOperands, X: torch.Tensor) -> None:
    if X.dtype != torch.float32 or X.dim() != 2:
        raise ValueError(f"X must be (N, F) float32, got {X.dtype} {tuple(X.shape)}")
    if X.shape[1] != k.n_features:
        raise ValueError(
            f"X has {X.shape[1]} features, the forest expects {k.n_features}"
        )
    if k.nodes.device != X.device or k.leaf_values.device != X.device:
        raise ValueError(
            f"X is on {X.device}, the forest operands on {k.nodes.device}"
        )


def forest_proba(k: ForestKernelOperands, X: torch.Tensor) -> torch.Tensor:
    """(N, C) ensemble-mean class probabilities. A CPU tensor goes to the
    plain version; a CUDA tensor launches the kernel on the current stream
    or raises."""
    _check(k, X)
    if X.device.type == "cpu":
        return forest_proba_plain(k, X)
    if X.device.type != "cuda":
        raise ValueError(f"forest_proba runs on cpu or cuda, not {X.device}")
    if not X.is_contiguous():
        raise ValueError("X must be contiguous")
    if X.shape[0] >= 2**31:
        raise ValueError("X has too many rows for the kernel's int32 index")
    if k.nodes.data_ptr() % 16:
        raise ValueError("node records must be 16-byte aligned")
    out = torch.empty((X.shape[0], k.n_classes), dtype=torch.float32,
                      device=X.device)
    if X.shape[0] == 0:
        return out
    with torch.cuda.device(X.device):
        rc = _launcher()(
            X.data_ptr(), X.shape[0], X.shape[1],
            k.nodes.data_ptr(), k.n_trees, k.n_internal,
            k.leaf_values.data_ptr(), k.n_leaves, k.n_classes,
            out.data_ptr(), torch.cuda.current_stream(X.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"forest_proba kernel launch failed: CUDA error {rc}")
    forest_proba.launches += 1
    return out


forest_proba.launches = 0  # kernel launches (CUDA tensors only)


def predict(k: ForestKernelOperands, X: torch.Tensor) -> torch.Tensor:
    """(N,) int32 labels: argmax of ``forest_proba`` (ties to the lowest
    class, as ``jnp.argmax``)."""
    return torch.argmax(forest_proba(k, X), dim=-1).to(torch.int32)
