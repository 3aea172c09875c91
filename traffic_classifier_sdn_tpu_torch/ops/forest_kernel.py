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
f32-safe thresholds and pre-divided leaf values. Each tree is one blob of
``blob_words`` int32 words (a multiple of 4, so a blob is whole 16-byte
copies):

- words ``[0, node_words)``: one 8-byte record per internal node (D of
  them, padded to an even count): the threshold's f32 bits, then
  ``feature | left << 6 | right << 19``. A child code ``c < D`` is an
  internal node of the same tree, ``c >= D`` the leaf slot ``c - D``.
  A tree whose root is a leaf gets one always-true split (+inf
  threshold) whose two children are leaf 0;
- words ``[node_words, node_words + L·C)``: the tree's (L, C) leaf
  values, f32 bits, normalized and pre-divided by T.

Non-finite features: the plain version selects each node's feature as
``X @ feat_onehot``, and ``NaN·0`` and ``±inf·0`` are NaN, so in a row
with a non-finite feature every node that splits on another feature
sees NaN (and goes right). ``effective_features`` states the rule: the
value of feature f is ``x[f]`` when every other feature of the row is
finite, else NaN. The kernel applies it once per row, when it stages the
row; the walk itself has no extra branch.

Launch shape (``launch_shape``, pure Python so the CPU tests check it):
the rows per tile, from N, and the trees per shared-memory stage, from
the forest's size. Tiles of 32 and 128 rows take the tile design (a
block's warps walk (tree, 32 rows) pairs, then sum in tree order);
1024-row tiles the row design (a thread per row walks every tree).
``launches`` counts wrapper calls that launch, one each.

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
FEATURE_BITS = 6  # kFeatureBits: features per record field
MAX_FEATURES = 1 << FEATURE_BITS
CHILD_BITS = 13  # kChildBits: D + L must stay below 2^13
MAX_CODES = 1 << CHILD_BITS
ROW_CHUNK = 32768  # rows per step of the plain version's GEMM form
MAX_TILE_ROWS = 128  # kMaxTileRows: larger tiles take the row design
TILE_THREADS = 1024  # kMaxThreads: the tile design's 32 warps a block
SLOT_BYTES = 2  # a reached-leaf slot of the tile design (uint16)
# The launch shapes' rows per tile, and the least N at which each is
# chosen (tools/torch_kernel_sweep.py times each at such an N).
FROM_ROWS = {32: 0, 128: 10_000, 1024: 100_000}
ROWS_PER_TILE = tuple(FROM_ROWS)
SMEM_BYTES = 232448  # kSmemBytes: the most shared memory a block may use
SMS = 132  # streaming multiprocessors of an H100 SXM


@dataclass
class ForestKernelOperands:
    forest: torch.Tensor  # (T, blob_words) int32 tree blobs
    gemm: list  # [tree_gemm.ForestGemm]: the plain version's operands
    n_trees: int
    n_internal: int  # D: internal-node slots per tree, the leaf-code base
    n_leaves: int  # L
    n_classes: int
    n_features: int
    node_words: int  # words of a blob before its leaf values
    blob_words: int  # words per tree blob
    per_chunk: dict  # {rows per tile: trees per stage}, see trees_per_chunk


def _node_codes(d: dict, ops: dict, t: int):
    """[(feature, left code, right code)] of tree t's internal nodes in
    ``build_gemm_operands``' slot order (BFS over reachable nodes)."""
    left, right, feature = d["left"], d["right"], d["feature"]
    D, F = ops["n_internal"], ops["n_features"]
    reach = tree_gemm._reachable_nodes(left, right, t)
    internal = [n for n in reach if left[t, n] != -1]
    leaves = [n for n in reach if left[t, n] == -1]
    code = {n: s for s, n in enumerate(internal)}
    code.update({n: D + s for s, n in enumerate(leaves)})
    if not internal:  # root is a leaf: +inf split, both sides leaf 0
        return [(0, D, D)]
    out = []
    for n in internal:
        if not 0 <= feature[t, n] < F:
            # the kernel reads x[feature] unchecked
            raise ValueError(
                f"tree {t} node {n} splits on feature {feature[t, n]}, "
                f"outside [0, {F})"
            )
        out.append((int(feature[t, n]), code[int(left[t, n])],
                    code[int(right[t, n])]))
    return out


def tree_blobs(d: dict, ops: dict) -> tuple[np.ndarray, int]:
    """((T, blob_words) int32 tree blobs, node_words) — the layout in the
    module note. Thresholds are ``build_gemm_operands``' f32-safe ones,
    so kernel and GEMM form make the same decisions."""
    T, D, L, C = (ops["n_trees"], ops["n_internal"], ops["n_leaves"],
                  ops["n_classes"])
    node_words = 2 * (D + D % 2)
    blob_words = node_words + -(-(L * C) // 4) * 4
    thr_bits = ops["thresholds"].view(np.int32).reshape(T, D)
    blob = np.zeros((T, blob_words), np.int32)
    for t in range(T):
        for s, (f, lc, rc) in enumerate(_node_codes(d, ops, t)):
            blob[t, 2 * s] = thr_bits[t, s]
            blob[t, 2 * s + 1] = np.uint32(
                f | lc << FEATURE_BITS | rc << (FEATURE_BITS + CHILD_BITS)
            ).view(np.int32)
    blob[:, node_words: node_words + L * C] = (
        ops["leaf_values"].reshape(T, L * C).view(np.int32)
    )
    return blob, node_words


def unpack_records(k: ForestKernelOperands):
    """(feature, threshold, left, right), each (T, D) on the operands'
    device: the node records of the blobs, decoded."""
    T, D = k.n_trees, k.n_internal
    rec = k.forest[:, : 2 * D].reshape(T, D, 2)
    packed = rec[..., 1].long() & 0xFFFFFFFF
    code_mask = MAX_CODES - 1
    return (
        packed & (MAX_FEATURES - 1),
        rec[..., 0].view(torch.float32),
        (packed >> FEATURE_BITS) & code_mask,
        (packed >> (FEATURE_BITS + CHILD_BITS)) & code_mask,
    )


def compile_forest(d: dict, n_features: int | None = None,
                   device=None) -> ForestKernelOperands:
    """Kernel operands from importer node arrays (numpy), on ``device``
    (default CUDA, see device.py). Rejects more than 16 classes, more than
    64 features, and trees whose D + L reaches 2^13 (the record's child
    codes)."""
    device = resolve_device(device)
    ops = tree_gemm.build_gemm_operands(d, n_features=n_features)
    if ops["n_classes"] > MAX_CLASSES:
        raise ValueError(
            f"forest kernel supports at most {MAX_CLASSES} classes, "
            f"got {ops['n_classes']}"
        )
    if ops["n_features"] > MAX_FEATURES:
        raise ValueError(
            f"forest kernel supports at most {MAX_FEATURES} features, "
            f"got {ops['n_features']}"
        )
    T, D, L = ops["n_trees"], ops["n_internal"], ops["n_leaves"]
    if D + L >= MAX_CODES:
        raise ValueError(
            f"forest kernel takes trees of D + L < {MAX_CODES} nodes, got "
            f"{D} internal + {L} leaf slots"
        )
    blob, node_words = tree_blobs(d, ops)
    k = ForestKernelOperands(
        forest=torch.from_numpy(blob).to(device),
        gemm=[tree_gemm.gemm_group(ops, ROW_CHUNK, device)],
        n_trees=T, n_internal=D, n_leaves=L,
        n_classes=ops["n_classes"], n_features=ops["n_features"],
        node_words=node_words, blob_words=blob.shape[1], per_chunk={},
    )
    k.per_chunk.update({r: n for r in ROWS_PER_TILE
                        if (n := trees_per_chunk(k, r))})
    if not k.per_chunk:
        raise ValueError(
            f"one tree ({k.blob_words * 4} bytes) does not fit the kernel's "
            f"{SMEM_BYTES}-byte shared-memory stage beside a row tile"
        )
    return k


def effective_features(X: torch.Tensor) -> torch.Tensor:
    """The feature values the GEMM form's ``X @ feat_onehot`` selects:
    ``x[f]`` where every other feature of the row is finite, else NaN
    (the kernel stages these)."""
    bad = ~torch.isfinite(X)
    n_bad = bad.sum(1, keepdim=True)
    keep = (n_bad == 0) | ((n_bad == 1) & bad)
    return torch.where(keep, X, torch.full_like(X, float("nan")))


def forest_proba_plain(k: ForestKernelOperands, X: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the GEMM form over all trees in their
    original order, summed sequentially — bit-identical to the kernel."""
    return tree_gemm.forest_proba_gemm(k.gemm, X)


def row_design(rows_per_tile: int) -> bool:
    """Whether a launch of ``rows_per_tile`` rows per tile is the row
    design (a thread per row, every tree) rather than the tile design."""
    return rows_per_tile > MAX_TILE_ROWS


def smem_bytes(k: ForestKernelOperands, rows_per_tile: int,
               trees_per_chunk: int) -> int:
    """Shared memory of a launch: a stage of tree blobs and the X tile;
    the tile design pads its rows to an odd stride and adds a
    reached-leaf slot per (tree, row)."""
    R = rows_per_tile
    if row_design(R):
        return trees_per_chunk * k.blob_words * 4 + R * k.n_features * 4
    return (trees_per_chunk * k.blob_words * 4
            + R * (k.n_features | 1) * 4
            + trees_per_chunk * R * SLOT_BYTES)


def trees_per_chunk(k: ForestKernelOperands, rows_per_tile: int) -> int:
    """The most trees whose blobs fit one shared-memory stage beside the
    X tile (and the slots); the whole forest when it fits, 0 when not even
    one tree does."""
    free = SMEM_BYTES - smem_bytes(k, rows_per_tile, 0)
    per_tree = smem_bytes(k, rows_per_tile, 1) - smem_bytes(k, rows_per_tile, 0)
    return min(k.n_trees, max(free, 0) // per_tree)


def tree_chunks(n_trees: int, per_chunk: int) -> list[tuple[int, int]]:
    """The stages of a launch, [first tree, end) in tree order."""
    return [(t, min(t + per_chunk, n_trees))
            for t in range(0, n_trees, per_chunk)]


def blocks(n_rows: int, rows_per_tile: int) -> int:
    """Blocks of a launch: one per row tile, at most one per SM (each
    block then loops over tiles, keeping a one-stage forest staged)."""
    return min(-(-n_rows // rows_per_tile), SMS)


def threads(rows_per_tile: int) -> int:
    """Threads of a block: one per row in the row design, else 1024."""
    return rows_per_tile if row_design(rows_per_tile) else TILE_THREADS


def launch_shape(n_rows: int, k: ForestKernelOperands) -> tuple[int, int]:
    """(rows per tile, trees per chunk): the largest tile of ``FROM_ROWS``
    chosen at ``n_rows`` beside which a tree fits in shared memory (32
    rows always does, or ``compile_forest`` raised), with as many trees
    per stage as fit (``k.per_chunk``)."""
    rows = max(r for r in k.per_chunk if n_rows >= FROM_ROWS[r])
    return rows, k.per_chunk[rows]


def instance(rows_per_tile: int) -> str:
    """The template argument of the kernel instance a launch of
    ``rows_per_tile`` rows per tile uses, as in
    ``forest_proba_kernel<true>``: whether it is the row design."""
    return "true" if row_design(rows_per_tile) else "false"


@functools.cache
def _launcher():
    fn = cuda_build.load_library(KERNEL).forest_proba_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # X, n_rows, n_features
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # forest, T, D
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # L, node_words, blob_words
        ctypes.c_int,  # n_classes
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # rows/tile, trees/chunk, blocks
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
    if k.forest.device != X.device:
        raise ValueError(
            f"X is on {X.device}, the forest operands on {k.forest.device}"
        )


def forest_proba(k: ForestKernelOperands, X: torch.Tensor) -> torch.Tensor:
    """(N, C) ensemble-mean class probabilities. A CPU tensor goes to the
    plain version; a CUDA tensor launches the kernel on the current stream,
    in ``launch_shape``, or raises."""
    _check(k, X)
    if X.device.type == "cpu":
        return forest_proba_plain(k, X)
    return _run(k, X, *launch_shape(X.shape[0], k))


def _launch(k: ForestKernelOperands, X: torch.Tensor, rows_per_tile: int,
            per_chunk: int) -> torch.Tensor:
    """Launches the kernel on the CUDA tensor ``X`` with ``rows_per_tile``
    rows per tile and ``per_chunk`` trees per stage, and counts the launch
    in ``forest_proba.launches``. The card tests and
    ``tools/torch_kernel_sweep.py`` force each shape through it; the
    result does not depend on the shape."""
    _check(k, X)
    if rows_per_tile not in FROM_ROWS:
        raise ValueError(f"rows_per_tile must be one of {ROWS_PER_TILE}")
    if smem_bytes(k, rows_per_tile, per_chunk) > SMEM_BYTES:
        raise ValueError(
            f"{per_chunk} trees per stage at {rows_per_tile} rows per tile "
            f"exceed {SMEM_BYTES} bytes of shared memory"
        )
    return _run(k, X, rows_per_tile, per_chunk)


def _run(k: ForestKernelOperands, X: torch.Tensor, rows_per_tile: int,
         per_chunk: int) -> torch.Tensor:
    """The launch itself, on a checked X and a shape that fits. The host
    work here is part of every call's time at small N, so it stays lean:
    the device guard is entered only when X is not on the current
    device."""
    if X.device.type != "cuda":
        raise ValueError(f"forest_proba runs on cpu or cuda, not {X.device}")
    if not X.is_contiguous():
        raise ValueError("X must be contiguous")
    N = X.shape[0]
    if N >= 2**31:
        raise ValueError("X has too many rows for the kernel's int32 index")
    if k.forest.data_ptr() % 16:
        raise ValueError("tree blobs must be 16-byte aligned")
    out = torch.empty((N, k.n_classes), dtype=torch.float32, device=X.device)
    if N == 0:
        return out
    if X.device.index == torch.cuda.current_device():
        rc = _call(k, X, rows_per_tile, per_chunk, out)
    else:
        with torch.cuda.device(X.device):
            rc = _call(k, X, rows_per_tile, per_chunk, out)
    if rc != 0:
        raise RuntimeError(f"forest_proba kernel launch failed: CUDA error {rc}")
    forest_proba.launches += 1
    return out


def _call(k, X, rows_per_tile, per_chunk, out) -> int:
    # The raw handle of the current stream: building the Python Stream
    # object (torch.cuda.current_stream()) takes more host time than the
    # kernel takes at small N (tools/torch_kernel_sweep.py times both).
    stream = torch._C._cuda_getCurrentRawStream(X.device.index)
    return _launcher()(
        X.data_ptr(), X.shape[0], X.shape[1],
        k.forest.data_ptr(), k.n_trees, k.n_internal,
        k.n_leaves, k.node_words, k.blob_words, k.n_classes,
        rows_per_tile, per_chunk, blocks(X.shape[0], rows_per_tile),
        out.data_ptr(), stream,
    )


forest_proba.launches = 0  # kernel launches (CUDA tensors only)


def predict(k: ForestKernelOperands, X: torch.Tensor) -> torch.Tensor:
    """(N,) int32 labels: argmax of ``forest_proba`` (ties to the lowest
    class, as ``jnp.argmax``)."""
    return torch.argmax(forest_proba(k, X), dim=-1).to(torch.int32)
