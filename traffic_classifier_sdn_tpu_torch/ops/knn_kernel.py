"""The KNN top-k of the serving path: the hand-written CUDA kernel
``csrc/knn_topk.cu``, its wrapper, and its plain PyTorch version.

It replaces the fused Pallas TPU kernel
``traffic_classifier_sdn_tpu/ops/pallas_knn.py`` (``topk_sim_idx`` /
``_kernel``): the same ((N, k) similarities, (N, k) indices) of the k
most similar corpus rows under ``sim = x·s − ½‖s‖²``, ordered by (value
desc, index asc) — bitwise what ``lax.top_k`` over the full similarity
row returns wherever the arithmetic is exact. See the note at the top of
the CUDA source for what bounds it on the card and what the design does
about that.

Operands (``compile_knn``): the corpus as (S, 16) float32 records —
features in slots 0..F−1, ½‖s‖² in slot 15 — read by the kernel, and the
model's ``fit_X``/``half_sq_norms`` read by the plain version
(models/knn.py ``dot_expansion_sim`` + ``topk_stable``, in the kernel's
arithmetic order and tie order). The corpus is not padded: the kernel
scans exactly S rows.

Launch shape (``launch_shape``, pure Python so the CPU tests check it):
the rows per warp, chosen from (N, k). Every warp scans the whole corpus
for its rows, so fewer rows per warp is how a small N fills the card.
``launches`` counts wrapper calls that launch, one each.

``topk_sim_idx`` takes a CPU tensor to the plain version and launches the
kernel on a CUDA tensor — or raises. There is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ..models import knn
from . import cuda_build
from .chunking import map_row_chunks

KERNEL = "knn_topk"
MAX_NEIGHBORS = 128  # kMaxNeighbors in csrc/knn_topk.cu
MAX_FEATURES = 15  # kMaxFeatures in csrc/knn_topk.cu
RECORD = 16  # floats per corpus record
ROW_CHUNK = 65536  # rows per step of the plain version
THREADS = 256  # kThreads: 8 warps per block
WARPS = THREADS // 32
CHUNK = 128  # kChunk: records a warp takes at once (4 per lane)
SMS = 132  # streaming multiprocessors of an H100 SXM
MAX_ROWS_PER_WARP = 16  # kMaxRowsPerWarp in csrc/knn_topk.cu


def list_slots(k: int) -> int:
    """Slots per lane of the kernel's top-k list (KS): 1 for k <= 32, 4
    for k <= 128."""
    return 1 if k <= 32 else MAX_NEIGHBORS // 32


def rows_per_warp_choices(k: int) -> tuple[int, ...]:
    """The rows per warp a launch may take, most first: up to 16 for
    k <= 32, two for larger k (whose lists take four times the shared
    memory). Eight is left out: it was the fastest at no size timed
    (PERF.md, ``tools/torch_kernel_sweep.py``)."""
    return (16, 4, 2, 1) if k <= 32 else (2, 1)


def blocks(n_rows: int, rows_per_warp: int) -> int:
    """Blocks of a launch: 8 warps of ``rows_per_warp`` rows each."""
    return -(-n_rows // (WARPS * rows_per_warp))


def launch_shape(n_rows: int, k: int) -> int:
    """Rows per warp: the most that still gives a block per SM, else one
    row per warp."""
    for r in rows_per_warp_choices(k):
        if blocks(n_rows, r) >= SMS:
            return r
    return 1


def instance(g) -> str:
    """The template arguments of the kernel instance a launch on ``g``
    uses, as in ``knn_topk_kernel<1, 12>``: the list slots per lane, and
    the features fixed at compile time (12) or 0 for any other F."""
    return f"{list_slots(g.n_neighbors)}, {12 if g.n_features == 12 else 0}"


@dataclass
class KnnKernelOperands:
    records: torch.Tensor  # (S, 16) f32 corpus records, ½‖s‖² in slot 15
    fit_X: torch.Tensor  # (S, F) f32: the plain version's operands
    half_sq: torch.Tensor  # (S,) f32
    fit_y: torch.Tensor  # (S,) int32 class indices
    n_rows: int  # S
    n_neighbors: int
    n_classes: int
    n_features: int


def compile_knn(params: knn.KnnModel) -> KnnKernelOperands:
    """Kernel operands from a ``KnnModel``, on the model's device
    (``corpus_operands``)."""
    return corpus_operands(params.fit_X, params.half_sq_norms, params.fit_y,
                           params.n_neighbors, params.n_classes)


def corpus_operands(fit_X: torch.Tensor, half_sq: torch.Tensor,
                    fit_y: torch.Tensor, n_neighbors: int,
                    n_classes: int) -> KnnKernelOperands:
    """Kernel operands of a corpus, on its device: the one home of the
    record layout (``compile_knn`` and the corpus shards of
    parallel/knn_sharded.fused_predict build through it). A padding row
    (zero features, +inf half norm) has similarity −inf to every finite
    query. Rejects k > 128 (the kernel's top-k list) and a corpus with
    fewer than k rows, whose top-k does not exist."""
    k = n_neighbors
    if k > MAX_NEIGHBORS:
        raise ValueError(
            f"n_neighbors={k} exceeds the kernel's 128-lane top-k carry"
        )
    S, F = fit_X.shape
    if S < k:
        raise ValueError(f"corpus has {S} rows < n_neighbors={k}")
    if not 1 <= F <= MAX_FEATURES:
        raise ValueError(
            f"the KNN kernel takes 1..{MAX_FEATURES} features, got {F}"
        )
    records = torch.zeros((S, RECORD), dtype=torch.float32,
                          device=fit_X.device)
    records[:, :F] = fit_X
    records[:, RECORD - 1] = half_sq
    return KnnKernelOperands(
        records=records,
        fit_X=fit_X.float().contiguous(),
        half_sq=half_sq.float().contiguous(),
        fit_y=fit_y,
        n_rows=S, n_neighbors=k, n_classes=n_classes, n_features=F,
    )


def topk_sim_idx_plain(g: KnnKernelOperands, X: torch.Tensor):
    """The plain PyTorch version: the similarity in the kernel's order and
    a stable descending sort, over 65,536-row slices."""
    return map_row_chunks(
        lambda xc: knn.topk_stable(
            knn.dot_expansion_sim(xc, g.fit_X, g.half_sq), g.n_neighbors
        ),
        ROW_CHUNK, X,
    )


@functools.cache
def _launcher():
    fn = cuda_build.load_library(KERNEL).knn_topk_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # X, n_rows, n_features
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # records, S, k
        ctypes.c_int,  # rows per warp
        ctypes.c_void_p, ctypes.c_void_p,  # vals, idx
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(g: KnnKernelOperands, X: torch.Tensor) -> None:
    if X.dtype != torch.float32 or X.dim() != 2:
        raise ValueError(f"X must be (N, F) float32, got {X.dtype} {tuple(X.shape)}")
    if X.shape[1] != g.n_features:
        raise ValueError(
            f"X has {X.shape[1]} features, the corpus has {g.n_features}"
        )
    if g.records.device != X.device:
        raise ValueError(
            f"X is on {X.device}, the corpus operands on {g.records.device}"
        )


def topk_sim_idx(g: KnnKernelOperands, X: torch.Tensor):
    """((N, k) f32 similarities, (N, k) int32 indices) of the k most
    similar corpus rows, descending, ties to the lowest index. A CPU
    tensor goes to the plain version; a CUDA tensor launches the kernel on
    the current stream, in ``launch_shape``, or raises."""
    _check(g, X)
    if X.device.type == "cpu":
        return topk_sim_idx_plain(g, X)
    return _launch(g, X, launch_shape(X.shape[0], g.n_neighbors))


def _launch(g: KnnKernelOperands, X: torch.Tensor, rows_per_warp: int):
    """Launches the kernel on the CUDA tensor ``X`` with ``rows_per_warp``
    rows per warp, and counts the launch in ``topk_sim_idx.launches``. The
    card tests and ``tools/torch_kernel_sweep.py`` force each shape through
    it; the result does not depend on the shape."""
    _check(g, X)
    if X.device.type != "cuda":
        raise ValueError(f"topk_sim_idx runs on cpu or cuda, not {X.device}")
    if not X.is_contiguous():
        raise ValueError("X must be contiguous")
    if X.shape[0] >= 2**31:
        raise ValueError("X has too many rows for the kernel's int32 index")
    if g.records.data_ptr() % 16:
        raise ValueError("corpus records must be 16-byte aligned")
    N, k = X.shape[0], g.n_neighbors
    vals = torch.empty((N, k), dtype=torch.float32, device=X.device)
    idx = torch.empty((N, k), dtype=torch.int32, device=X.device)
    if N == 0:
        return vals, idx
    if X.device.index == torch.cuda.current_device():
        rc = _call(g, X, rows_per_warp, vals, idx)
    else:
        with torch.cuda.device(X.device):
            rc = _call(g, X, rows_per_warp, vals, idx)
    if rc != 0:
        raise RuntimeError(f"knn_topk kernel launch failed: CUDA error {rc}")
    topk_sim_idx.launches += 1
    return vals, idx


def _call(g, X, rows_per_warp, vals, idx) -> int:
    # The raw handle of the current stream: building the Python Stream
    # object (torch.cuda.current_stream()) takes more host time than the
    # kernel takes at small N (tools/torch_kernel_sweep.py times both).
    stream = torch._C._cuda_getCurrentRawStream(X.device.index)
    return _launcher()(
        X.data_ptr(), X.shape[0], X.shape[1],
        g.records.data_ptr(), g.n_rows, g.n_neighbors, rows_per_warp,
        vals.data_ptr(), idx.data_ptr(), stream,
    )


topk_sim_idx.launches = 0  # kernel launches (CUDA tensors only)


def neighbor_idx(g: KnnKernelOperands, X: torch.Tensor) -> torch.Tensor:
    """(N, k) int32 indices of the k nearest corpus rows, descending
    similarity, ties to the lowest index."""
    return topk_sim_idx(g, X)[1]


def scores(g: KnnKernelOperands, X: torch.Tensor, X_lo=None) -> torch.Tensor:
    """(N, C) int32 neighbor class counts — models/knn ``neighbor_votes``
    semantics. ``X_lo`` must be None: the kernel computes the dot
    expansion only (the two-float form stays on models/knn.py)."""
    if X_lo is not None:
        raise ValueError("the KNN kernel has no two-float mode")
    return knn.count_votes(g.fit_y, g.n_classes, neighbor_idx(g, X))


def predict(g: KnnKernelOperands, X: torch.Tensor, X_lo=None) -> torch.Tensor:
    """(N,) int32 labels: argmax of the votes, ties to the lowest class."""
    return torch.argmax(scores(g, X, X_lo), dim=-1).to(torch.int32)
