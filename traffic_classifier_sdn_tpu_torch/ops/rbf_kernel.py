"""The RBF-SVC decision of the serving path: the hand-written CUDA kernel
``csrc/rbf_decision.cu``, its wrapper, and its plain PyTorch version.

It replaces the fused Pallas TPU kernel
``traffic_classifier_sdn_tpu/ops/pallas_rbf.py`` (``partial_decision`` /
``_kernel``, entry ``decision_ovo_pallas``): the same (N, P) one-vs-one
decisions ``Σ_s exp(−γ·d²(x, s))·coef[p, s]`` in the two-float difference
form, the intercept added once by ``decision_ovo``. See the note at the
top of the CUDA source for what bounds it on the card and what the design
does about that.

Operands (``compile_svc``): each support vector as one (48,) float32
record — ``sv_hi`` in slots 0..15, ``sv_lo`` in 16..31, its P
coefficients in 32..47 — read by the kernel, and the model's ``sv_hi``,
``sv_lo`` and transposed ``pair_coef`` read by the plain version
(models/svc.py ``sq_dist`` + ``decision_sum``, in the kernel's order). No
padding: the kernel sums exactly S support vectors. γ is kept as a
Python float too, so a launch reads no device scalar.

Launch shape (``launch_shape``, pure Python so the CPU tests check it):
the rows per block, from N. The support vectors are never split across
blocks — each (row, pair) sum is one thread's, in support-vector order —
so fewer rows per block is how a small N fills the card.

``partial_decision`` takes a CPU tensor to the plain version and launches
the kernel on a CUDA tensor — or raises. There is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ..models import svc
from . import cuda_build
from .chunking import map_row_chunks

KERNEL = "rbf_decision"
MAX_FEATURES = 16  # kMaxFeatures in csrc/rbf_decision.cu
MAX_PAIRS = 15  # kMaxPairs: the pairs of 6 classes
RECORD = 48  # floats per support-vector record
LO_SLOT, COEF_SLOT = 16, 32
ROW_CHUNK = 65536  # rows per step of the plain version
STAGE = 32  # kStage: support vectors per shared-memory stage
ROWS_PER_BLOCK = (64, 16, 4)  # the kernel's instances, most first
SMS = 132  # streaming multiprocessors of an H100 SXM


def threads_per_block(rows_per_block: int) -> int:
    """threads_for in the kernel: 32 per row, at most 256."""
    return min(256, 32 * rows_per_block)


def launch_shape(n_rows: int) -> int:
    """Rows per block: the most that still gives a block per SM, else
    the fewest, 4."""
    for r in ROWS_PER_BLOCK:
        if -(-n_rows // r) >= SMS:
            return r
    return ROWS_PER_BLOCK[-1]


def instance(g, rows_per_block: int, has_xlo: bool) -> str:
    """The template arguments of the kernel instance a launch on ``g``
    uses, as in ``rbf_decision_kernel<64, 12, 15, false>``: F and P are
    fixed at compile time for the reference's 12 features and 15 pairs,
    else 0."""
    fixed = (g.n_features, g.n_pairs) == (12, 15)
    return (f"{rows_per_block}, {12 if fixed else 0}, {15 if fixed else 0}, "
            f"{'true' if has_xlo else 'false'}")


@dataclass
class SvcKernelOperands:
    records: torch.Tensor  # (S, 48) f32 support-vector records
    sv_hi: torch.Tensor  # (S, F) f32: the plain version's operands
    sv_lo: torch.Tensor  # (S, F) f32
    coef_t: torch.Tensor  # (S, P) f32
    gamma_t: torch.Tensor  # () f32
    gamma: float  # the same value, for the launch
    intercept: torch.Tensor  # (P,) f32
    vote_i: torch.Tensor  # (P,) int32
    vote_j: torch.Tensor  # (P,) int32
    n_sv: int
    n_pairs: int
    n_classes: int
    n_features: int


def compile_svc(params: svc.SvcModel) -> SvcKernelOperands:
    """Kernel operands from an ``SvcModel``, on the model's device. Rejects
    more than 6 classes (15 pairs) and more than 16 features."""
    S, F = params.sv_hi.shape
    P = params.pair_coef.shape[0]
    if P > MAX_PAIRS:
        raise ValueError(
            f"the SVC kernel takes at most {MAX_PAIRS} pairs (6 classes), "
            f"got {P} ({params.n_classes} classes)"
        )
    if not 1 <= F <= MAX_FEATURES:
        raise ValueError(
            f"the SVC kernel takes 1..{MAX_FEATURES} features, got {F}"
        )
    dev = params.sv_hi.device
    coef_t = params.pair_coef.t().contiguous()
    records = torch.zeros((S, RECORD), dtype=torch.float32, device=dev)
    records[:, :F] = params.sv_hi
    records[:, LO_SLOT: LO_SLOT + F] = params.sv_lo
    records[:, COEF_SLOT: COEF_SLOT + P] = coef_t
    gamma_t = params.gamma.to(torch.float32)
    return SvcKernelOperands(
        records=records,
        sv_hi=params.sv_hi.contiguous(), sv_lo=params.sv_lo.contiguous(),
        coef_t=coef_t, gamma_t=gamma_t, gamma=float(gamma_t),
        intercept=params.intercept, vote_i=params.vote_i,
        vote_j=params.vote_j,
        n_sv=S, n_pairs=P, n_classes=params.n_classes, n_features=F,
    )


def _partial_plain(g: SvcKernelOperands, X, X_lo=None) -> torch.Tensor:
    d2 = svc.sq_dist(X, X_lo, g.sv_hi, g.sv_lo)
    return svc.decision_sum(torch.exp((-g.gamma_t) * d2), g.coef_t)


def partial_decision_plain(g: SvcKernelOperands, X, X_lo=None) -> torch.Tensor:
    """The plain PyTorch version of the kernel over 65,536-row slices:
    (N, P) decisions without the intercept, in the kernel's order."""
    if X_lo is None:
        return map_row_chunks(lambda xc: _partial_plain(g, xc), ROW_CHUNK, X)
    return map_row_chunks(
        lambda xc, xl: _partial_plain(g, xc, xl), ROW_CHUNK, X, X_lo
    )


@functools.cache
def _launcher():
    fn = cuda_build.load_library(KERNEL).rbf_decision_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,  # X, X_lo (or None)
        ctypes.c_int, ctypes.c_int,  # n_rows, n_features
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # records, S, P
        ctypes.c_float,  # gamma
        ctypes.c_int,  # rows per block
        ctypes.c_void_p, ctypes.c_void_p,  # out, stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(g: SvcKernelOperands, X: torch.Tensor, X_lo) -> None:
    for name, a in (("X", X), ("X_lo", X_lo)):
        if a is None:
            continue
        if a.dtype != torch.float32 or a.dim() != 2:
            raise ValueError(
                f"{name} must be (N, F) float32, got {a.dtype} {tuple(a.shape)}"
            )
        if a.shape != X.shape:
            raise ValueError(f"X_lo {tuple(a.shape)} != X {tuple(X.shape)}")
        if a.device != g.records.device:
            raise ValueError(
                f"{name} is on {a.device}, the SVC operands on "
                f"{g.records.device}"
            )
    if X.shape[1] != g.n_features:
        raise ValueError(
            f"X has {X.shape[1]} features, the support vectors {g.n_features}"
        )


def partial_decision(g: SvcKernelOperands, X: torch.Tensor,
                     X_lo=None) -> torch.Tensor:
    """(N, P) ``K @ coef`` with NO intercept. A CPU tensor goes to the
    plain version; a CUDA tensor launches the kernel on the current stream
    in ``launch_shape``, or raises."""
    _check(g, X, X_lo)
    if X.device.type == "cpu":
        return partial_decision_plain(g, X, X_lo)
    return _launch(g, X, X_lo, launch_shape(X.shape[0]))


def _launch(g: SvcKernelOperands, X: torch.Tensor, X_lo,
            rows_per_block: int) -> torch.Tensor:
    """Launches the kernel on the CUDA tensor ``X`` with ``rows_per_block``
    rows per block, and counts the launch in
    ``partial_decision.launches``. The card tests and
    ``tools/torch_kernel_sweep.py`` force each shape through it; the
    result does not depend on the shape."""
    _check(g, X, X_lo)
    if X.device.type != "cuda":
        raise ValueError(f"partial_decision runs on cpu or cuda, not {X.device}")
    if not X.is_contiguous() or (X_lo is not None and not X_lo.is_contiguous()):
        raise ValueError("X and X_lo must be contiguous")
    if X.shape[0] >= 2**31:
        raise ValueError("X has too many rows for the kernel's int32 index")
    if g.records.data_ptr() % 16:
        raise ValueError("support-vector records must be 16-byte aligned")
    out = torch.empty((X.shape[0], g.n_pairs), dtype=torch.float32,
                      device=X.device)
    if X.shape[0] == 0:
        return out
    if X.device.index == torch.cuda.current_device():
        rc = _call(g, X, X_lo, rows_per_block, out)
    else:
        with torch.cuda.device(X.device):
            rc = _call(g, X, X_lo, rows_per_block, out)
    if rc != 0:
        raise RuntimeError(f"rbf_decision kernel launch failed: CUDA error {rc}")
    partial_decision.launches += 1
    return out


def _call(g, X, X_lo, rows_per_block, out) -> int:
    # The raw handle of the current stream: building the Python Stream
    # object (torch.cuda.current_stream()) takes more host time than the
    # kernel takes at small N (tools/torch_kernel_sweep.py times both).
    stream = torch._C._cuda_getCurrentRawStream(X.device.index)
    return _launcher()(
        X.data_ptr(), None if X_lo is None else X_lo.data_ptr(),
        X.shape[0], X.shape[1],
        g.records.data_ptr(), g.n_sv, g.n_pairs, g.gamma,
        rows_per_block, out.data_ptr(), stream,
    )


partial_decision.launches = 0  # kernel launches (CUDA tensors only)


def decision_ovo(g: SvcKernelOperands, X: torch.Tensor, X_lo=None) -> torch.Tensor:
    """Per-pair ovo decision values, (N, P): the kernel's partial sums
    plus the intercept, added once."""
    return partial_decision(g, X, X_lo) + g.intercept[None, :]


def scores(g: SvcKernelOperands, X: torch.Tensor, X_lo=None) -> torch.Tensor:
    """Vote counts per class, (N, C) — the models/svc ovo aggregation."""
    return svc.votes_from_decision(
        decision_ovo(g, X, X_lo), g.vote_i, g.vote_j, g.n_classes
    )


def predict(g: SvcKernelOperands, X: torch.Tensor, X_lo=None) -> torch.Tensor:
    """(N,) int32 labels: argmax of the votes, ties to the lowest class."""
    return torch.argmax(scores(g, X, X_lo), dim=-1).to(torch.int32)
