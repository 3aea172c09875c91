"""RBF-kernel SVC predict — the torch port of
``traffic_classifier_sdn_tpu/models/svc.py``.

libsvm's ragged per-pair coefficients are flattened at import time into a
dense (P, S) matrix, so the one-vs-one decision is

    K = exp(−γ · ‖x − sv‖²)            (N, S)
    D = K · pair_coef.T + intercept     (N, P)
    votes: D[p] > 0 → class i(p), else class j(p); argmax of vote counts

with libsvm's tie-break (lowest class index among vote-count maxima).

Numerics: features reach ~8e8, so ‖x − sv‖² is taken in the two-float
difference form ``(x_hi − s_hi) + (x_lo − s_lo)`` (``split_hilo``), never
the dot expansion. The arithmetic runs in one fixed order, the order of
the CUDA kernel ``csrc/rbf_decision.cu`` (ops/rbf_kernel.py): d² summed
over features 0..F−1, then ``exp((−γ)·d²)``, then the decision summed over
support vectors in ascending order. This module is that kernel's plain
version, so the two agree bit for bit where their ``exp`` does. Against
JAX, whose sums are XLA reductions and a matmul in their own order, the
decisions agree to f32 reassociation (tests/test_torch_svc.py states the
tolerance).

Serving goes through ops/rbf_kernel.py. The dot-expansion form
(``TCSDN_SVC_KERNEL=dot`` in the JAX package) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.chunking import chunked_predict

ROW_CHUNK = 65536


def pairs(n_classes: int) -> list[tuple[int, int]]:
    """The one-vs-one pairs in libsvm order."""
    return [(i, j) for i in range(n_classes) for j in range(i + 1, n_classes)]


def split_hilo(X) -> tuple[np.ndarray, np.ndarray]:
    """Two-float split of a float64 array: X ≈ hi + lo with hi = f32(X)
    and lo = f32(X − hi) (numpy; a copy of the JAX package's f32 mode)."""
    X = np.asarray(X, dtype=np.float64)
    hi = X.astype(np.float32)
    lo = (X - hi).astype(np.float32)
    return hi, lo


def dense_pair_coef(dual_coef, n_support) -> np.ndarray:
    """(P, S) float64 dense ovo coefficients from libsvm's (C−1, S)
    ``dual_coef``: for pair (i, j), class-i SVs contribute ``dual[j−1]``
    and class-j SVs contribute ``dual[i]`` (libsvm's sv_coef layout)."""
    dual = np.asarray(dual_coef, dtype=np.float64)
    n_support = np.asarray(n_support, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(n_support)])
    prs = pairs(len(n_support))
    pair_coef = np.zeros((len(prs), dual.shape[1]), dtype=np.float64)
    for p, (i, j) in enumerate(prs):
        si, ei = starts[i], starts[i + 1]
        sj, ej = starts[j], starts[j + 1]
        pair_coef[p, si:ei] = dual[j - 1, si:ei]
        pair_coef[p, sj:ej] = dual[i, sj:ej]
    return pair_coef


def sq_dist(X, X_lo, sv_hi, sv_lo) -> torch.Tensor:
    """(N, S) ‖x − sv‖² in the two-float difference form, summed over
    features in ascending order. Without ``X_lo`` the difference is
    ``(x − s_hi) − s_lo``, bitwise ``(x − s_hi) + (0 − s_lo)``."""
    d2 = None
    for f in range(X.shape[1]):
        diff = X[:, f, None] - sv_hi[None, :, f]
        if X_lo is None:
            diff = diff - sv_lo[None, :, f]
        else:
            diff = diff + (X_lo[:, f, None] - sv_lo[None, :, f])
        sq = diff * diff
        d2 = sq if d2 is None else d2 + sq
    return d2


def decision_sum(K: torch.Tensor, coef_t: torch.Tensor) -> torch.Tensor:
    """(N, P) ``K @ coef_t`` with no intercept, summed over support
    vectors in ascending order from zero: ``acc = acc + K[:, s]·coef_t[s]``."""
    acc = torch.zeros((K.shape[0], coef_t.shape[1]), dtype=K.dtype,
                      device=K.device)
    for s in range(K.shape[1]):
        acc = acc + K[:, s, None] * coef_t[None, s]
    return acc


def votes_from_decision(D, vote_i, vote_j, n_classes: int) -> torch.Tensor:
    """(N, C) ovo vote counts in D's dtype — the one home of the libsvm
    vote semantics (the model and the kernel wrapper both call it)."""
    onehot_i = nn.functional.one_hot(vote_i.long(), n_classes).to(D.dtype)
    onehot_j = nn.functional.one_hot(vote_j.long(), n_classes).to(D.dtype)
    pos = (D > 0)[:, :, None]
    return torch.where(pos, onehot_i, onehot_j).sum(dim=1)


class SvcModel(nn.Module):
    STATIC_FIELDS = ("n_classes", "has_lo")  # non-array checkpoint fields

    def __init__(self, sv_hi, sv_lo, pair_coef, intercept, vote_i, vote_j,
                 gamma, n_classes: int, has_lo: bool = True):
        super().__init__()
        self.register_buffer("sv_hi", sv_hi)  # (S, F) f32
        self.register_buffer("sv_lo", sv_lo)  # (S, F) f32 residual
        self.register_buffer("pair_coef", pair_coef)  # (P, S) f32
        self.register_buffer("intercept", intercept)  # (P,) f32
        self.register_buffer("vote_i", vote_i)  # (P,) int32
        self.register_buffer("vote_j", vote_j)  # (P,) int32
        self.register_buffer("gamma", gamma)  # () f32
        self.n_classes = int(n_classes)
        self.has_lo = bool(has_lo)

    @classmethod
    def from_numpy(cls, d, device=None) -> "SvcModel":
        """Build from an importer dict (``support_vectors``, ``dual_coef``,
        ``n_support``, ``intercept``, ``gamma``) on ``device`` (default
        CUDA, see device.py). The dense coefficients are built in float64
        and rounded once to float32, as in the JAX ``from_numpy``."""
        device = resolve_device(device)
        n_classes = len(np.asarray(d["n_support"]))
        prs = pairs(n_classes)
        sv_hi, sv_lo = split_hilo(d["support_vectors"])
        pair_coef = dense_pair_coef(d["dual_coef"], d["n_support"])

        def t(a, dtype):  # a copy: the caller's arrays may be read-only
            return torch.tensor(np.asarray(a), dtype=dtype, device=device)

        return cls(
            sv_hi=t(sv_hi, torch.float32),
            sv_lo=t(sv_lo, torch.float32),
            pair_coef=t(pair_coef.astype(np.float32), torch.float32),
            intercept=t(np.asarray(d["intercept"], np.float64).astype(
                np.float32), torch.float32),
            vote_i=t([i for i, _ in prs], torch.int32),
            vote_j=t([j for _, j in prs], torch.int32),
            gamma=t(np.float32(d["gamma"]), torch.float32),
            n_classes=n_classes,
            has_lo=bool(np.any(sv_lo)),
        )

    def rbf_kernel(self, X: torch.Tensor, X_lo=None) -> torch.Tensor:
        """(N, S) ``exp((−γ)·d²)``, difference form with optional lo part."""
        d2 = sq_dist(X, X_lo, self.sv_hi, self.sv_lo)
        return torch.exp((-self.gamma) * d2)

    def decision_ovo(self, X: torch.Tensor, X_lo=None) -> torch.Tensor:
        """Per-pair ovo decision values, (N, P)."""
        K = self.rbf_kernel(X, X_lo)
        return decision_sum(K, self.pair_coef.t()) + self.intercept[None, :]

    def _votes_from_decision(self, D: torch.Tensor) -> torch.Tensor:
        return votes_from_decision(D, self.vote_i, self.vote_j, self.n_classes)

    def scores(self, X: torch.Tensor, X_lo=None) -> torch.Tensor:
        """Vote counts per class, (N, C)."""
        return self._votes_from_decision(self.decision_ovo(X, X_lo))

    def predict(self, X: torch.Tensor, X_lo=None) -> torch.Tensor:
        return torch.argmax(self.scores(X, X_lo), dim=-1).to(torch.int32)

    def predict_scores(self, X: torch.Tensor, X_lo=None):
        """(labels, vote-count scores) from one decision computation;
        ``argmax(scores) == predict`` by construction."""
        votes = self.scores(X, X_lo)
        return torch.argmax(votes, dim=-1).to(torch.int32), votes

    def predict_chunked(self, X: torch.Tensor, X_lo=None,
                        row_chunk: int = ROW_CHUNK) -> torch.Tensor:
        """``predict`` over ``row_chunk``-row slices: the (N, S) kernel
        matrix of 2²⁰ rows against 2281 SVs would be 9.5 GB."""
        return chunked_predict(self.predict, row_chunk, X, X_lo)

    def forward(self, X: torch.Tensor, X_lo=None) -> torch.Tensor:
        return self.predict(X, X_lo)
