"""k-nearest-neighbors predict — the torch port of
``traffic_classifier_sdn_tpu/models/knn.py``: brute-force similarity
against the whole corpus, the k most similar rows, and a one-hot vote
(ties to the lowest class index).

The similarity is the dot expansion ``x·s − ½‖s‖²`` (argmax order ==
ascending-distance order; ‖x‖² is constant along a row), or, given
``X_lo``, the exact two-float difference form ``−‖(x−s) + (x_lo−s_lo)‖²``.
Both are summed over features in ascending order with every product and
sum rounded on its own (``acc = x0·s0; acc = acc + x1·s1; …``): the order
of the CUDA kernel ``csrc/knn_topk.cu`` (ops/knn_kernel.py), so this
module is that kernel's plain version. The top-k is a *stable*
descending sort, which orders by (value desc, index asc) — the order of
``lax.top_k``. ``torch.topk`` promises no tie order and is not used.

Only the exact ``sort`` tier of the JAX package is ported; its
``argmax``/``hier``/``screened``/``native``/``ivf`` tiers and the
big-corpus scan are not.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.chunking import chunked_predict
from .svc import split_hilo

ROW_CHUNK = 65536


def half_sq_norms(fit_X: torch.Tensor) -> torch.Tensor:
    """(S,) ½‖s‖², the squares summed over features in ascending order."""
    acc = fit_X[:, 0] * fit_X[:, 0]
    for f in range(1, fit_X.shape[1]):
        acc = acc + fit_X[:, f] * fit_X[:, f]
    return 0.5 * acc


def dot_expansion_sim(X: torch.Tensor, fit_X: torch.Tensor,
                      half_sq: torch.Tensor) -> torch.Tensor:
    """(N, S) ``x·s − ½‖s‖²`` in the kernel's order — the one place the
    expression lives (the model and the kernel's plain version call it)."""
    acc = X[:, 0, None] * fit_X[None, :, 0]
    for f in range(1, X.shape[1]):
        acc = acc + X[:, f, None] * fit_X[None, :, f]
    return acc - half_sq[None, :]


def topk_stable(sim: torch.Tensor, k: int):
    """((N, k) values, (N, k) int32 indices) of the k largest columns by
    (value desc, index asc) — ``lax.top_k``'s order."""
    if sim.shape[1] < k:
        raise ValueError(f"corpus has {sim.shape[1]} rows < n_neighbors={k}")
    vals, idx = torch.sort(sim, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k].to(torch.int32)


def count_votes(fit_y: torch.Tensor, n_classes: int,
                nbr_idx: torch.Tensor) -> torch.Tensor:
    """(N, C) int32 class counts of the given (N, k) neighbor indices —
    the one home of the vote semantics (ops/knn_kernel.py shares it)."""
    nbr_y = fit_y[nbr_idx.long()].long()
    return nn.functional.one_hot(nbr_y, n_classes).sum(dim=1).to(torch.int32)


class KnnModel(nn.Module):
    STATIC_FIELDS = ("n_neighbors", "n_classes")  # non-array checkpoint fields

    def __init__(self, fit_X, fit_X_lo, fit_y, half_sq_norms,
                 n_neighbors: int, n_classes: int):
        super().__init__()
        self.register_buffer("fit_X", fit_X)  # (S, F) f32, hi part
        self.register_buffer("fit_X_lo", fit_X_lo)  # (S, F) f32 residual
        self.register_buffer("fit_y", fit_y)  # (S,) int32
        self.register_buffer("half_sq_norms", half_sq_norms)  # (S,) f32
        self.n_neighbors = int(n_neighbors)
        self.n_classes = int(n_classes)

    @classmethod
    def from_numpy(cls, d, device=None) -> "KnnModel":
        """Build from an importer dict (``fit_X``, ``y``, ``n_neighbors``,
        ``classes``) on ``device`` (default CUDA, see device.py).
        ``half_sq_norms`` is computed here in the fixed order of
        ``half_sq_norms``; a model carried over from JAX keeps JAX's
        (interop.knn_params_from_numpy)."""
        device = resolve_device(device)
        hi, lo = split_hilo(d["fit_X"])
        fit_X = torch.tensor(hi, device=device)
        return cls(
            fit_X=fit_X,
            fit_X_lo=torch.tensor(lo, device=device),
            fit_y=torch.tensor(np.asarray(d["y"]), dtype=torch.int32,
                               device=device),
            half_sq_norms=half_sq_norms(fit_X),
            n_neighbors=int(d["n_neighbors"]),
            n_classes=len(d["classes"]),
        )

    def _neighbor_sim(self, X: torch.Tensor, X_lo=None) -> torch.Tensor:
        """(N, S) similarity whose argmax order is ascending distance."""
        if X_lo is None:
            return dot_expansion_sim(X, self.fit_X, self.half_sq_norms)
        d2 = None
        for f in range(X.shape[1]):
            diff = (X[:, f, None] - self.fit_X[None, :, f]) + (
                X_lo[:, f, None] - self.fit_X_lo[None, :, f]
            )
            sq = diff * diff
            d2 = sq if d2 is None else d2 + sq
        return -d2

    def neighbor_votes(self, X: torch.Tensor, X_lo=None,
                       top_k_impl: str = "sort") -> torch.Tensor:
        """(N, C) neighbor counts per class from the k nearest rows."""
        if top_k_impl != "sort":
            raise ValueError(
                f"top_k_impl {top_k_impl!r} is not ported (only 'sort')"
            )
        _, idx = topk_stable(self._neighbor_sim(X, X_lo), self.n_neighbors)
        return count_votes(self.fit_y, self.n_classes, idx)

    def scores(self, X: torch.Tensor, X_lo=None) -> torch.Tensor:
        return self.neighbor_votes(X, X_lo)

    def predict(self, X: torch.Tensor, X_lo=None) -> torch.Tensor:
        return torch.argmax(self.neighbor_votes(X, X_lo), dim=-1).to(torch.int32)

    def predict_scores(self, X: torch.Tensor, X_lo=None):
        """(labels, neighbor-vote scores) from one vote computation;
        ``argmax(scores) == predict`` by construction."""
        votes = self.neighbor_votes(X, X_lo)
        return torch.argmax(votes, dim=-1).to(torch.int32), votes

    def predict_chunked(self, X: torch.Tensor, X_lo=None,
                        row_chunk: int = ROW_CHUNK) -> torch.Tensor:
        """``predict`` over ``row_chunk``-row slices: the (N, S) similarity
        of 2²⁰ rows against 4448 corpus rows would be 18.6 GB."""
        return chunked_predict(self.predict, row_chunk, X, X_lo)

    def forward(self, X: torch.Tensor, X_lo=None) -> torch.Tensor:
        return self.predict(X, X_lo)
