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
descending sort of the similarities' total-order keys
(``total_order_key``), which orders by (value desc, index asc) with −0
below +0 and NaNs at the ends by sign — the order of ``lax.top_k``.
``torch.topk`` promises no tie order and is not used.

The exact top-k tiers of the JAX package's ``--knn-topk`` menu are here
too (``TOP_K_TIERS``), each with its JAX tier's order semantics:
``argmax`` (k ``torch.argmax`` + −inf mask passes: IEEE compares, so +0
equals −0 and the first NaN wins, as ``jnp.argmax`` does; the JAX tier
assumes finite similarities), ``hier[<group>]`` and
``screened[<group>]`` (``topk_stable`` wherever JAX calls
``lax.top_k``, ``torch.amax`` where it calls ``jnp.max``, a stable
ascending sort of the survivor groups). The approximate ``ivf`` tier is
ops/knn_ivf.py; the big-corpus scan is not ported.
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


def total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys of float32 values that order as the IEEE total order
    does (+NaN > +inf > … > +0 > −0 > … > −inf > −NaN, NaNs by payload):
    a negative value's magnitude bits are flipped, so its key falls as
    its magnitude grows. The map is its own inverse."""
    bits = x.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def topk_stable(sim: torch.Tensor, k: int):
    """((N, k) values, (N, k) int32 indices) of the k largest columns by
    (total-order key desc, index asc) — ``lax.top_k``'s order, signed
    zeros and NaNs included, so every row gets k real indices."""
    if sim.shape[1] < k:
        raise ValueError(f"corpus has {sim.shape[1]} rows < n_neighbors={k}")
    _, idx = torch.sort(total_order_key(sim), dim=1, descending=True,
                        stable=True)
    idx = idx[:, :k]
    return torch.gather(sim, 1, idx), idx.to(torch.int32)


def topk_argmax_idx(sim: torch.Tensor, k: int) -> torch.Tensor:
    """(N, k) int32 indices of the k largest columns, descending, ties to
    the lowest index — k ``torch.argmax`` + −inf mask passes (JAX
    ``models/knn._topk_argmax_idx``). Equal to ``topk_stable`` on finite
    rows without signed zeros: the argmax compares as IEEE does, so +0
    and −0 tie, and a NaN wins over every number."""
    sim = sim.clone()
    idxs = []
    for _ in range(k):
        best = torch.argmax(sim, dim=1)  # the first (lowest-index) maximum
        idxs.append(best)
        sim.scatter_(1, best[:, None], float("-inf"))
    return torch.stack(idxs, dim=1).to(torch.int32)


def _pad_groups(sim: torch.Tensor, group: int) -> tuple[torch.Tensor, int]:
    """(sim padded with −inf columns to a multiple of ``group``, groups)."""
    G = -(-sim.shape[1] // group)
    pad = G * group - sim.shape[1]
    if pad:
        sim = nn.functional.pad(sim, (0, pad), value=float("-inf"))
    return sim, G


def topk_hier_idx(sim: torch.Tensor, k: int, group: int = 128) -> torch.Tensor:
    """(N, k) int32 indices of the k largest columns — a ``topk_stable``
    over each ``group``-column tile, then one over the G·k survivors (JAX
    ``models/knn._topk_hier_idx``). Tiles are contiguous index ranges and
    the merge sees candidates in (tile, rank) order, so the result is
    ``topk_stable`` over the full row, tie order included; −inf padding
    loses to every real column but a −NaN, as in ``lax.top_k``."""
    n = sim.shape[0]
    if k > group:
        raise ValueError(f"k={k} must be <= group={group}")
    sim, G = _pad_groups(sim, group)
    vals_g, idx_g = topk_stable(sim.reshape(n * G, group), k)
    base = (torch.arange(G, device=sim.device) * group)[None, :, None]
    gidx = (idx_g.long().reshape(n, G, k) + base).reshape(n, G * k)
    _, sel = topk_stable(vals_g.reshape(n, G * k), k)
    return torch.gather(gidx, 1, sel.long()).to(torch.int32)


def topk_screened_idx(sim: torch.Tensor, k: int,
                      group: int = 32) -> torch.Tensor:
    """(N, k) int32 indices of the k largest columns — bound-screened
    group selection (JAX ``models/knn._topk_screened_idx``): the group
    maxima (``torch.amax``, with ``jnp.max``'s +0 over −0) pick the k survivor groups by
    ``topk_stable``, the survivors are sorted ascending so gathered
    position order is global index order, and one ``topk_stable`` ranks
    their k·group columns. Exact on finite rows, the JAX tier's
    precondition; with fewer than k groups, the full ``topk_stable``."""
    n = sim.shape[0]
    if -(-sim.shape[1] // group) < k:
        return topk_stable(sim, k)[1]
    sim, G = _pad_groups(sim, group)
    grp = sim.reshape(n, G, group)
    gmax = torch.amax(grp, dim=2)  # (N, G) bounds; NaN propagates
    # jnp.max orders +0 above −0 (IEEE maximum); amax may return either
    plus_zero = (grp.view(torch.int32) == 0).any(dim=2)
    gmax = torch.where((gmax == 0) & plus_zero, torch.zeros_like(gmax), gmax)
    gsel = torch.sort(topk_stable(gmax, k)[1].long(), dim=1).values
    cand = (gsel[:, :, None] * group
            + torch.arange(group, device=sim.device)[None, None, :]
            ).reshape(n, k * group)
    _, sel = topk_stable(torch.gather(sim, 1, cand), k)
    return torch.gather(cand, 1, sel.long()).to(torch.int32)


def neighbor_idx(sim: torch.Tensor, k: int,
                 top_k_impl: str = "sort") -> torch.Tensor:
    """(N, k) int32 neighbor indices of ``sim`` by the named tier: ``sort``,
    ``argmax``, ``hier`` / ``hier<group>`` (default 128) or ``screened`` /
    ``screened<group>`` (default 32)."""
    if top_k_impl == "sort":
        return topk_stable(sim, k)[1]
    if top_k_impl == "argmax":
        return topk_argmax_idx(sim, k)
    if top_k_impl.startswith("hier"):
        return topk_hier_idx(sim, k, group=int(top_k_impl[4:] or 128))
    if top_k_impl.startswith("screened"):
        return topk_screened_idx(sim, k, group=int(top_k_impl[8:] or 32))
    raise ValueError(f"unknown top_k_impl {top_k_impl!r}")


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
        """(N, C) neighbor counts per class from the k nearest rows, ranked
        by the ``top_k_impl`` tier (``neighbor_idx``)."""
        idx = neighbor_idx(self._neighbor_sim(X, X_lo), self.n_neighbors,
                           top_k_impl)
        return count_votes(self.fit_y, self.n_classes, idx)

    def scores(self, X: torch.Tensor, X_lo=None) -> torch.Tensor:
        return self.neighbor_votes(X, X_lo)

    def predict(self, X: torch.Tensor, X_lo=None,
                top_k_impl: str = "sort") -> torch.Tensor:
        return torch.argmax(self.neighbor_votes(X, X_lo, top_k_impl),
                            dim=-1).to(torch.int32)

    def predict_scores(self, X: torch.Tensor, X_lo=None,
                       top_k_impl: str = "sort"):
        """(labels, neighbor-vote scores) from one vote computation;
        ``argmax(scores) == predict`` by construction."""
        votes = self.neighbor_votes(X, X_lo, top_k_impl)
        return torch.argmax(votes, dim=-1).to(torch.int32), votes

    def predict_chunked(self, X: torch.Tensor, X_lo=None,
                        row_chunk: int = ROW_CHUNK,
                        top_k_impl: str = "sort") -> torch.Tensor:
        """``predict`` over ``row_chunk``-row slices: the (N, S) similarity
        of 2²⁰ rows against 4448 corpus rows would be 18.6 GB."""
        return chunked_predict(
            lambda xc, xlo=None: self.predict(xc, xlo, top_k_impl),
            row_chunk, X, X_lo,
        )

    def forward(self, X: torch.Tensor, X_lo=None) -> torch.Tensor:
        return self.predict(X, X_lo)


def serve_predict(params: KnnModel, X: torch.Tensor, X_lo=None,
                  top_k_impl: str = "sort") -> torch.Tensor:
    """The ``(params, X)`` serving predict of a ``top_k_impl`` tier:
    ``predict_chunked`` (the ``--knn-topk argmax|hier|screened`` serve)."""
    return params.predict_chunked(X, X_lo, top_k_impl=top_k_impl)
