"""IVF (inverted-file) approximate KNN — the torch port of
``traffic_classifier_sdn_tpu/ops/knn_ivf.py``, the ``--knn-topk ivf``
tier.

The corpus is partitioned by a coarse k-means quantizer (train/kmeans.py,
K ≈ √S lists), and a query ranks only the members of its ``nprobe``
nearest lists instead of all S corpus rows. This is an APPROXIMATE tier:
a true neighbor whose list is not probed is missed, so it serves only
behind the explicit opt-in, never in place of an exact tier.

- ``nprobe >= n_lists`` is the exact search bit for bit: the lists
  partition the corpus, the candidates are sorted into ascending corpus
  order before the final ``topk_stable``, so ties resolve to the lowest
  corpus index, the full-row rule.
- The ranking values are the exact tiers' similarities
  (``models/knn.dot_expansion_sim``, the KNN kernel's arithmetic).
- The probe ranks centroids by the difference-form distance, summed over
  features in ascending order (the dot expansion cancels at this data's
  ~8e8 feature scale); it decides only which lists are searched.
- Padding in ``list_idx`` is S, one past the end: its similarity column
  is −inf and its label −1, so it never votes.

The native C++ evaluator mirrors the tier on the same partition
(``NativeKnn.build_ivf`` / ``predict_ivf``); the serve resolves the
opt-in to it wherever g++ builds it (models/__init__.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models import knn
from .chunking import chunked_predict

# the smallest nprobe that clears a 0.99 recall@1 on the JAX package's
# reference-scale sweep; ``ivf<n>`` serves another
DEFAULT_NPROBE = 2
ROW_CHUNK = 16384  # rows per serving chunk: (N, S) sims + (N, nprobe·L) gathers


def default_n_clusters(n_rows: int) -> int:
    """K ≈ √S — the IVF balance between probe cost (∝ K) and list-scan
    cost (∝ S/K per probed list)."""
    return max(1, int(round(float(n_rows) ** 0.5)))


@dataclass(frozen=True)
class IvfParams:
    """The serving bundle: the exact corpus model and the coarse index.
    ``list_idx`` rows hold ascending corpus indices padded with S."""

    base: knn.KnnModel
    centers: torch.Tensor  # (K, F) f32 coarse quantizer
    list_idx: torch.Tensor  # (K, L) int32 member corpus indices, pad = S
    nprobe: int

    @property
    def n_lists(self) -> int:
        return int(self.centers.shape[0])


def assignments(fit_X, centers) -> np.ndarray:
    """(S,) int32 nearest-centroid ids — float64 difference form on the
    host, lowest-index ties (np.argmin), 1,024 rows at a time. The torch
    list build and the native mirror share it, so both hold the same
    partition."""
    fx = np.asarray(fit_X, np.float64)
    ce = np.asarray(centers, np.float64)
    out = np.empty(fx.shape[0], np.int32)
    for lo in range(0, fx.shape[0], 1024):
        d2 = ((fx[lo:lo + 1024, None, :] - ce[None, :, :]) ** 2).sum(-1)
        out[lo:lo + 1024] = np.argmin(d2, axis=1)
    return out


def assignments_of(ivf: IvfParams) -> np.ndarray:
    """(S,) int32 assignments read back from the built lists (no distance
    recompute): how the serve hands the native mirror the same partition."""
    list_idx = ivf.list_idx.cpu().numpy()
    S = int(ivf.base.fit_X.shape[0])
    out = np.empty(S, np.int32)
    for c in range(list_idx.shape[0]):
        members = list_idx[c][list_idx[c] < S]
        out[members] = c
    return out


def build(params: knn.KnnModel, *, n_clusters: int | None = None,
          nprobe: int = DEFAULT_NPROBE, seed: int = 0,
          n_init: int = 4, n_iter: int = 25) -> IvfParams:
    """Fit the coarse quantizer on the corpus (train/kmeans.py, on the
    model's device, seeded) and assemble the serving bundle."""
    from ..train import kmeans as tkmeans

    if nprobe < 1:
        raise ValueError(f"nprobe={nprobe} must be >= 1")
    S = int(params.fit_X.shape[0])
    K = n_clusters if n_clusters is not None else default_n_clusters(S)
    K = max(1, min(int(K), S))
    kparams, _ = tkmeans.fit(params.fit_X, k=K, n_init=n_init,
                             n_iter=n_iter, seed=seed)
    centers = kparams.centers.cpu().numpy()
    lists: list[list[int]] = [[] for _ in range(K)]
    for s, c in enumerate(assignments(params.fit_X.cpu().numpy(), centers)):
        lists[int(c)].append(s)  # ascending s → ascending per list
    L = max(1, max(len(li) for li in lists))
    list_idx = np.full((K, L), S, np.int32)  # pad = S sentinel
    for c, li in enumerate(lists):
        list_idx[c, : len(li)] = li
    device = params.fit_X.device
    return IvfParams(
        base=params,
        centers=torch.tensor(centers, device=device),
        list_idx=torch.tensor(list_idx, device=device),
        nprobe=int(min(nprobe, K)),
    )


def _nprobe(ivf: IvfParams, nprobe: int | None) -> int:
    n = ivf.nprobe if nprobe is None else int(nprobe)
    return max(1, min(n, ivf.n_lists))


def _probe_lists(ivf: IvfParams, X: torch.Tensor, nprobe: int):
    """(N, nprobe) probed list ids: nearest centroids by the difference
    form, ties to the lowest centroid index."""
    d2 = None
    for f in range(X.shape[1]):
        diff = X[:, f, None] - ivf.centers[None, :, f]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    return knn.topk_stable(-d2, nprobe)[1]


def _candidates(ivf: IvfParams, X: torch.Tensor, nprobe: int | None):
    """((N, nprobe·L) candidate corpus indices, ascending, padding S last;
    their similarities, −inf on padding)."""
    p = ivf.base
    n = X.shape[0]
    sim = knn.dot_expansion_sim(X, p.fit_X, p.half_sq_norms)
    psel = _probe_lists(ivf, X, _nprobe(ivf, nprobe))
    cand = ivf.list_idx[psel.long()].reshape(n, -1).long()
    cand = torch.sort(cand, dim=1).values
    simp = torch.cat([sim, sim.new_full((n, 1), float("-inf"))], dim=1)
    return cand, torch.gather(simp, 1, cand)


def neighbor_votes_ivf(ivf: IvfParams, X: torch.Tensor,
                       nprobe: int | None = None) -> torch.Tensor:
    """(N, C) int32 neighbor votes over the probed lists only. A probe set
    holding fewer than k real candidates votes over the real ones only:
    the padding's label is −1, which counts for no class."""
    p = ivf.base
    cand, vals = _candidates(ivf, X, nprobe)
    _, sel = knn.topk_stable(vals, p.n_neighbors)
    nbr = torch.gather(cand, 1, sel.long())  # (N, k), may hold S
    fit_y = torch.cat([p.fit_y.long(), p.fit_y.new_full((1,), -1).long()])
    nbr_y = fit_y[nbr]
    classes = torch.arange(p.n_classes, device=X.device)
    return (nbr_y[:, :, None] == classes).sum(dim=1).to(torch.int32)


def predict(ivf: IvfParams, X: torch.Tensor,
            nprobe: int | None = None) -> torch.Tensor:
    """(N,) int32 labels through the IVF tier."""
    return torch.argmax(neighbor_votes_ivf(ivf, X, nprobe),
                        dim=-1).to(torch.int32)


def predict_scores(ivf: IvfParams, X: torch.Tensor,
                   nprobe: int | None = None):
    """(labels, neighbor-vote scores) from one vote computation."""
    votes = neighbor_votes_ivf(ivf, X, nprobe)
    return torch.argmax(votes, dim=-1).to(torch.int32), votes


def predict_chunked(ivf: IvfParams, X: torch.Tensor, X_lo=None,
                    row_chunk: int = ROW_CHUNK) -> torch.Tensor:
    """The ``(params, X)`` serving predict: ``predict`` over
    ``row_chunk``-row slices. ``X_lo`` is ignored: the tier ranks by the
    float32 similarity by definition."""
    del X_lo
    return chunked_predict(lambda xc: predict(ivf, xc), row_chunk, X)


def exact_top1(params: knn.KnnModel, X: torch.Tensor) -> torch.Tensor:
    """(N,) the exact nearest corpus index (first maximum of the
    similarity) — the recall@1 reference."""
    sim = knn.dot_expansion_sim(X, params.fit_X, params.half_sq_norms)
    return torch.argmax(sim, dim=1).to(torch.int32)


def ivf_top1(ivf: IvfParams, X: torch.Tensor,
             nprobe: int | None = None) -> torch.Tensor:
    """(N,) the IVF tier's nearest corpus index."""
    cand, vals = _candidates(ivf, X, nprobe)
    best = torch.argmax(vals, dim=1)
    return torch.gather(cand, 1, best[:, None])[:, 0].to(torch.int32)


def recall_at_1(ivf: IvfParams, X: torch.Tensor,
                nprobe: int | None = None) -> float:
    """Fraction of queries whose IVF top-1 neighbor is the exact top-1
    (1.0 at ``nprobe >= n_lists`` by construction)."""
    a = ivf_top1(ivf, X, nprobe)
    b = exact_top1(ivf.base, X)
    return int((a == b).sum()) / max(1, a.shape[0])
