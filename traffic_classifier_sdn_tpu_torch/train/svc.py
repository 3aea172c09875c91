"""RBF-SVC training by batched one-vs-one dual ascent — the torch port of
``traffic_classifier_sdn_tpu/train/svc.py`` and of its single-device
``train/distributed.fit_svc``.

The JAX package's reformulation of libsvm's SMO:

- the intercept's equality constraint ``Σ tᵃαᵃ = 0`` goes away by
  augmenting the kernel with a constant (``K+1``): the dual is a pure
  box-constrained QP, ``max Σα − ½αᵀQα, 0 ≤ α ≤ C`` with
  ``Q = ttᵀ ⊙ (K+1)``, and the intercept is ``b = Σ tᵃαᵃ``;
- each of the C·(C−1)/2 pairs is solved by projected gradient ascent
  with Nesterov momentum (FISTA), step 1/λmax from power iteration;
- the pairs are padded to the largest one.

The full train-set kernel is the two-float (hi/lo) difference form
(models/svc.py: raw features reach ~8e8, where the dot expansion of
‖x−s‖² cancels in float32), row-chunked. Here the pairs' solves run
together as one batched matvec per iteration (JAX maps them one after
another), on the given device, float32 with TF32 off. The result packs
into the port's ``SvcModel`` (dense per-pair coefficients over the
support vectors), which the CUDA RBF kernel serves.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.svc import SvcModel, split_hilo


def rbf_kernel_matrix(X: np.ndarray, gamma: float, device,
                      chunk: int = 256) -> torch.Tensor:
    """Full (N, N) RBF kernel, float32, hi/lo-exact distances, row-chunked."""
    hi, lo = (torch.from_numpy(a).to(device) for a in split_hilo(X))
    g = torch.tensor(gamma, dtype=torch.float32, device=device)
    blocks = []
    for s in range(0, hi.shape[0], chunk):
        bh, bl = hi[s:s + chunk], lo[s:s + chunk]
        diff = (bh[:, None, :] - hi[None, :, :]) + (bl[:, None, :]
                                                    - lo[None, :, :])
        blocks.append(torch.exp(-g * (diff * diff).sum(-1)))
    return torch.cat(blocks)


def solve_pairs(K: torch.Tensor, idx: torch.Tensor, t: torch.Tensor,
                Cbox: torch.Tensor, *, n_iters: int,
                power_iters: int) -> torch.Tensor:
    """FISTA on every padded ovo box QP at once; returns α (P, Smax)."""
    Kp = K[idx[:, :, None], idx[:, None, :]] + 1.0  # (P, S, S) augmented
    valid = t != 0.0

    def matvec(v):
        return t * torch.bmm(Kp, (t * v)[:, :, None])[:, :, 0]

    def unit(v):
        return v / torch.clamp(torch.linalg.vector_norm(v, dim=1,
                                                        keepdim=True),
                               min=1e-12)

    # power iteration for λmax(Q) → the step size (the norm guard keeps
    # an all-padding pair NaN-free; its α clamps to the [0, 0] box)
    v = unit(valid.to(torch.float32))
    for _ in range(power_iters):
        v = unit(matvec(v))
    lam = (v * matvec(v)).sum(1, keepdim=True)
    eta = 1.0 / torch.clamp(lam, min=1e-6)
    a = z = torch.zeros_like(t)
    for i in range(n_iters):
        g = 1.0 - matvec(z)  # ∇ of Σα − ½αᵀQα at the momentum point
        a_new = torch.minimum(torch.clamp(z + eta * g, min=0.0), Cbox)
        beta = i / (i + 3.0)
        z = a_new + beta * (a_new - a)
        a = a_new
    return a


def prepare_ovo(X, y, n_classes: int, C: float, gamma, device) -> dict:
    """Problem setup: resolve gamma, build the (N, N) kernel, and pack the
    padded per-pair (index, target, box) operands."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.int32)
    N, F = X.shape
    if gamma == "scale":  # sklearn: 1 / (F · Var(X))
        gamma = 1.0 / (F * X.var())
    gamma = float(gamma)
    K = rbf_kernel_matrix(X, gamma, device)
    pairs = [(i, j) for i in range(n_classes)
             for j in range(i + 1, n_classes)]
    members = [np.nonzero((y == i) | (y == j))[0] for i, j in pairs]
    Smax = max(len(m) for m in members)
    idx_all = np.zeros((len(pairs), Smax), np.int64)
    t_all = np.zeros((len(pairs), Smax), np.float32)
    for p, ((i, j), m) in enumerate(zip(pairs, members)):
        idx_all[p, : len(m)] = m
        t_all[p, : len(m)] = np.where(y[m] == i, 1.0, -1.0)
    Cbox_all = np.where(t_all != 0.0, np.float32(C), np.float32(0.0))
    return {
        "X": X, "gamma": gamma, "K": K, "pairs": pairs,
        "members": members, "idx": idx_all, "t": t_all, "Cbox": Cbox_all,
    }


def pack_params(prob: dict, alphas: np.ndarray, n_classes: int,
                sv_tol: float, device) -> SvcModel:
    """Dense (P, N) signed coefficients and the recovered intercepts →
    ``SvcModel`` over the support vectors (|coef| above ``sv_tol``)."""
    pairs, members, t_all = prob["pairs"], prob["members"], prob["t"]
    X = prob["X"]
    coef_dense = np.zeros((len(pairs), X.shape[0]), np.float64)
    at = np.asarray(alphas, np.float64)[: len(pairs)] * t_all
    for p in range(len(pairs)):
        m = members[p]
        coef_dense[p, m] = at[p, : len(m)]
    intercept = at.sum(axis=1)  # b from the K+1 augmentation
    sv_idx = np.nonzero(np.abs(coef_dense).max(axis=0) > sv_tol)[0]
    sv_hi, sv_lo = split_hilo(X[sv_idx])

    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return SvcModel(
        sv_hi=t(sv_hi, torch.float32),
        sv_lo=t(sv_lo, torch.float32),
        pair_coef=t(coef_dense[:, sv_idx].astype(np.float32), torch.float32),
        intercept=t(intercept.astype(np.float32), torch.float32),
        vote_i=t([i for i, _ in pairs], torch.int32),
        vote_j=t([j for _, j in pairs], torch.int32),
        gamma=t(np.float32(prob["gamma"]), torch.float32),
        n_classes=n_classes,
        has_lo=True,
    )


def fit(X, y, n_classes: int, *, C: float = 1.0,
        gamma: float | str = "scale", n_iters: int = 800,
        power_iters: int = 24, sv_tol: float = 1e-6,
        device=None) -> SvcModel:
    """Fit ovo RBF-SVC on ``device`` (default CUDA, see device.py)."""
    device = resolve_device(device)
    prob = prepare_ovo(X, y, n_classes, C, gamma, device)
    alphas = solve_pairs(
        prob["K"], torch.from_numpy(prob["idx"]).to(device),
        torch.from_numpy(prob["t"]).to(device),
        torch.from_numpy(prob["Cbox"]).to(device),
        n_iters=n_iters, power_iters=power_iters,
    )
    return pack_params(prob, alphas.cpu().numpy(), n_classes, sv_tol, device)
