"""State-sharded RBF-SVC: the support vectors split over the mesh's state
axis, partial one-vs-one decisions summed across shards — the port of
``traffic_classifier_sdn_tpu/parallel/svc_sharded.py``.

Each shard computes the RBF kernel block against its support vectors and
the partial pair decision ``K_local @ coef_localᵀ``, an (N, P) matrix; the
partials are added in shard order on the first shard's device (JAX's
``psum``), the intercept is added once, and the votes run there. The same
two-float difference form as models/svc.py. ``fused_predict`` takes the
local stage to the port's CUDA RBF kernel (ops/rbf_kernel.py): one launch
per SV shard, on the JAX layout — ``per`` SVs a shard, rounded up to whole
512-SV chunks, padding with zero coefficients, so a shard may add nothing
but zeros.

The f32 sum over support vectors runs in another order than one
device's, so decision values agree with the un-sharded ones to the
tolerance ``tests/test_torch_svc.py`` states (1e-5 of the largest
coefficient sum), and labels exactly wherever the smallest |decision|
exceeds it. On a mesh spanning processes each rank computes only its own
SV shards (the RBF kernel once per owned shard, padding shards too) and
the (N, P) partials cross through ``mesh.shard_sum``: every rank adds the
same host copies in shard order on its first shard's device, so its
decisions are the one-process mesh's bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import svc
from ..ops import rbf_kernel
from .mesh import STATE_AXIS, shard_sum, to_device


def pad_support(d: dict, n_shards: int) -> dict:
    """Pad the SV count to a multiple of the state-axis size. Padding rows
    duplicate SV 0 with all-zero dual coefficients, so their kernel values
    are finite and their decision contribution is exactly zero."""
    S = np.asarray(d["support_vectors"]).shape[0]
    pad = (-S) % n_shards
    if pad == 0:
        return d
    out = dict(d)
    sv = np.asarray(d["support_vectors"], np.float64)
    out["support_vectors"] = np.concatenate(
        [sv, np.repeat(sv[:1], pad, axis=0)], axis=0
    )
    dual = np.asarray(d["dual_coef"], np.float64)
    out["dual_coef"] = np.concatenate(
        [dual, np.zeros((dual.shape[0], pad), np.float64)], axis=1
    )
    return out


def _ovo_vote_argmax(D, vote_i, vote_j, n_classes: int) -> torch.Tensor:
    """(N,) class labels from full ovo decisions, libsvm's tie-break
    (lowest class index among the maxima)."""
    votes = svc.votes_from_decision(D, vote_i, vote_j, n_classes)
    return torch.argmax(votes, dim=-1).to(torch.int32)


def _head(mesh, params: svc.SvcModel):
    """The intercept and vote pairs on the device where the partials add:
    this process's first shard's."""
    head = mesh.axis_devices(STATE_AXIS)[mesh.local_shards(STATE_AXIS)[0]]
    return (params.intercept.to(head), params.vote_i.to(head),
            params.vote_j.to(head))


def _decide(mesh, parts, intercept, vote_i, vote_j, n_classes: int):
    """Sum the per-shard (N, P) partials in shard order on this process's
    first shard's device (``mesh.shard_sum``; None in another rank's
    slots), add the intercept once, vote."""
    Dv = shard_sum(parts, mesh, STATE_AXIS) + intercept[None, :]
    return _ovo_vote_argmax(Dv, vote_i, vote_j, n_classes), Dv


def sharded_decision(mesh, params: svc.SvcModel):
    """``fn(X, X_lo=None) -> (labels, (N, P) decisions)`` with the torch
    local stage: contiguous SV blocks, each shard's two-float distances,
    kernel values and partial decision on its device."""
    devs = mesh.axis_devices(STATE_AXIS)
    D = len(devs)
    S = params.sv_hi.shape[0]
    if S % D:
        raise ValueError(f"{S} support vectors do not split over {D} "
                         "shards — pad_support first")
    per = S // D
    coef_t = params.pair_coef.t()
    shards = {
        s: (params.sv_hi[s * per: (s + 1) * per].to(devs[s]),
            params.sv_lo[s * per: (s + 1) * per].to(devs[s]),
            coef_t[s * per: (s + 1) * per].contiguous().to(devs[s]),
            params.gamma.to(devs[s]))
        for s in mesh.local_shards(STATE_AXIS)
    }
    intercept, vote_i, vote_j = _head(mesh, params)

    def fn(X: torch.Tensor, X_lo=None):
        parts: list = [None] * D
        for s, (sv_hi, sv_lo, ct, gamma) in shards.items():
            Xs = X.to(devs[s])
            Xl = None if X_lo is None else X_lo.to(devs[s])
            K = torch.exp(-gamma * svc.sq_dist(Xs, Xl, sv_hi, sv_lo))
            parts[s] = svc.decision_sum(K, ct)
        return _decide(mesh, parts, intercept, vote_i, vote_j,
                       params.n_classes)

    return fn


def sharded_predict(mesh, params: svc.SvcModel, precise: bool = False):
    """``fn(X[, X_lo]) -> (N,) int32``: queries replicated, SV state
    sharded. ``precise=True`` accepts the hi/lo query split
    (``svc.split_hilo``) for float64 parity on raw-counter-scale
    features."""
    decide = sharded_decision(mesh, params)

    def fn(X, X_lo=None):
        return decide(X, X_lo)[0].to(X.device)

    if precise:
        return fn
    return lambda X: fn(X)


def fused_layout(params: svc.SvcModel, n_shards: int, sv_chunk: int = 512):
    """The kernel operands of each SV shard, on the model's device:
    ``per`` = ⌈S/D⌉ rounded up to whole ``sv_chunk`` SVs, the SVs padded
    at the tail (zero rows, zero coefficients) to ``per · D`` and cut into
    D contiguous blocks (``rbf_kernel.sv_operands``). So 2,281 SVs over 4
    shards give per = 1,024 and a shard 3 of padding alone. Returns
    ``(per, [operands])``."""
    S, F = params.sv_hi.shape
    per = -(-S // n_shards)
    per = -(-per // sv_chunk) * sv_chunk
    total = per * n_shards
    dev = params.sv_hi.device
    P = params.pair_coef.shape[0]

    def padded(a, shape):
        out = torch.zeros(shape, dtype=torch.float32, device=dev)
        out[: a.shape[0]] = a
        return out

    sv_hi = padded(params.sv_hi, (total, F))
    sv_lo = padded(params.sv_lo, (total, F))
    coef_t = padded(params.pair_coef.t(), (total, P))
    return per, [
        rbf_kernel.sv_operands(
            sv_hi[s * per: (s + 1) * per], sv_lo[s * per: (s + 1) * per],
            coef_t[s * per: (s + 1) * per].t(), params.gamma,
            params.intercept, params.vote_i, params.vote_j,
            params.n_classes,
        )
        for s in range(n_shards)
    ]


def fused_decision(mesh, params: svc.SvcModel, *, sv_chunk: int = 512):
    """``fn(X, X_lo=None) -> (labels, (N, P) decisions)`` with the KERNEL
    local stage: each shard runs the port's RBF kernel
    (``rbf_kernel.partial_decision``, one launch per shard on a card) over
    its SV block; the partials are summed in shard order and the
    intercept added once. ``fn.operands`` holds each shard's kernel
    operands (on its device; None in another rank's shards) and
    ``fn.per`` the SVs per shard. On a mesh spanning processes the kernel
    launches once per shard this rank owns, a shard of padding alone
    included."""
    devs = mesh.axis_devices(STATE_AXIS)
    per, layout = fused_layout(params, len(devs), sv_chunk)
    local = set(mesh.local_shards(STATE_AXIS))
    operands = [to_device(g, dev) if s in local else None
                for s, (g, dev) in enumerate(zip(layout, devs))]
    intercept, vote_i, vote_j = _head(mesh, params)

    def fn(X: torch.Tensor, X_lo=None):
        parts = [
            None if g is None else rbf_kernel.partial_decision(
                g, X.to(dev), None if X_lo is None else X_lo.to(dev))
            for g, dev in zip(operands, devs)
        ]
        return _decide(mesh, parts, intercept, vote_i, vote_j,
                       params.n_classes)

    fn.operands = operands
    fn.per = per
    return fn


def fused_predict(mesh, params: svc.SvcModel, *, sv_chunk: int = 512):
    """``fn(X[, X_lo]) -> (N,) int32`` of ``fused_decision``."""
    decide = fused_decision(mesh, params, sv_chunk=sv_chunk)

    def fn(X, X_lo=None):
        return decide(X, X_lo)[0].to(X.device)

    fn.operands = decide.operands
    fn.per = decide.per
    return fn
