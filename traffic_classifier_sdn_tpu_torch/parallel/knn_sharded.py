"""State-sharded k-NN: the training corpus split over the mesh's state
axis, the global top-k merged from each shard's local top-k — the port of
``traffic_classifier_sdn_tpu/parallel/knn_sharded.py``.

Each shard scores its contiguous block of the corpus and keeps a local
top-k; the (shards × k) candidates are merged into the global top-k by one
of three schedules, each an explicit exchange of per-shard tensors in
place of JAX's collectives:

- ``all_gather`` (``sharded_predict``): every candidate block gathered,
  in shard order, and one top-k over the (N, D·k) union;
- ``ring`` (``ring_predict``): each shard's block passes round the ring
  (JAX's ``ppermute`` to the next shard), every shard merging what it
  receives, D − 1 hops;
- ``tournament`` (``tournament_predict``): round r exchanges blocks with
  the XOR-2^r partner, ⌈log₂ D⌉ rounds; power-of-two D only.

Every schedule ranks by (similarity desc, global corpus index asc), the
order of a single device's top-k, so all three give labels bitwise equal
to one another and to the un-sharded predict. ``fused_predict`` takes the
local stage to the port's CUDA KNN kernel (ops/knn_kernel.py): one launch
per corpus shard, on the JAX layout — ``per`` rows a shard, rounded up to
whole 512-row chunks, padding only at the tail with +inf half norms, so a
shard may hold nothing but padding.

On a mesh spanning processes (``mesh.init_distributed``) each rank scores
only the corpus shards it owns. The ``all_gather`` merge trades the
(N, k) candidates of every shard through ``mesh.exchange``; the ``ring``
and the ``tournament`` take each hop through ``mesh.permute``, addressed
by shard (rank order is not shard order), so an (N, k) block moves point
to point and no shard ever holds all D blocks. Each rank merges its own
shards' blocks in the one-process schedule's order and votes its first
shard's global top-k: every rank's labels are the one-process mesh's.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..models import knn
from ..ops import knn_kernel
from .mesh import STATE_AXIS, exchange, permute, to_device


def pad_corpus(d: dict, n_shards: int) -> dict:
    """Pad the corpus length to a multiple of the state-axis size — and to
    at least ``n_neighbors`` rows per shard, so each local top-k is
    well-formed — with sentinel rows whose half norm is replaced by +inf
    (``pad_mask``), so they never win."""
    S = d["fit_X"].shape[0]
    k = int(d.get("n_neighbors", 1))
    target = max(S + (-S) % n_shards, n_shards * k)
    pad = target - S
    if pad == 0:
        return d
    out = dict(d)
    out["fit_X"] = np.concatenate(
        [d["fit_X"], np.zeros((pad, d["fit_X"].shape[1]),
                              d["fit_X"].dtype)], axis=0
    )
    out["y"] = np.concatenate([d["y"], np.zeros(pad, d["y"].dtype)])
    out["pad_mask"] = np.concatenate(
        [np.zeros(S, bool), np.ones(pad, bool)]
    )
    return out


def _mask_half_norms(params: knn.KnnModel, pad_mask) -> torch.Tensor:
    half = params.half_sq_norms
    if pad_mask is not None:
        mask = torch.as_tensor(np.asarray(pad_mask), device=half.device)
        half = torch.where(mask, torch.full_like(half, torch.inf), half)
    return half


def _check_real_rows(params: knn.KnnModel, pad_mask) -> None:
    """Every sharded path rests on >= k REAL corpus rows globally: padded
    rows carry −inf candidates that lose every merge only if enough real
    candidates beat them. With fewer, a padded candidate would reach the
    vote with label 0, where one device's top-k fails loudly."""
    S = params.fit_X.shape[0]
    k = int(params.n_neighbors)
    real = S if pad_mask is None else int(S - np.asarray(pad_mask).sum())
    if real < k:
        raise ValueError(f"corpus has {real} real rows < n_neighbors={k}")


def _vote(lab: torch.Tensor, n_classes: int) -> torch.Tensor:
    votes = nn.functional.one_hot(lab.long(), n_classes).sum(dim=1)
    return torch.argmax(votes, dim=-1).to(torch.int32)


def _gather_merge_vote(vals, labs, k: int, n_classes: int, device):
    """Gather every shard's (N, k) candidates onto ``device`` and vote the
    global top-k. The gathered column order, (shard, rank), is global
    corpus order among equal values — shards are contiguous ascending
    index ranges and each shard's candidates are (value desc, index asc)
    — so a stable top-k keeps one device's tie-break."""
    merged_val = torch.cat([v.to(device) for v in vals], dim=1)
    merged_lab = torch.cat([lab.to(device) for lab in labs], dim=1)
    _, gsel = knn.topk_stable(merged_val, k)
    glab = torch.gather(merged_lab, 1, gsel.long())
    return _vote(glab, n_classes)


def _packable(n_rows: int, n_classes: int) -> bool:
    """True when ``gidx · C + label`` fits int32 — the common case; huge
    corpora carry labels as a separate payload instead."""
    return n_rows * n_classes < 2**31


def _pack(lab, gidx, n_classes: int):
    """One int32 payload per candidate: ``gidx · C + label``. Monotone in
    gidx, so ordering packed values ascending orders global indices
    ascending: the tie-break key survives packing."""
    return gidx * n_classes + lab


def _merge_topk(av, ai, bv, bi, k: int, extra_a=None, extra_b=None):
    """Sort-free merge by rank of two (N, k) candidate blocks, each
    ordered by (similarity desc, index asc): each candidate's output rank
    is its own position plus the count of strictly-preceding candidates
    in the other block. Indices are unique across shards, so the ranks
    are a permutation — bitwise a lexicographic two-key sort.
    ``extra_a``/``extra_b`` is an optional int payload (labels, when the
    packed form would overflow) routed through the same selection."""
    b_pre_a = (bv[:, None, :] > av[:, :, None]) | (
        (bv[:, None, :] == av[:, :, None])
        & (bi[:, None, :] < ai[:, :, None])
    )  # (N, i, j): does B[j] precede A[i]
    pos = torch.arange(k, dtype=torch.int64, device=av.device)[None, :]
    rank_a = pos + b_pre_a.sum(dim=2)
    rank_b = pos + (~b_pre_a).sum(dim=1)
    # a rank >= k selects nothing: that candidate is dropped; ranks are
    # unique, so each kept position has exactly one writer
    slot = torch.arange(k, device=av.device)
    sel_a = rank_a[:, :, None] == slot  # (N, k, k)
    sel_b = rank_b[:, :, None] == slot
    # values through where-select, never a one-hot product: padding
    # candidates carry −inf, and 0 · (−inf) = NaN
    zero = torch.zeros((), dtype=av.dtype, device=av.device)
    mv = torch.where(sel_a, av[:, :, None], zero).sum(dim=1) + torch.where(
        sel_b, bv[:, :, None], zero).sum(dim=1)

    def route(pa, pb):
        za = torch.zeros((), dtype=pa.dtype, device=pa.device)
        return (torch.where(sel_a, pa[:, :, None], za).sum(dim=1)
                + torch.where(sel_b, pb[:, :, None], za).sum(dim=1)
                ).to(pa.dtype)

    mi = route(ai, bi)
    if extra_a is None:
        return mv, mi, None
    return mv, mi, route(extra_a, extra_b)


# A candidate block in flight ("held") is (val, packed) when the corpus
# packs into int32, else (val, gidx, lab) with labels as their own payload.


def _make_held(val, lab, gidx, n_classes: int, packable: bool):
    if packable:
        return (val, _pack(lab, gidx, n_classes))
    return (val, gidx, lab)


def _merge_held(a, b, k: int, packable: bool):
    ea, eb = (a[2], b[2]) if not packable else (None, None)
    mv, mi, me = _merge_topk(a[0], a[1], b[0], b[1], k, ea, eb)
    return (mv, mi) if me is None else (mv, mi, me)


def _held_labels(held, n_classes: int, packable: bool):
    return held[1] % n_classes if packable else held[2]


def _merge_owned(acc: list, got: list, k: int, packable: bool) -> list:
    """Each owned shard's block merged with the one it received (None
    stays None in another rank's slots)."""
    return [None if a is None else _merge_held(a, b, k, packable)
            for a, b in zip(acc, got)]


def _ring_merge(mesh, held: list, k: int, packable: bool) -> list:
    """The ring schedule: at each hop every shard passes the block it
    received last to the next shard (JAX's ``ppermute`` i → i+1) and
    merges the block it receives, so after D − 1 hops every shard holds
    the global top-k. Returns each owned shard's result."""
    n = len(held)
    ring = [(i, (i + 1) % n) for i in range(n)]
    acc = list(held)
    prev = list(held)
    for _ in range(n - 1):
        prev = permute(mesh, STATE_AXIS, prev, ring)
        acc = _merge_owned(acc, prev, k, packable)
    return acc


def _require_pow2_state(n_dev: int) -> None:
    if n_dev & (n_dev - 1):
        raise ValueError(
            f"tournament merge needs a power-of-two state axis, got {n_dev}"
        )


def _tournament_merge(mesh, held: list, k: int, packable: bool) -> list:
    """Recursive doubling: round r exchanges blocks with the XOR-2^r
    partner and merges, so every shard holds the global top-k after
    ⌈log₂ D⌉ rounds. Power-of-two D (checked by the callers). Returns
    each owned shard's result."""
    n = len(held)
    d = 1
    while d < n:
        other = permute(mesh, STATE_AXIS, held,
                        [(i ^ d, i) for i in range(n)])
        held = _merge_owned(held, other, k, packable)
        d <<= 1
    return held


def _check_merge(mesh, merge: str) -> None:
    if merge not in ("all_gather", "ring", "tournament"):
        raise ValueError(f"unknown merge {merge!r}")
    if merge == "tournament":
        _require_pow2_state(mesh.shape[STATE_AXIS])


def _finish(mesh, merge: str, vals, labs, gidxs, k: int, n_classes: int,
            packable: bool) -> torch.Tensor:
    """The merge schedule over the shards' local top-k (``vals``,
    ``labs``, ``gidxs``: one entry per shard, None in another rank's):
    (N,) int32 labels of the first local shard's result (every shard
    holds the same)."""
    devices = mesh.axis_devices(STATE_AXIS)
    local = mesh.local_shards(STATE_AXIS)
    if merge == "all_gather":
        if mesh.spans_processes:
            hosts = exchange(mesh, STATE_AXIS, [
                None if v is None else (v.cpu().numpy(), lab.cpu().numpy())
                for v, lab in zip(vals, labs)])
            vals = [torch.from_numpy(h[0]) for h in hosts]
            labs = [torch.from_numpy(h[1]) for h in hosts]
        return _gather_merge_vote(vals, labs, k, n_classes, devices[local[0]])
    if len(vals) == 1:
        return _vote(labs[0], n_classes)
    held = [None if v is None else _make_held(v, lab, g, n_classes, packable)
            for v, lab, g in zip(vals, labs, gidxs)]
    if merge == "ring":
        held = _ring_merge(mesh, held, k, packable)
    else:
        held = _tournament_merge(mesh, held, k, packable)
    return _vote(_held_labels(held[local[0]], n_classes, packable),
                 n_classes)


def _build(mesh, params: knn.KnnModel, pad_mask, merge: str):
    """The torch local stage: the corpus split into contiguous state-axis
    blocks, each shard's (N, S/D) similarity and top-k on its device, then
    the ``merge`` schedule."""
    _check_merge(mesh, merge)
    _check_real_rows(params, pad_mask)
    devs = mesh.axis_devices(STATE_AXIS)
    D = len(devs)
    S = params.fit_X.shape[0]
    if S % D:
        raise ValueError(f"{S} corpus rows do not split over {D} shards "
                         "— pad_corpus first")
    per = S // D
    k, n_classes = params.n_neighbors, params.n_classes
    half = _mask_half_norms(params, pad_mask)
    local = mesh.local_shards(STATE_AXIS)
    shards = {
        s: (params.fit_X[s * per: (s + 1) * per].to(devs[s]),
            params.fit_y[s * per: (s + 1) * per].to(devs[s]),
            half[s * per: (s + 1) * per].to(devs[s]))
        for s in local
    }
    packable = _packable(S, n_classes)

    def fn(X: torch.Tensor) -> torch.Tensor:
        vals, labs, gidxs = [None] * D, [None] * D, [None] * D
        for s, (fit_X, fit_y, h) in shards.items():
            Xs = X.to(devs[s])
            val, idx = knn.topk_stable(knn.dot_expansion_sim(Xs, fit_X, h), k)
            vals[s] = val
            labs[s] = fit_y[idx.long()].to(torch.int32)
            gidxs[s] = idx + s * per
        return _finish(mesh, merge, vals, labs, gidxs, k, n_classes,
                       packable).to(X.device)

    return fn


def sharded_predict(mesh, params: knn.KnnModel, pad_mask=None):
    """The all_gather merge: ``fn(X) -> (N,) int32``."""
    return _build(mesh, params, pad_mask, "all_gather")


def ring_predict(mesh, params: knn.KnnModel, pad_mask=None):
    """The ring merge: live state per shard O(N·k) whatever D, exactly
    ``sharded_predict``'s labels; ``fn(X) -> (N,) int32``."""
    return _build(mesh, params, pad_mask, "ring")


def tournament_predict(mesh, params: knn.KnnModel, pad_mask=None):
    """The recursive-doubling merge (power-of-two state axis), exactly
    the other merges' labels; ``fn(X) -> (N,) int32``."""
    return _build(mesh, params, pad_mask, "tournament")


def fused_layout(params: knn.KnnModel, pad_mask, n_shards: int,
                 corpus_chunk: int = 512):
    """The kernel operands of each corpus shard, on the model's device:
    ``per`` = ⌈S/D⌉ (at least k) rounded up to whole ``corpus_chunk``
    rows, the corpus padded at the TAIL only (zero features, +inf half
    norms, label 0) to ``per · D`` rows and cut into D contiguous blocks.
    So S = 4,448 over 4 shards gives per = 1,536 and a shard 3 of padding
    alone. Each block's operands come from the padded slice itself
    (``knn_kernel.corpus_operands``), which always holds ``per >= k``
    rows, whatever its real rows. Returns ``(per, [operands])``."""
    k = params.n_neighbors
    if k > corpus_chunk or k > knn_kernel.MAX_NEIGHBORS:
        raise ValueError(f"n_neighbors={k} exceeds kernel limits")
    _check_real_rows(params, pad_mask)
    S, F = params.fit_X.shape
    per = max(-(-S // n_shards), k)
    per = -(-per // corpus_chunk) * corpus_chunk
    total = per * n_shards
    dev = params.fit_X.device
    fit = torch.zeros((total, F), dtype=torch.float32, device=dev)
    fit[:S] = params.fit_X
    half = torch.full((total,), torch.inf, dtype=torch.float32, device=dev)
    half[:S] = _mask_half_norms(params, pad_mask)
    fity = torch.zeros((total,), dtype=torch.int32, device=dev)
    fity[:S] = params.fit_y
    return per, [
        knn_kernel.corpus_operands(
            fit[s * per: (s + 1) * per], half[s * per: (s + 1) * per],
            fity[s * per: (s + 1) * per], k, params.n_classes,
        )
        for s in range(n_shards)
    ]


def fused_predict(mesh, params: knn.KnnModel, pad_mask=None, *,
                  merge: str = "all_gather", corpus_chunk: int = 512):
    """The KERNEL local stage × any merge schedule: each shard runs the
    port's KNN kernel (``knn_kernel.topk_sim_idx``, one launch per shard
    on a card) over its corpus block, then the (D·k) candidates merge by
    ``merge`` ∈ ``all_gather`` | ``ring`` | ``tournament`` (power-of-two
    state axis only). Same candidates, same tie-break: labels bitwise
    equal to the torch local stage's and the un-sharded predict's.

    Returns ``fn(X) -> (N,) int32``; ``fn.operands`` holds each shard's
    kernel operands (on its device; None in another rank's shards) and
    ``fn.per`` the rows per shard. On a mesh spanning processes the kernel
    launches once per shard this rank owns."""
    n_classes = params.n_classes
    k = params.n_neighbors
    devs = mesh.axis_devices(STATE_AXIS)
    D = len(devs)
    _check_merge(mesh, merge)
    per, layout = fused_layout(params, pad_mask, D, corpus_chunk)
    local = set(mesh.local_shards(STATE_AXIS))
    operands = [to_device(g, dev) if s in local else None
                for s, (g, dev) in enumerate(zip(layout, devs))]
    # packability of gidx·C+lab against the PADDED corpus: gidx runs up to
    # per·D
    packable = _packable(per * D, n_classes)

    def fn(X: torch.Tensor) -> torch.Tensor:
        vals, labs, gidxs = [None] * D, [None] * D, [None] * D
        for s, g in enumerate(operands):
            if g is None:
                continue
            val, idx = knn_kernel.topk_sim_idx(g, X.to(devs[s]))
            vals[s] = val
            labs[s] = g.fit_y[idx.long()].to(torch.int32)
            gidxs[s] = idx + s * per
        return _finish(mesh, merge, vals, labs, gidxs, k, n_classes,
                       packable).to(X.device)

    fn.operands = operands
    fn.per = per
    return fn
