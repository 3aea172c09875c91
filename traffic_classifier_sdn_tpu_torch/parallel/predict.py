"""Batch-sharded (data-parallel) prediction for every model family — the
port of ``traffic_classifier_sdn_tpu/parallel/predict.py``.

The (N, 12) feature matrix is split row-wise over the mesh's data axis and
the same predict runs on every shard's rows with that shard's copy of the
params; the per-shard outputs are gathered back in shard order. No
collective is needed: every family's predict is row-independent. On a
mesh spanning processes each rank predicts the shards it owns and the
gather is ``mesh.exchange`` of their host copies: every rank returns the
whole batch's labels.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Any

import torch

from .mesh import DATA_AXIS, batch_sharded, exchange, replicated


def shard_params(mesh, params: Any) -> list:
    """One copy of ``params`` per data-axis shard (one per device)."""
    return replicated(mesh, params)


def shard_batch(mesh, X: torch.Tensor) -> list:
    """An (N, …) batch split row-wise across the data axis. N must divide
    by the axis size (the ingest batcher's buckets are powers of two)."""
    return batch_sharded(mesh, X)


def data_parallel(mesh, fn: Callable) -> Callable:
    """``fn(params, X, *rest)`` with params replicated and X (plus any
    extra batch-like args, e.g. the hi/lo split) batch-sharded; the
    per-shard results come back concatenated in shard order on X's
    device (through ``exchange`` when the mesh spans processes)."""

    def call(params, X, *rest):
        ps = shard_params(mesh, params)
        xs = shard_batch(mesh, X)
        rs = [shard_batch(mesh, r) for r in rest]
        outs: list = [None] * len(xs)
        for s in mesh.local_shards(DATA_AXIS):
            outs[s] = fn(ps[s], xs[s], *(r[s] for r in rs))
        if mesh.spans_processes:
            hosts = exchange(mesh, DATA_AXIS, [
                None if o is None else (o.cpu().numpy(),) for o in outs])
            outs = [torch.from_numpy(h[0]) for h in hosts]
        return torch.cat([o.to(X.device) for o in outs])

    return call
