"""Warmup: pay the serve's first-use costs at startup, not in tick one —
the port of ``traffic_classifier_sdn_tpu/serving/warmup.py``.

The JAX warmup compiles the serving programs ahead of time. The port
compiles no programs (torch runs eagerly, and the family's CUDA kernel is
built and loaded at model load, ``LoadedModel.serving_path``, so a build
failure raises before warmup or the serve starts), but a first tick has
costs of its own: loading a CUDA module on the first launch of each kernel
(lazy module loading), faulting in the pinned wire stages, building and
paging in the degrade ladder's host rung, and the ladder's first device
call, which runs on its grace deadline. ``warmup_serving`` pays each of
them once, on scratch state:

- ``wire_stage``: the native engine's two pinned staging buffers, touched;
- ``predict`` / ``predict[native]``: the serving predict on a zero feature
  matrix of the full table — through the ladder, this is its first device
  call;
- ``fallback_rung``: the ladder's host rung on eight zero rows;
- ``dirty[<bucket>]`` (incremental labels): compaction, the dirty-row
  gather, the predict and the label merge at every dirty bucket, so the
  first tick with churn launches nothing for the first time;
- ``top_active_flags`` / ``top_active_render`` and ``evict``: the ranked
  render and the idle-eviction scan.

``--compilation-cache-dir`` (a JAX persistent compile cache) has no
counterpart: the kernel libraries already persist under ``csrc/build/``,
named by the hash of their source.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core import flow_table as ft
from .incremental import dirty_buckets


def warmup_serving(engine, predict, params, *, table_rows: int,
                   idle_timeout: int | None = None,
                   incremental: bool = False) -> dict:
    """Pay the serve loop's first-use costs for ``engine``'s shapes.
    Returns ``{"warmed": [...], "seconds": float}``."""
    t0 = time.perf_counter()
    warmed: list[str] = []
    device = engine.device
    capacity = engine.table.capacity
    host_native = getattr(predict, "host_native", False)

    if getattr(engine, "native", False):
        engine.batcher.warm_stage()
        warmed.append("wire_stage")

    scratch = ft.make_table(capacity, device)
    X = ft.features12(scratch)
    labels = predict(params, X)
    warmed.append("predict[native]" if host_native else "predict")

    warm_fb = getattr(predict, "warm_fallback", None)
    if warm_fb is not None and warm_fb(
        np.zeros((8, ft.NUM_FEATURES), np.float32)
    ):
        warmed.append("fallback_rung")

    if incremental and getattr(engine, "dirty", None) is not None:
        dirty = torch.ones(capacity + 1, dtype=torch.bool, device=device)
        ft.dirty_count(dirty)
        cache = None
        if isinstance(labels, torch.Tensor):
            cache = labels.new_zeros(capacity + 1)
        for b in dirty_buckets(capacity):
            idx = ft.compact_dirty(dirty, b)
            sub = predict(params, ft.features12_at(scratch, idx))
            if cache is not None:
                ft.merge_labels(cache, idx, sub)
            ft.mark_dirty_slots(dirty, idx)
            warmed.append(f"dirty[{b}]")

    if table_rows > 0:
        n = min(table_rows, capacity)
        if host_native:
            ft.top_active_flags(scratch, n, 0)
            warmed.append("top_active_flags")
        else:
            ft.top_active_render(scratch, labels, n, 0)
            warmed.append("top_active_render")
    if idle_timeout:
        ft.stale_bits(scratch, 0, idle_timeout).cpu()
        pad = torch.full((engine.buckets[0],), capacity, dtype=torch.int64,
                         device=device)
        ft.clear_slots(scratch, pad)
        warmed.append("evict")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"warmed": warmed, "seconds": time.perf_counter() - t0}
