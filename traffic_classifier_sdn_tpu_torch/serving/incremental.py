"""Incremental labels: dirty-row prediction into a persistent label cache
on the device — the serial, device-mode path of
``traffic_classifier_sdn_tpu/serving/incremental.py``.

A row with no telemetry this tick projects the same 12 features it did
last tick (the reference freezes them when its deltas are zero,
traffic_classifier.py:75-78), and every served family labels rows
independently, so its label is unchanged. Prediction cost then scales
with per-tick churn, not with the table:

- with dirty tracking on, ``FlowStateEngine`` scatters each wire through
  ``flow_table.apply_wire_dirty``, which also sets the dirty bit of every
  slot the wire touches, and eviction sets the bits of the cleared rows
  (``clear_slots_dirty``);
- each render tick, ``IncrementalLabels`` fetches ONE scalar (the dirty
  count: the tick's only wait on the device), picks the smallest bucket
  that admits it (``dirty_buckets``), compacts the dirty row indices on
  the device (``compact_dirty``), gathers exactly those rows' features
  (``features12_at``, elementwise identical to ``features12(table)[idx]``),
  predicts the subset through the family's kernel, and scatters the
  fresh labels into the cache (``merge_labels``);
- no dirty row: no predict at all. A dirty count above the largest
  bucket: the full-table predict, which is then the cheaper one.

The cache holds what a full-table predict would label each row today, so
the rendered output is byte-identical to ``--incremental off``.

The label source may change under the cache (a model promotion or a
degrade rung change, in the JAX serve): the predict callable's
``label_epoch`` attribute, when it has one, invalidates the whole cache
when it changes, and ``degrade`` (an object whose ``status()["rung"]``
names the rung), when given, routes ticks off its healthy rung through
the full predict. Fault sites ``serve.dirty_mask`` and
``serve.label_cache`` are absorbed: a fire serves that tick from a direct
full-table predict, leaving the cache and the dirty mask as they were.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from ..core import flow_table as ft
from ..utils import faults


def dirty_buckets(capacity: int) -> tuple[int, ...]:
    """The static compaction sizes for a table of ``capacity`` rows: powers
    of four from 16 up to (exclusive) ``capacity``. A dirty count above
    the largest runs the full-table predict."""
    out = []
    b = 16
    while b < capacity:
        out.append(b)
        b *= 4
    return tuple(out)


class _Pending:
    """One render tick's plan and, once run, its labels."""

    __slots__ = ("kind", "idx", "X", "n_dirty", "labels")

    def __init__(self, kind: str, idx=None, X=None, n_dirty: int = 0):
        self.kind = kind  # "none" | "subset" | "full" | "full-nocommit"
        self.idx = idx  # (bucket,) device indices, padded with capacity
        self.X = X  # dirty-row (or full) feature matrix, device
        self.n_dirty = n_dirty
        self.labels = None  # the (capacity,) label vector served


class IncrementalLabels:
    """The serve loop's label source under ``--incremental auto``: a
    persistent (capacity,) label vector kept by dirty-set prediction.

    ``labels()`` is the serial entry point. ``dispatch()`` plans and runs
    the tick's predict, ``finish()`` returns its labels; every step but the
    dirty count is queued on the device without waiting. ``metrics``
    (``inc``/``set``), ``recorder`` (``record``) and ``tracer`` (``span``)
    are optional observers."""

    def __init__(self, engine, predict, params, *, degrade=None,
                 metrics=None, recorder=None, tracer=None):
        if engine.dirty is None:
            engine.enable_dirty_tracking()
        self._engine = engine
        self._predict = predict
        self._params = params
        self._degrade = degrade
        self._metrics = metrics
        self._recorder = recorder
        self._tracer = tracer
        self.capacity = engine.table.capacity
        self.buckets = dirty_buckets(self.capacity)
        self._lock = threading.Lock()
        # (capacity + 1,) labels: the last entry takes the padding rows'
        # labels (merge_labels); readers see [:capacity]
        self._cache: torch.Tensor | None = None
        self._invalidate = False
        self._epoch = self._current_epoch()
        self._last_dirty = 0
        self._invalidations = 0
        self._full_predicts = 0
        self._subset_predicts = 0

    # -- public surface ----------------------------------------------------
    def invalidate(self, reason: str = "explicit") -> None:
        """Mark the whole cache stale: the next render tick re-predicts the
        full table. Called on label-epoch changes and by anything else
        that changes what a label means."""
        with self._lock:
            self._invalidate = True
            self._invalidations += 1
        if self._metrics is not None:
            self._metrics.inc("label_cache_invalidations")
        if self._recorder is not None:
            self._recorder.record("label_cache.invalidate", reason=reason)

    def status(self) -> dict:
        """Counters of the cache: rows predicted last tick, coverage,
        invalidations, full and subset predicts."""
        with self._lock:
            dirty = self._last_dirty
            inv = self._invalidations
            full = self._full_predicts
            subset = self._subset_predicts
        return {
            "mode": "device",
            "coverage": round(1.0 - dirty / max(1, self.capacity), 6),
            "dirty_rows": dirty,
            "invalidations": inv,
            "full_predicts": full,
            "subset_predicts": subset,
        }

    def labels(self) -> torch.Tensor:
        """This tick's (capacity,) label vector on the device, refreshed by
        dirty-set prediction."""
        return self.finish(self.dispatch())

    def dispatch(self) -> _Pending:
        """Plan this render tick against the current table and run its
        predict. Nothing waits on the device but the dirty count."""
        span = (
            self._tracer.span("compact") if self._tracer is not None
            else contextlib.nullcontext()
        )
        with span:
            plan = self._plan()
        if plan.kind in ("full", "full-nocommit"):
            plan.X = ft.features12(self._engine.table)
            with self._lock:
                self._full_predicts += 1
        if plan.kind == "none":
            return plan
        return self._device_run(plan)

    def finish(self, plan: _Pending) -> torch.Tensor:
        """The label vector of a dispatched plan: its fresh labels, or the
        cache on a tick with nothing to predict."""
        if plan.labels is not None:
            return plan.labels
        with self._lock:
            return self._cache[: self.capacity]

    # -- the plan ----------------------------------------------------------
    def _plan(self) -> _Pending:
        """Decide none / subset / full for this tick and queue the
        compaction. Committing plans ("subset", "full") clear the dirty
        mask here: the next tick's scatter marks what it touches."""
        eng = self._engine
        # a changed label source invalidates everything
        epoch = self._current_epoch()
        if epoch != self._epoch:
            self._epoch = epoch
            self.invalidate("label-epoch")
        with self._lock:
            invalidate = self._invalidate
            self._invalidate = False
            primed = self._cache is not None
        try:
            faults.fault_point("serve.dirty_mask")
        except faults.FaultInjected:
            # the dirty bookkeeping is suspect: serve a direct full-table
            # predict, touch neither cache nor mask, rebuild both next tick
            self._record_fault("serve.dirty_mask")
            self.invalidate("fault:serve.dirty_mask")
            self._note(self.capacity)
            return _Pending("full-nocommit", n_dirty=self.capacity)
        if invalidate or not primed or self._ladder_rung() not in (
            None, "HEALTHY"
        ):
            # off the healthy rung the whole table carries the fallback's
            # labels, as the full-predict serve would
            eng.dirty.zero_()
            self._note(self.capacity)
            return _Pending("full", n_dirty=self.capacity)
        n = int(ft.dirty_count(eng.dirty))  # the tick's one device sync
        self._note(n)
        if n == 0:
            if self._metrics is not None:
                self._metrics.inc("predict_rows_saved", self.capacity)
            return _Pending("none", n_dirty=0)
        bucket = next((b for b in self.buckets if n <= b), None)
        if bucket is None:
            eng.dirty.zero_()
            self._note(self.capacity)
            return _Pending("full", n_dirty=n)
        try:
            faults.fault_point("serve.label_cache")
        except faults.FaultInjected:
            # the cache merge is suspect: serve a direct full-table
            # predict; the dirty rows re-predict next tick
            self._record_fault("serve.label_cache")
            self._note(self.capacity)
            return _Pending("full-nocommit", n_dirty=n)
        idx = ft.compact_dirty(eng.dirty, bucket)
        Xd = ft.features12_at(eng.table, idx)
        eng.dirty.zero_()
        if self._metrics is not None:
            self._metrics.inc("predict_rows_saved", self.capacity - n)
        with self._lock:
            self._subset_predicts += 1
        return _Pending("subset", idx=idx, X=Xd, n_dirty=n)

    def _device_run(self, plan: _Pending) -> _Pending:
        """Predict the plan's rows and commit them to the cache."""
        labels = self._predict(self._params, plan.X)
        if plan.kind == "full-nocommit":
            plan.labels = labels
            return plan
        with self._lock:
            if plan.kind == "subset":
                self._cache = ft.merge_labels(self._cache, plan.idx, labels)
            else:
                if self._cache is None or self._cache.dtype != labels.dtype:
                    self._cache = labels.new_zeros(self.capacity + 1)
                self._cache[: self.capacity] = labels
            plan.labels = self._cache[: self.capacity]
        return plan

    # -- helpers -----------------------------------------------------------
    def _note(self, n: int) -> None:
        """Record this tick's predicted-row count."""
        with self._lock:
            self._last_dirty = n
        if self._metrics is not None:
            self._metrics.set("dirty_rows", n)

    def _current_epoch(self):
        return getattr(self._predict, "label_epoch", None)

    def _ladder_rung(self) -> str | None:
        if self._degrade is None:
            return None
        try:
            return self._degrade.status().get("rung")
        except Exception:  # noqa: BLE001 — a health probe must not serve
            return None

    def _record_fault(self, site: str) -> None:
        if self._recorder is not None:
            self._recorder.record("label_cache.fault_absorbed", site=site)
