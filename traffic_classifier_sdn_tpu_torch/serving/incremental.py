"""Incremental labels: dirty-row prediction into a persistent label cache
— the port of ``traffic_classifier_sdn_tpu/serving/incremental.py``.

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

Two modes, chosen by the predict callable:

- **device** (a kernel predict): the cache is a device tensor, and the
  whole plan — predict and merge included — is queued at ``dispatch``;
- **host** (a ``host_native`` predict: the degrade ladder, which returns
  host labels): ``dispatch`` (the pipeline's host stage) fixes the tick's
  rows and features on the device, and ``finish`` (the device-stage
  worker) runs the predict and commits its labels to a numpy cache. A
  tick whose labels came back STALE (the ladder's BROKEN rung) never
  commits: the cache is the true last-known-good vector, and the rows it
  tried are queued to be marked dirty again at the next plan.

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

import numpy as np
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

    ``labels()`` is the serial entry point. ``dispatch()`` plans the tick
    (and in device mode queues its predict), ``finish()`` returns its
    labels (and in host mode runs the predict and commits it); nothing in
    ``dispatch`` waits on the device but the dirty count. ``metrics``
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
        self.host_native = bool(getattr(predict, "host_native", False))
        # shared by the host stage and the device-stage worker in the
        # pipelined host mode; never held across a predict
        self._lock = threading.Lock()
        # device mode: (capacity + 1,) labels, the last entry taking the
        # padding rows' labels (merge_labels); readers see [:capacity]
        self._cache: torch.Tensor | None = None
        self._host_cache: np.ndarray | None = None  # host mode (capacity,)
        self._pending_redirty: list[np.ndarray] = []
        self._invalidate = False
        self._epoch = self._current_epoch()
        self._last_dirty = 0
        self.last_plan: tuple[str, int] | None = None  # (kind, dirty rows)
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
            "mode": "host" if self.host_native else "device",
            "coverage": round(1.0 - dirty / max(1, self.capacity), 6),
            "dirty_rows": dirty,
            "invalidations": inv,
            "full_predicts": full,
            "subset_predicts": subset,
        }

    def labels(self):
        """This tick's (capacity,) label vector, refreshed by dirty-set
        prediction: a device tensor in device mode, a numpy array in host
        mode."""
        return self.finish(self.dispatch())

    def dispatch(self) -> _Pending:
        """Plan this render tick against the current table; in device mode
        also queue its predict and merge. Nothing waits on the device but
        the dirty count."""
        span = (
            self._tracer.span("compact") if self._tracer is not None
            else contextlib.nullcontext()
        )
        with span:
            plan = self._plan()
        self.last_plan = (plan.kind, plan.n_dirty)
        if plan.kind in ("full", "full-nocommit"):
            plan.X = ft.features12(self._engine.table)
            with self._lock:
                self._full_predicts += 1
        if self.host_native or plan.kind == "none":
            return plan
        return self._device_run(plan)

    def finish(self, plan: _Pending):
        """The label vector of a dispatched plan. Device mode: its fresh
        labels, or the cache on a tick with nothing to predict. Host mode
        (the pipeline's device-stage worker): run the predict and commit
        it; jobs run one at a time, so commits land in dispatch order."""
        if not self.host_native:
            if plan.labels is not None:
                return plan.labels
            with self._lock:
                return self._cache[: self.capacity]
        if plan.kind == "none":
            with self._lock:
                return self._host_cache
        labels = np.asarray(self._predict(self._params, plan.X))  # graftlint: disable=implicit-sync -- host-native: host mode's predict is the ladder's, which returns host labels
        if self._stale_now():
            # the ladder served last-known-good (BROKEN): never commit;
            # the rows this tick tried are marked dirty again
            if plan.kind == "subset":
                idx_host = plan.idx.cpu().numpy()  # before taking the lock  # graftlint: disable=implicit-sync -- cold-path: BROKEN-rung recovery re-mark only
                with self._lock:
                    self._pending_redirty.append(idx_host)
            else:
                self.invalidate("stale-predict")
            with self._lock:
                cached = self._host_cache
            if cached is not None:
                return cached
            return np.zeros(self.capacity, labels.dtype)
        if self._current_epoch() != self._epoch:
            # the label source changed under this predict: its labels are
            # fresh on the new source, the rest of the cache is not
            self.invalidate("epoch-mid-flight")
        if plan.kind == "full-nocommit":
            return labels
        if plan.kind == "subset":
            idx = plan.idx.cpu().numpy()  # graftlint: disable=implicit-sync -- host-native: the host-mode commit needs the host idx; the ladder's host predict above already waited for this tick's device work
            valid = idx < self.capacity
            with self._lock:
                cache = self._host_cache
                if cache is not None and cache.dtype == labels.dtype:
                    cache[idx[valid]] = labels[valid]
                    return cache
            # the cache was dropped under this subset: mark its rows again
            with self._lock:
                self._pending_redirty.append(idx)
                cached = self._host_cache
            return (cached if cached is not None
                    else np.zeros(self.capacity, labels.dtype))
        cache = np.array(labels)  # owned: the cache outlives the tick
        with self._lock:
            self._host_cache = cache
        return cache

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
            redirty, self._pending_redirty = self._pending_redirty, []
            primed = self._cache is not None or self._host_cache is not None
        try:
            faults.fault_point("serve.dirty_mask")
        except faults.FaultInjected:
            # the dirty bookkeeping is suspect: serve a direct full-table
            # predict, touch neither cache nor mask, rebuild both next tick
            self._record_fault("serve.dirty_mask")
            self.invalidate("fault:serve.dirty_mask")
            with self._lock:
                self._pending_redirty = redirty + self._pending_redirty
            self._note(self.capacity)
            return _Pending("full-nocommit", n_dirty=self.capacity)
        for slots in redirty:
            ft.mark_dirty_slots(
                eng.dirty, torch.from_numpy(slots).to(eng.dirty.device)  # graftlint: disable=transfer-discipline -- cold-path: re-marks the rows of a stale (BROKEN-rung) predict only
            )
        if invalidate or not primed or self._ladder_rung() not in (
            None, "HEALTHY"
        ):
            # off the healthy rung the whole table carries the fallback's
            # labels, as the full-predict serve would
            eng.dirty.zero_()
            self._note(self.capacity)
            return _Pending("full", n_dirty=self.capacity)
        n = int(ft.dirty_count(eng.dirty))  # the tick's one device sync  # graftlint: disable=implicit-sync -- tick-plan: O(1) scalar that sizes this tick's dispatch
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

    def _stale_now(self) -> bool:
        return (self._degrade is not None
                and bool(getattr(self._degrade, "render_stale", False)))

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


# ---------------------------------------------------------------------------
# Pipelined read objects (serving/pipeline.dispatch_read builds them when
# the serve is incremental; the contract of pipeline.RankedRead/FullRead)
# ---------------------------------------------------------------------------


class IncRankedRead:
    """A ranked render through the label cache in host mode: the host stage
    dispatched the incremental plan (``pending``) and the ranked flags
    against the tick's table; ``rows()`` (the device-stage worker) runs the
    predict, commits the cache and joins labels by slot."""

    __slots__ = ("_inc", "_pending", "_flags", "_fence", "n_flows")

    def __init__(self, inc: IncrementalLabels, pending: _Pending, flags,
                 n_flows: int, fence):
        self._inc = inc
        self._pending = pending
        self._flags = flags
        self._fence = fence
        self.n_flows = n_flows

    def commit(self) -> None:
        """Commit the plan without rendering (a coalesced render)."""
        with self._fence.enter():
            self._inc.finish(self._pending)

    def rows(self) -> list[tuple]:
        with self._fence.enter():
            labels = np.asarray(self._inc.finish(self._pending))  # graftlint: disable=implicit-sync -- host-native: finish() ran the ladder's host predict
            idx, valid, fa, ra = (t.cpu().numpy() for t in self._flags)  # graftlint: disable=implicit-sync -- render-sync: the ranked render's flags must reach the host
        return [
            (int(s), int(labels[int(s)]), bool(f), bool(r))
            for s, v, f, r in zip(idx, valid, fa, ra)
            if v
        ]


class IncFullRead:
    """The unbounded (``--table-rows 0``) render through the label cache:
    the worker takes the whole label vector (device mode: a copy taken at
    dispatch, since the next plan merges into the cache in place; host
    mode: ``finish``) and joins the dispatch-time metadata snapshot."""

    __slots__ = ("_inc", "_pending", "_labels", "_fa", "_ra", "_meta",
                 "_fence", "n_flows")

    def __init__(self, inc: IncrementalLabels, pending: _Pending, labels,
                 fa, ra, meta, n_flows: int, fence):
        self._inc = inc
        self._pending = pending
        self._labels = labels  # device mode's copy; None in host mode
        self._fa = fa
        self._ra = ra
        self._meta = meta
        self._fence = fence
        self.n_flows = n_flows

    def commit(self) -> None:
        if self._labels is None:
            with self._fence.enter():
                self._inc.finish(self._pending)

    def rows(self) -> list[tuple]:
        with self._fence.enter():
            labels = (self._inc.finish(self._pending)
                      if self._labels is None else self._labels)
            if isinstance(labels, torch.Tensor):
                labels = labels.cpu().numpy()  # graftlint: disable=implicit-sync -- render-sync: the full render's labels must reach the host
            fa, ra = self._fa.cpu().numpy(), self._ra.cpu().numpy()  # graftlint: disable=implicit-sync -- render-sync: the full render's activity flags must reach the host
        return [
            (slot, src, dst, int(labels[slot]), bool(fa[slot]),
             bool(ra[slot]))
            for slot, (src, dst) in sorted(self._meta.items())
        ]
