"""Record-level latency provenance — the port's copy of
``traffic_classifier_sdn_tpu/obs/latency.py``.

How long did a record spend between its source emitting it and its label
becoming visible in a render, and in which hop? Every telemetry batch
carries host-side boundary stamps (``time.perf_counter`` domain, never on
the wire):

- ``emit``: the owning pump read or generated the batch
  (``ingest.protocol.stamp_records``: the fan-in pump's ``_deliver``, the
  collector's reader thread at pipe parse, or the CLI at arrival for
  unpumped sources);
- ``enq``/``deq``: fan-in queue enter and exit (``ingest/fanin.py``);
- ``parse``: the batch's records are through the batcher;
- ``scatter``: the tick's table update has been LAUNCHED (a launch
  boundary: the host's last touch, not the device's completion);
- ``device``: the render's device work completed — marked after the
  device stage's synchronizing copy to the host (``.cpu()``), never at
  the dispatch;
- ``render``: the rows are printed.

Per render the serve loop folds the closed batches into histograms:
``e2e_emit_to_render_s`` (and per source ``source_<sid>_e2e_s``),
``queue_wait_s``, ``batch_wait_s`` and the cumulative waterfall
``wf_queue_s``/``wf_parse_s``/``wf_scatter_s``/``wf_device_s``/
``wf_render_s``. A record's clock stops at the first render dispatched
after its scatter: ``seal()`` snapshots the closed set at dispatch, and a
coalesced render's batches fold at the render that printed. Batches that
never become visible are excluded (``drop_source``).

``slo_s`` arms the breach hook: when the running e2e p99 crosses it, the
transition is recorded (``latency.slo_breach``) and the
``latency_slo_breached`` gauge flips — an edge event.

Thread model: the host stage adds and marks entries, the device stage (or
the serial loop) folds them; shared state lives under ``_lock``, a leaf
lock (histogram observes and recorder appends happen after it releases).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

# the waterfall boundaries, in pipeline order (metric: wf_<name>_s)
WATERFALL_STAGES = ("queue", "parse", "scatter", "device", "render")


@dataclass
class _Entry:
    """One telemetry batch's boundary stamps (perf_counter domain)."""

    sid: int
    n: int
    emit: float | None
    enq: float | None = None
    deq: float | None = None
    parse: float | None = None
    scatter: float | None = None
    device: float | None = None
    seal: int | None = None  # render generation that closes this entry


class LatencyProvenance:
    """Per-tick accumulator folding batch boundary stamps into the
    latency histograms. Driven by the serve loop:

    ``begin_tick(entries)`` → ``mark_parse()`` → ``mark_scatter()`` →
    ``seal()`` (at render dispatch, host stage) → ``mark_device(s)`` →
    ``render_visible(s)`` (after the rows printed — serial loop or the
    pipeline's device-stage job). ``entries`` are ``(sid, emit, enq,
    deq, n)`` tuples — the fan-in tier's ``pop_provenance()`` shape, or
    a single synthesized entry for direct sources.
    """

    def __init__(self, metrics, recorder=None,
                 clock=time.perf_counter, slo_s: float = 0.0):
        self.metrics = metrics
        self.recorder = recorder
        self.clock = clock
        self.slo_s = slo_s
        # guards every container below: the host stage appends/marks,
        # the device-stage worker seals-and-folds — held only for the
        # bookkeeping; observes/records happen after release (leaf lock)
        self._lock = threading.Lock()
        self._open: list[_Entry] = []      # this tick, pre-scatter
        self._pending: list[_Entry] = []   # scattered, awaiting render
        self._seal_seq = 0
        self._breached = False
        # optional per-entry fold tap: fn(entry, render_ts) per folded
        # stamped entry — tools/torch_bench_e2e_live.py computes the
        # per-batch stage increments from it
        self.on_fold = None

    # -- host stage --------------------------------------------------------
    def begin_tick(self, entries) -> None:
        """Register this serve tick's arrived batches. Unstamped
        batches (``emit`` None — an absorbed ``obs.stamp`` fire, a raw
        byte source) still flow through so the counters stay honest;
        they are skipped at fold time."""
        fresh = [
            _Entry(sid=int(sid), n=int(n), emit=emit, enq=enq, deq=deq)
            for sid, emit, enq, deq, n in entries
        ]
        unstamped = sum(1 for e in fresh if e.emit is None)
        with self._lock:
            self._open.extend(fresh)
        if unstamped:
            self.metrics.inc("latency_unstamped_batches", unstamped)

    def mark_parse(self) -> None:
        now = self.clock()
        with self._lock:
            for e in self._open:
                if e.parse is None:
                    e.parse = now

    def mark_scatter(self) -> None:
        """The tick's scatter is dispatched — the open batches are now
        device-visible and move to the render-pending set."""
        now = self.clock()
        with self._lock:
            for e in self._open:
                if e.scatter is None:
                    e.scatter = now
            self._pending.extend(self._open)
            self._open.clear()

    def seal(self) -> int:
        """Snapshot the render-pending set at read-side dispatch time:
        every pending entry without a seal joins this render
        generation. Returns the generation id the render job hands
        back to ``mark_device``/``render_visible`` — entries scattered
        AFTER the dispatch (the pipelined host stage keeps ingesting)
        wait for the next render, exactly like their table rows."""
        with self._lock:
            self._seal_seq += 1
            s = self._seal_seq
            for e in self._pending:
                if e.seal is None:
                    e.seal = s
        return s

    # -- device stage ------------------------------------------------------
    def mark_device(self, seal_id: int) -> None:
        """The render's device work completed for generation
        ``seal_id`` (and any earlier generation a coalesced render
        left behind)."""
        now = self.clock()
        with self._lock:
            for e in self._pending:
                if (e.seal is not None and e.seal <= seal_id
                        and e.device is None):
                    e.device = now

    def render_visible(self, seal_id: int) -> None:
        """The rows are printed: fold every entry of generation
        ``<= seal_id`` into the histograms and retire it. A superseded
        (coalesced) render's generations fold here too — this render
        is when their telemetry actually became visible."""
        now = self.clock()
        with self._lock:
            closed = [
                e for e in self._pending
                if e.seal is not None and e.seal <= seal_id
            ]
            self._pending = [
                e for e in self._pending
                if e.seal is None or e.seal > seal_id
            ]
        if closed:
            self._fold(closed, now)

    # -- lifecycle ---------------------------------------------------------
    def drop_source(self, sid: int) -> int:
        """Discard a namespace's un-folded entries (quarantine
        eviction just cleared its rows — nothing will ever render
        them). New entries for the sid cannot arrive: the source is
        DEAD and its queue backlog was purged before this call, so the
        per-source series stops accumulating here. Returns the number
        of discarded entries."""
        with self._lock:
            n = sum(
                1 for e in self._open + self._pending if e.sid == sid
            )
            self._open = [e for e in self._open if e.sid != sid]
            self._pending = [e for e in self._pending if e.sid != sid]
        if n:
            self.metrics.inc("latency_entries_discarded", n)
        return n

    # -- fold --------------------------------------------------------------
    def _fold(self, closed, render_ts: float) -> None:
        m = self.metrics
        for e in closed:
            if e.emit is None:
                continue  # unstamped: counted at begin_tick, never folded
            e2e = max(0.0, render_ts - e.emit)
            m.observe("e2e_emit_to_render_s", e2e)
            m.observe(f"source_{e.sid}_e2e_s", e2e)
            if e.enq is not None and e.deq is not None:
                m.observe("queue_wait_s", max(0.0, e.deq - e.enq))
            if e.scatter is not None:
                host_from = e.deq if e.deq is not None else e.emit
                m.observe("batch_wait_s",
                          max(0.0, e.scatter - host_from))
            # the cumulative waterfall: time-since-emit at each boundary
            bounds = (
                ("queue", e.deq if e.deq is not None else e.emit),
                ("parse", e.parse),
                ("scatter", e.scatter),
                ("device", e.device),
                ("render", render_ts),
            )
            for name, ts in bounds:
                if ts is not None:
                    m.observe(f"wf_{name}_s", max(0.0, ts - e.emit))
            if self.on_fold is not None:
                self.on_fold(e, render_ts)
        self._check_slo()

    def _check_slo(self) -> None:
        if self.slo_s <= 0:
            return
        h = self.metrics.histograms.get("e2e_emit_to_render_s")
        if h is None or not h.count:
            return
        p99 = h.percentile(99)
        breached = p99 > self.slo_s
        self.metrics.set("latency_slo_breached", 1.0 if breached else 0.0)
        if breached and not self._breached:
            self.metrics.inc("latency_slo_breaches")
            if self.recorder is not None:
                self.recorder.record(
                    "latency.slo_breach", e2e_p99_s=round(p99, 6),
                    slo_s=self.slo_s,
                    dominant_stage=self.status().get("dominant_stage"),
                )
        self._breached = breached

    # -- surfaces ----------------------------------------------------------
    def stage_increments(self) -> dict:
        """Per-stage p50 budget (seconds): the increment between
        adjacent waterfall boundaries — what each hop itself costs at
        the median. Missing stages (no samples yet) are omitted."""
        m = self.metrics
        p50 = {}
        for name in WATERFALL_STAGES:
            h = m.histograms.get(f"wf_{name}_s")
            if h is not None and h.count:
                p50[name] = h.percentile(50)
        out = {}
        prev = 0.0
        for name in WATERFALL_STAGES:
            if name not in p50:
                continue
            out[name] = max(0.0, p50[name] - prev)
            prev = p50[name]
        return out

    def status(self) -> dict:
        """The /healthz ``latency`` block: e2e p50/p99 plus the
        dominant stage (largest p50 increment in the waterfall)."""
        h = self.metrics.histograms.get("e2e_emit_to_render_s")
        if h is None or not h.count:
            return {"observed": False}
        p50, p99 = h.quantiles((50.0, 99.0))
        inc = self.stage_increments()
        dominant = max(inc, key=inc.get) if inc else None
        out = {
            "observed": True,
            "e2e_p50_s": round(p50, 6),
            "e2e_p99_s": round(p99, 6),
            "dominant_stage": dominant,
            "stage_p50_s": {k: round(v, 6) for k, v in inc.items()},
        }
        if self.slo_s > 0:
            out["slo_s"] = self.slo_s
            out["slo_breached"] = self._breached
        return out
