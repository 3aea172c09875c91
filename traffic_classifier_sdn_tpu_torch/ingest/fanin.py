"""Fan-in ingest tier: many telemetry sources, one device, per-source
blast radius — the port's copy of
``traffic_classifier_sdn_tpu/ingest/fanin.py``.

N independently supervised sources (live monitor subprocesses, capture
replays, synthetic populations) feed ONE serve loop through a bounded
MPSC queue, and each source owns a disjoint flow-table namespace (its id
folded into the stable 64-bit flow key, ingest/protocol.stable_flow_key).

Blast-radius contract — the degrade-ladder pattern applied horizontally
(serving/degrade.py runs it vertically, device→host→stale):

- a producer is NEVER blocked and the queue is NEVER unbounded: on
  overflow the incoming batch is dropped and counted against ITS source
  (``FanInQueue``, fault site ``ingest.fanin_put``);
- per-source supervision state HEALTHY → RESTARTING → DEAD: a live
  source rides its own SupervisedCollector restart ladder (RESTARTING
  between incarnations); an uncleanly dead source (crash after budget,
  killed pump — fault site ``ingest.source_dead``) is quarantined and,
  after ``quarantine_s``, exactly its own namespace's slots are evicted
  (``FlowStateEngine.evict_source``) while every other source keeps
  serving fresh labels every tick;
- a restarted source re-registers into its OLD namespace: flow keys are
  deterministic in (source id, flow tuple), and the protocol's counters
  are cumulative, so the first post-restart poll is one large delta per
  flow — the same thing a supervisor restart always produced.

Tick semantics: one serve tick consumes AT MOST ONE poll batch per
source (``FanInQueue.take``), so a backlogged source cannot smear its
tick boundaries into a neighbor's, and single-source fan-in is
tick-for-tick identical to the direct collector path. Pull-paced sources
(capture/synthetic) support ``lockstep`` credits — the consumer grants
one emission per serve tick — which makes multi-source runs
deterministic (tests) and turns N synthetic sources into a repeatable
heavy-traffic load generator.

With ``metrics`` (a ``utils.metrics.Metrics``; the CLI passes
``global_metrics``) the tier writes the JAX tier's series: the event
counters ``source_deaths``, ``source_restarts``,
``source_restarts_refused`` and ``source_flap_escalations``, and on every
tick the gauges ``fanin_sources``, ``fanin_queued_records``,
``fanin_sources_dead``, ``fanin_records_dropped`` and per source
``source_<sid>_state``/``_drops``/``_flaps``/``_lag_s``. The same numbers
stay readable on the object: ``roster()`` rows and ``counters``.
``recorder`` (obs/flight_recorder.py) receives the tier's events.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, replace

from ..utils.faults import FaultInjected, fault_point
from .protocol import TelemetryRecord, stamp_records

SOURCE_HEALTHY = "HEALTHY"
SOURCE_RESTARTING = "RESTARTING"
SOURCE_DEAD = "DEAD"
_STATE_CODE = {SOURCE_HEALTHY: 0, SOURCE_RESTARTING: 1, SOURCE_DEAD: 2}


@dataclass(frozen=True)
class SourceSpec:
    """One telemetry source the fan-in tier supervises.

    ``kind`` selects the pump: ``cmd`` spawns a monitor command under a
    SupervisedCollector (restart ladder and all), ``capture`` replays a
    recorded monitor capture tick-by-tick, ``synthetic`` generates a
    flow population (ingest/replay.SyntheticFlows), ``feed`` pulls each
    poll tick's wire bytes from a caller-supplied script callable
    (``feed(tick_index) -> bytes | None`` — the scenario library's
    timeline seam; raw tiers only). ``sid`` is the
    namespace id folded into every record's flow key — 0 is the legacy
    namespace (records pass through unstamped, byte-compatible with the
    single-collector path). Pull-paced kinds emit every ``interval``
    seconds, or on consumer credits when ``lockstep`` (deterministic
    multi-source runs: one emission per serve tick)."""

    kind: str  # "cmd" | "capture" | "synthetic" | "feed"
    sid: int
    name: str = ""
    cmd: str = ""
    path: str = ""
    n_flows: int = 0
    seed: int = 0
    mac_base: int = 0
    # synthetic churn fraction: share of this source's flow population
    # emitting telemetry each tick (replay.SyntheticFlows churn — the
    # dirty-fraction knob behind incremental serving, per source)
    churn: float = 1.0
    max_ticks: int = 0  # synthetic bound (0 = unbounded)
    max_restarts: int = 5
    interval: float = 1.0
    lockstep: bool = False
    # "feed" kind only: per-tick wire-bytes script, compared by identity
    # (scenario timelines — see traffic_classifier_sdn_tpu/scenarios/)
    feed: object = None

    @property
    def label(self) -> str:
        return self.name or f"{self.kind}-{self.sid}"


def parse_source_spec(text: str, sid: int, *, max_restarts: int = 5,
                      interval: float = 1.0,
                      lockstep: bool = False) -> SourceSpec:
    """``KIND:ARG`` → SourceSpec (the --source-spec syntax): ``cmd:<shell
    command>``, ``capture:<path>``, ``synthetic:<n_flows>``."""
    kind, sep, arg = text.partition(":")
    if not sep or not arg:
        raise ValueError(
            f"source spec {text!r} is not KIND:ARG "
            f"(cmd:<command> | capture:<path> | synthetic:<n_flows>)"
        )
    common = dict(sid=sid, max_restarts=max_restarts, interval=interval,
                  lockstep=lockstep)
    if kind == "cmd":
        return SourceSpec(kind="cmd", cmd=arg, **common)
    if kind == "capture":
        return SourceSpec(kind="capture", path=arg, **common)
    if kind == "synthetic":
        try:
            n = int(arg)
        except ValueError:
            raise ValueError(
                f"synthetic source spec needs an integer flow count, "
                f"got {arg!r}"
            ) from None
        # disjoint MAC space per namespace so the aggregate looks like
        # N switches, not N copies of one (replay.SyntheticFlows)
        return SourceSpec(kind="synthetic", n_flows=n, seed=sid,
                          mac_base=sid * n, **common)
    raise ValueError(
        f"unknown source kind {kind!r} (cmd | capture | synthetic)"
    )


class FanInQueue:
    """Bounded MPSC batch queue between N source pumps and one serve
    loop, with per-source drop accounting.

    ``put`` never blocks: when the queued-record bound would be
    exceeded the INCOMING batch is dropped, counted against its source,
    and reported to the flight recorder — backpressure costs the noisy
    source its own telemetry, not its neighbors' latency (the same
    drop-don't-block rule SubprocessCollector's reader enforces on its
    own pipe queue). Records, not batches, are the bound: N bursty
    sources share one budget measured in what actually costs ingest
    time."""

    def __init__(self, max_records: int = 1 << 16, recorder=None,
                 prov_clock=time.perf_counter,
                 collect_provenance: bool = False):
        self.max_records = max_records
        self._recorder = recorder  # set once, read-only afterwards
        # latency provenance (obs/latency.py): enqueue/dequeue stamps
        # per batch, in the perf_counter domain the emit stamps use —
        # queue-wait is deq − enq. Collection is opt-in (the tier turns
        # it on with stamping) and the taken-entry buffer is bounded so
        # a consumer that never drains it cannot leak.
        self._prov_clock = prov_clock
        self._collect_prov = collect_provenance
        self._taken_prov: deque = deque(maxlen=4096)
        # guards every queue/counter access below: producers are the
        # source pump threads, the consumer is the serve loop, and the
        # drop counters are read by the obs roster — all cross-thread
        self._lock = threading.Lock()
        # (sid, payload, n_records, enq_ts, emit_ts) in arrival order;
        # payload is a record list (the Python-batcher path) or a raw
        # wire-format bytes blob (the native path — n and emit travel
        # explicitly because bytes can't carry a stamp attribute)
        self._batches: deque = deque()
        self._queued = 0  # records currently queued
        self._drops: dict[int, int] = {}  # sid → records dropped
        self._accepted: dict[int, int] = {}  # sid → records accepted
        # sid → accepted records later purged at eviction: a purge
        # re-classifies accepted→dropped, so the per-source accounting
        # identity the scenario gates check is
        #   emitted == accepted + (drops − purged)
        self._purged: dict[int, int] = {}
        # raw-mode framing poison: sources whose BYTE stream lost a
        # chunk (bound drop or eviction purge). Raw chunks can end
        # mid-line, and the consumer's per-source tail carry would
        # otherwise splice the pre-drop fragment onto the post-drop
        # chunk's head — a torn line that might parse as a wrong-but-
        # valid record. The next accepted byte batch is prefixed with
        # b"\x00\n" (the collector's torn-read poison idiom): the stale
        # tail terminates as an unparseable line (counted malformed if
        # telemetry-shaped) and framing resyncs at a real boundary.
        self._poisoned: set[int] = set()

    def put(self, sid: int, records: list) -> bool:
        """Enqueue one poll batch; False when it was dropped (bound hit
        or an injected enqueue failure — the chaos seam for a queue-full
        drop burst, ABSORBED here by design)."""
        return self._put(sid, records, len(records), None)

    def put_bytes(self, sid: int, data: bytes, n_records: int,
                  emit_ts: float | None = None) -> bool:
        """Raw-wire counterpart of ``put`` — the native-ingest delivery
        unit: one poll batch as wire-format bytes, its record count for
        the bound/accounting, and the pump-read emit stamp carried
        EXPLICITLY (the latency plane's provenance seam: a byte batch
        has no record object to stamp, so the emit moment rides the
        queue entry instead — same clock domain, same fold)."""
        return self._put(sid, data, n_records, emit_ts)

    def _put(self, sid: int, payload, n: int,
             emit_ts: float | None) -> bool:
        is_bytes = isinstance(payload, (bytes, bytearray))
        if n == 0:
            # empty poll (record path, or a genuinely empty byte tick)
            # — nothing to queue. Raw callers pass n >= 1 for any
            # nonempty payload (a newline-less pipe fragment counts as
            # one pending record), so no bytes are ever eaten here.
            return True
        dropped = False
        try:
            fault_point("ingest.fanin_put")
        except FaultInjected:
            dropped = True
        if not dropped:
            enq = self._prov_clock() if self._collect_prov else None
            with self._lock:
                if self._queued + n > self.max_records:
                    dropped = True
                else:
                    if is_bytes and sid in self._poisoned:
                        # terminate the consumer's stale pre-drop tail
                        # at an unparseable boundary (see _poisoned)
                        self._poisoned.discard(sid)
                        payload = b"\x00\n" + bytes(payload)
                    self._batches.append((sid, payload, n, enq, emit_ts))
                    self._queued += n
                    self._accepted[sid] = self._accepted.get(sid, 0) + n
        if dropped:
            with self._lock:
                self._drops[sid] = self._drops.get(sid, 0) + n
                if is_bytes:
                    self._poisoned.add(sid)
            # record OUTSIDE the queue lock: the ring has its own lock
            # and this one stays a leaf (graftlock lock-order)
            if self._recorder is not None:
                self._recorder.record(
                    "fanin.drop", source=sid, records=n,
                    cause="overflow",
                )
            return False
        return True

    def poison(self, sid: int) -> None:
        """Force a framing resync for ``sid``'s byte stream: the next
        accepted byte batch is prefixed with the ``b"\\x00\\n"`` seam
        (see ``_poisoned``). The tier calls this at namespace eviction
        and source restart — the CONSUMER's per-source tail can hold
        the dead incarnation's dangling half line even when the purge
        found an already-drained queue (nothing queued is not the same
        as nothing carried), and a restarted worker's fresh collector
        shares no seam with the old worker's last partial chunk."""
        with self._lock:
            self._poisoned.add(sid)

    def take(self, exclude=()) -> list[tuple[int, list]]:
        """Pop the OLDEST batch per source (arrival order preserved),
        skipping sources in ``exclude`` — one serve tick consumes at
        most one poll tick per source, so a backlogged source drains
        one batch per tick instead of smearing several poll ticks into
        one serve tick. With provenance collection on, each taken
        batch's ``(sid, emit, enq, deq, n)`` lands in the taken-entry
        buffer for ``pop_provenance`` — a PURGED batch never gets an
        entry, so a dead source's flushed backlog cannot poison the
        e2e quantiles."""
        deq = self._prov_clock() if self._collect_prov else None
        with self._lock:
            out: list[tuple[int, list]] = []
            kept: deque = deque()
            seen = set(exclude)
            while self._batches:
                sid, payload, n, enq, emit = self._batches.popleft()
                if sid in seen:
                    kept.append((sid, payload, n, enq, emit))
                else:
                    seen.add(sid)
                    out.append((sid, payload))
                    self._queued -= n
                    if deq is not None:
                        if emit is None and not isinstance(
                            payload, (bytes, bytearray)
                        ):
                            # record batches carry the stamp on their
                            # LEAD record (protocol.stamp_records)
                            emit = (
                                payload[0].emit_ts if payload else None
                            )
                        self._taken_prov.append((sid, emit, enq, deq, n))
            self._batches = kept
        return out

    def pop_provenance(self) -> list[tuple]:
        """Drain the taken-batch provenance entries accumulated since
        the last call — ``(sid, emit, enq, deq, n_records)`` per batch,
        the ``obs.latency.LatencyProvenance.begin_tick`` input shape.
        Empty unless the queue was built with provenance collection."""
        with self._lock:
            out = list(self._taken_prov)
            self._taken_prov.clear()
        return out

    def purge(self, sid: int) -> int:
        """Drop every queued batch from ``sid`` (counted against it) —
        the eviction-time flush: a dead source's backlog must not be
        ingested AFTER its namespace was cleared, or it would re-create
        slots in a namespace nothing will ever quarantine again.
        Returns the records dropped."""
        purged = 0
        purged_bytes = False
        with self._lock:
            kept: deque = deque()
            while self._batches:
                entry = self._batches.popleft()
                if entry[0] == sid:
                    purged += entry[2]
                    if isinstance(entry[1], (bytes, bytearray)):
                        purged_bytes = True
                else:
                    kept.append(entry)
            self._batches = kept
            if purged:
                self._queued -= purged
                self._drops[sid] = self._drops.get(sid, 0) + purged
                self._purged[sid] = self._purged.get(sid, 0) + purged
                if purged_bytes:
                    # a restarted incarnation's first chunk must not
                    # splice onto the evicted stream's dangling tail
                    self._poisoned.add(sid)
        if purged and self._recorder is not None:
            self._recorder.record(
                "fanin.drop", source=sid, records=purged,
                cause="namespace_evicted",
            )
        return purged

    @property
    def pending(self) -> int:
        """Records currently queued."""
        with self._lock:
            return self._queued

    def drops(self) -> dict[int, int]:
        """sid → records dropped (queue-full or injected), cumulative."""
        with self._lock:
            return dict(self._drops)

    def accepted(self) -> dict[int, int]:
        with self._lock:
            return dict(self._accepted)

    def purged(self) -> dict[int, int]:
        """sid → records that were ACCEPTED and later purged at
        eviction (a subset of ``drops()``): subtract these from the
        drop tally to recover put-time drops, closing the per-source
        accounting identity ``emitted == accepted + (drops − purged)``
        the scenario SLO gates assert."""
        with self._lock:
            return dict(self._purged)


class RawTick(list):
    """One serve tick of raw wire-format byte batches — ``[(sid,
    payload), ...]`` ordered by source id, the native-ingest fan-in
    delivery unit: the serve loop feeds each payload to the C++ engine
    under its source's namespace (``engine.ingest_bytes(data, sid)``)
    and no per-flow string ever crosses into Python."""


class SourceWorker:
    """One supervised telemetry source pumping into the shared queue.

    The pump is a daemon thread; its per-source state (HEALTHY /
    RESTARTING / DEAD, delivery counters, last-delivery clock) is read
    by the serve loop's supervision pass and the obs roster, so every
    access holds ``_state_lock``. A pump that dies for ANY reason —
    stream exhaustion, supervisor budget, injected ``ingest.source_dead``
    fire, even an unexpected exception — lands in DEAD with a ``clean``
    verdict: only an UNCLEAN death quarantines the namespace.

    ``raw`` selects wire-format byte delivery (the native-ingest fast
    path): the pump hands the queue one bytes blob per poll tick —
    capture sources replay their recorded line bytes, synthetic sources
    render straight to the wire (``SyntheticFlows.tick_bytes``), cmd
    sources forward raw pipe chunks — and the namespace is applied at
    the C++ keyer instead of a per-record ``replace`` pass."""

    def __init__(self, spec: SourceSpec, queue: FanInQueue, metrics=None,
                 recorder=None, clock=time.monotonic,
                 stamp: bool = False, prov_clock=time.perf_counter,
                 raw: bool = False):
        self.spec = spec
        self._raw = raw
        self._queue = queue
        self._metrics = metrics
        self._recorder = recorder
        self._clock = clock
        # latency provenance: stamp each delivered batch's records with
        # the pump-read moment (perf_counter domain, host-side only)
        self._stamp = stamp
        self._prov_clock = prov_clock
        self._state_lock = threading.Lock()
        self._state = SOURCE_HEALTHY
        self._clean = False
        self._killed = False
        self._records = 0
        self._emitted = 0  # records handed to the queue (accepted OR dropped)
        self._ticks = 0
        self._restarts = 0
        self._last_put_at: float | None = None
        self._coll = None  # cmd sources: the SupervisedCollector
        self._stop_evt = threading.Event()
        # one pending lockstep emission credit (consumer-granted,
        # pump-consumed) — a plain flag under _state_lock, polled by the
        # pump at 20 ms granularity
        self._credit_due = False
        self._thread: threading.Thread | None = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"tcsdn-fanin-{self.spec.label}",
        )
        self._thread.start()

    def stop(self) -> None:
        """Clean shutdown (tier teardown): the pump winds down as a
        CLEAN death — no quarantine, no namespace eviction."""
        self._stop_evt.set()
        with self._state_lock:
            coll = self._coll
        if coll is not None:
            coll.stop()

    def kill(self) -> None:
        """Simulate source death (tests/ops): same teardown as stop()
        but the death is UNCLEAN — the tier quarantines the namespace,
        exactly as if the pump had crashed."""
        with self._state_lock:
            self._killed = True
        self.stop()

    def grant(self) -> None:
        """One lockstep emission credit (the consumer's per-tick grant).
        Idempotent between emissions: double-granting before the pump
        consumed the credit collapses to one — the pump can never
        overrun the serve tick it was granted."""
        with self._state_lock:
            self._credit_due = True

    def join(self, timeout: float | None = None) -> None:
        t = self._thread
        if t is not None:
            t.join(timeout)

    # -- state surface -----------------------------------------------------
    @property
    def alive(self) -> bool:
        with self._state_lock:
            return self._state != SOURCE_DEAD

    @property
    def dead_unclean(self) -> bool:
        with self._state_lock:
            return self._state == SOURCE_DEAD and not self._clean

    def snapshot(self) -> dict:
        """Roster row: id, state, lag, counters (drops ride in from the
        queue at the tier level)."""
        with self._state_lock:
            state = self._state
            clean = self._clean
            records = self._records
            emitted = self._emitted
            ticks = self._ticks
            restarts = self._restarts
            last = self._last_put_at
        return {
            "id": self.spec.sid,
            "name": self.spec.label,
            "kind": self.spec.kind,
            "state": state,
            "clean": clean,
            "records": records,
            "emitted": emitted,
            "ticks": ticks,
            "restarts": restarts,
            "lag_s": (
                None if last is None
                else round(max(0.0, self._clock() - last), 3)
            ),
        }

    # -- pump --------------------------------------------------------------
    def _run(self) -> None:
        clean = False
        try:
            clean = self._pump()
        except FaultInjected:
            clean = False  # injected mid-stream death (chaos)
        except Exception as e:  # noqa: BLE001 — one source must not kill N
            import sys

            print(
                f"WARNING: telemetry source {self.spec.label} died: "
                f"{type(e).__name__}: {e}",
                file=sys.stderr,
            )
            clean = False
        finally:
            with self._state_lock:
                if self._killed:
                    clean = False
                self._state = SOURCE_DEAD
                self._clean = clean

    def _pump(self) -> bool:
        if self.spec.kind == "cmd":
            return self._pump_cmd()
        if self.spec.kind == "capture":
            return self._pump_capture()
        if self.spec.kind == "synthetic":
            return self._pump_synthetic()
        if self.spec.kind == "feed":
            return self._pump_feed()
        raise ValueError(f"unknown source kind {self.spec.kind!r}")

    def _deliver(self, records: list) -> None:
        """Stamp the namespace and enqueue one poll batch. Source 0 is
        the legacy namespace: records pass through object-identical (the
        single-source byte-compat path pays zero per-record work).

        With the latency plane armed, the batch is emit-stamped FIRST
        (this is the "source pump read" moment — ``protocol
        .stamp_records`` is write-once, so records a stamping collector
        already marked at pipe parse keep the earlier, truer stamp;
        an absorbed ``obs.stamp`` fire leaves the batch unstamped and
        delivery proceeds regardless), then namespace-stamped — the
        ``replace`` copies carry ``emit_ts`` through. Only the LEAD
        record is stamped: one pump read is one emit moment for the
        whole batch (``batcher.batch_emit_ts`` and the queue's
        provenance read exactly that), and a per-record loop at batch
        16k would cost ~4 ms/tick — past the 3% overhead budget — for
        zero extra information."""
        sid = self.spec.sid
        if self._stamp:
            stamp_records(records[:1], self._prov_clock())
        if sid:
            records = [replace(r, source=sid) for r in records]
        ok = self._queue.put(sid, records)
        with self._state_lock:
            self._ticks += 1
            self._emitted += len(records)
            if ok:
                self._records += len(records)
                self._last_put_at = self._clock()

    def _deliver_raw(self, data: bytes, n_records: int) -> None:
        """Raw-wire delivery: one wire-format blob per poll tick. The
        emit stamp rides the queue entry explicitly (``put_bytes``) —
        the provenance seam survives even though no record object
        exists host-side to stamp; an unstamped tier simply passes
        None. The namespace is NOT applied here: the consumer feeds the
        bytes to the C++ keyer under this source's id."""
        sid = self.spec.sid
        emit = self._prov_clock() if self._stamp else None
        ok = self._queue.put_bytes(sid, data, n_records, emit)
        with self._state_lock:
            self._ticks += 1
            self._emitted += n_records
            if ok:
                self._records += n_records
                self._last_put_at = self._clock()

    def _pace(self, first: bool) -> bool:
        """Gate one pull-paced emission; False when stopping. Lockstep
        waits for the consumer's credit (every tick, including the
        first); interval mode emits the first tick immediately and
        sleeps between the rest."""
        if self.spec.lockstep:
            while True:
                if self._stop_evt.is_set():
                    return False
                with self._state_lock:
                    due = self._credit_due
                    if due:
                        self._credit_due = False
                if due:
                    return not self._stop_evt.is_set()
                time.sleep(0.02)
        if first:
            return not self._stop_evt.is_set()
        if self.spec.interval > 0:
            return not self._stop_evt.wait(self.spec.interval)
        return not self._stop_evt.is_set()

    def _pump_capture(self) -> bool:
        from .replay import iter_capture, iter_capture_bytes

        if self._raw:
            for i, (data, n) in enumerate(
                iter_capture_bytes(self.spec.path)
            ):
                if not self._pace(first=i == 0):
                    return True  # stopped — clean
                fault_point("ingest.source_dead")
                self._deliver_raw(data, n)
            return True
        for i, tick in enumerate(iter_capture(self.spec.path)):
            if not self._pace(first=i == 0):
                return True  # stopped — clean
            fault_point("ingest.source_dead")
            self._deliver(tick)
        return True  # capture exhausted — clean end of stream

    def _pump_synthetic(self) -> bool:
        from .replay import SyntheticFlows

        syn = SyntheticFlows(
            n_flows=self.spec.n_flows, seed=self.spec.seed,
            mac_base=self.spec.mac_base, churn=self.spec.churn,
        )
        i = 0
        while self.spec.max_ticks <= 0 or i < self.spec.max_ticks:
            if not self._pace(first=i == 0):
                return True
            fault_point("ingest.source_dead")
            if self._raw:
                # straight to the wire format — per-record objects never
                # exist anywhere on the raw path (each record is one
                # line, so the newline count IS the record count)
                data = syn.tick_bytes()
                self._deliver_raw(data, data.count(b"\n"))
            else:
                self._deliver(syn.tick())
            i += 1
        return True

    def _pump_feed(self) -> bool:
        """Scripted wire-bytes source (scenario timelines): each poll
        tick hands the queue whatever ``spec.feed(tick_index)`` renders.
        ``None`` ends the stream (a clean death); ``b""`` is a silent
        tick — the pump delivers the one-newline noise line so a
        lockstep consumer still sees this source's batch for the tick
        (the parsers drop non-telemetry lines for free, and the queue
        counts the line as one emitted record, keeping the accounting
        identity exact). Raw tiers only: the script renders wire bytes,
        there is no record-object path to fall back to."""
        if not self._raw:
            raise ValueError(
                "feed sources render wire bytes — the fan-in tier must "
                "run raw (native ingest)"
            )
        gen = self.spec.feed
        if gen is None:
            raise ValueError("feed source needs spec.feed callable")
        i = 0
        while self.spec.max_ticks <= 0 or i < self.spec.max_ticks:
            if not self._pace(first=i == 0):
                return True
            fault_point("ingest.source_dead")
            data = gen(i)
            if data is None:
                return True  # script exhausted — clean end of stream
            if not data:
                data = b"\n"  # silent tick: one free-to-parse noise line
            self._deliver_raw(data, max(1, data.count(b"\n")))
            i += 1
        return True

    def _pump_cmd(self) -> bool:
        from .supervisor import SupervisedCollector

        coll = SupervisedCollector(
            self.spec.cmd, raw=self._raw,
            max_restarts=self.spec.max_restarts,
            metrics=self._metrics, recorder=self._recorder,
            # pipe-parse emit stamps on the reader thread: the truest
            # emission proxy (captures pipe→pump queue wait; _deliver's
            # write-once stamp then leaves these untouched). Raw mode
            # has no records to stamp — the pump-read moment rides the
            # queue entry instead (_deliver_raw).
            stamp=self._stamp and not self._raw,
        )
        with self._state_lock:
            self._coll = coll
        coll.start()
        try:
            while not self._stop_evt.is_set():
                rec = coll.wait_record(timeout=0.2)
                phase = coll.phase
                with self._state_lock:
                    self._restarts = coll.restarts
                    if self._state != SOURCE_DEAD:
                        self._state = (
                            SOURCE_RESTARTING if phase == "backoff"
                            else SOURCE_HEALTHY
                        )
                if rec is None:
                    if not coll.running:
                        break
                    continue
                fault_point("ingest.source_dead")
                time.sleep(0.05)  # let the 1 Hz burst of lines arrive
                if self._raw:
                    data = rec + b"".join(coll.poll_records())
                    # newline count bounds the record tally (noise lines
                    # included — the C++ parser does the real
                    # filtering). Floor 1: a pipe chunk ending mid-line
                    # can carry ZERO newlines, and a 0-record put would
                    # no-op — silently eating the fragment and tearing
                    # the engine's per-source tail framing.
                    self._deliver_raw(data, max(1, data.count(b"\n")))
                else:
                    self._deliver([rec, *coll.poll_records()])
            # clean iff we were stopped, or the monitor finished on
            # purpose — a restart-budget exhaustion is a real death
            return (
                self._stop_evt.is_set()
                or coll.terminal_reason != "restart-budget"
            )
        finally:
            coll.stop()


class FanInIngest:
    """The fan-in tier: owns N SourceWorkers, the MPSC queue, per-source
    supervision, and the quarantine→evict schedule.

    The serve loop drives ``ticks()`` (one merged record batch per serve
    tick) and calls ``take_evictions()`` each tick to learn which dead
    namespaces are due for eviction; the obs plane reads ``roster()``
    and ``alive()`` from its own thread. Supervision state shared across
    those threads lives under ``_roster_lock``."""

    def __init__(self, specs, queue_records: int = 1 << 16,
                 quarantine_s: float = 5.0, metrics=None, recorder=None,
                 clock=time.monotonic, stamp: bool = False,
                 prov_clock=time.perf_counter, raw: bool = False,
                 max_flaps: int = 5, flap_window_s: float = 60.0):
        specs = list(specs)
        sids = [s.sid for s in specs]
        if len(set(sids)) != len(sids):
            raise ValueError(f"duplicate source ids in specs: {sids}")
        if not specs:
            raise ValueError("fan-in tier needs at least one source")
        self.specs = specs
        self.quarantine_s = quarantine_s
        self._metrics = metrics
        self._recorder = recorder
        self._clock = clock
        # latency provenance (obs/latency.py): emit stamps at each
        # pump's _deliver + enq/deq stamps in the queue; the serve loop
        # drains pop_provenance() per assembled tick
        self._stamp = stamp
        self._prov_clock = prov_clock
        # raw-wire delivery (native ingest): every pump hands the queue
        # bytes, ticks() yields RawTick batches, and the namespace is
        # applied by the C++ keyer per (sid, payload) pair
        self.raw = raw
        self.queue = FanInQueue(
            queue_records, recorder=recorder, prov_clock=prov_clock,
            collect_provenance=stamp,
        )
        # guards the worker map and quarantine schedule: written by the
        # serve thread (supervision, restarts), read by the obs thread
        # (roster/healthz). Worker snapshots are taken OUTSIDE this lock
        # so it stays leaf-ordered above each worker's _state_lock.
        self._roster_lock = threading.Lock()
        self._workers: dict[int, SourceWorker] = {
            s.sid: SourceWorker(
                s, self.queue, metrics=metrics, recorder=recorder,
                clock=clock, stamp=stamp, prov_clock=prov_clock,
                raw=raw,
            )
            for s in specs
        }
        self._quarantine: dict[int, float] = {}  # sid → evict deadline
        self._dead_seen: set[int] = set()
        self._started = False
        # Flap escalation: a source flapping faster than quarantine_s
        # used to repeatedly cancel its pending quarantine via
        # restart_source — dying, restarting, dying again forever,
        # holding a namespace that never serves AND never evicts. After
        # ``max_flaps`` unclean deaths inside ``flap_window_s`` the sid
        # ESCALATES: further restarts are refused (unless forced), the
        # pending quarantine runs to completion, and the namespace
        # finally evicts. max_flaps=0 disables escalation.
        self.max_flaps = int(max_flaps)
        self.flap_window_s = float(flap_window_s)
        self._flap_times: dict[int, deque] = {}  # sid → unclean-death ts
        self._flaps: dict[int, int] = {}  # sid → lifetime unclean deaths
        self._escalated: set[int] = set()
        # records emitted by PRIOR incarnations of each sid: a restart
        # swaps in a fresh worker (emitted=0), but the accounting
        # identity emitted == accepted + (drops − purged) spans the
        # namespace's whole lifetime, so the roster folds this back in
        self._emitted_base: dict[int, int] = {}
        # tier events (source_deaths, source_restarts, ...), cumulative
        self.counters: dict[str, int] = {}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        with self._roster_lock:
            if self._started:
                return
            self._started = True
            workers = list(self._workers.values())
        for w in workers:
            w.start()

    def stop(self) -> None:
        with self._roster_lock:
            workers = list(self._workers.values())
        for w in workers:
            w.stop()
        for w in workers:
            w.join(timeout=5.0)

    def kill_source(self, sid: int) -> None:
        """Ops/test seam: kill one source mid-serve (unclean death —
        the quarantine path)."""
        with self._roster_lock:
            w = self._workers[sid]
        w.kill()

    def restart_source(self, sid: int, *, force: bool = False) -> bool:
        """Re-register a dead source into its OLD namespace: a fresh
        worker under the same source id produces the same flow keys, so
        its flows resume in their existing slots (cumulative counters →
        one large first delta, the supervisor-restart story). A pending
        quarantine is cancelled — the namespace is live again, evicting
        it would throw away state the restart just reclaimed.

        A flap-ESCALATED sid is refused (returns False, recorded as
        ``fanin.restart_refused``): cancelling its quarantine yet again
        is exactly the livelock escalation exists to break. ``force``
        is the operator override — it clears the escalation and the
        flap window, then restarts normally."""
        with self._roster_lock:
            escalated = sid in self._escalated
            if escalated and force:
                self._escalated.discard(sid)
                self._flap_times.pop(sid, None)
                escalated = False
        if escalated:
            if self._recorder is not None:
                self._recorder.record(
                    "fanin.restart_refused", source=sid,
                    cause="flap_escalated",
                )
            self._count("source_restarts_refused")
            return False
        with self._roster_lock:
            old = self._workers[sid]
        old.stop()
        old.join(timeout=5.0)
        emitted = old.snapshot()["emitted"]
        fresh = SourceWorker(
            old.spec, self.queue, metrics=self._metrics,
            recorder=self._recorder, clock=self._clock,
            stamp=self._stamp, prov_clock=self._prov_clock,
            raw=self.raw,
        )
        with self._roster_lock:
            self._quarantine.pop(sid, None)
            self._dead_seen.discard(sid)
            self._workers[sid] = fresh
            self._emitted_base[sid] = (
                self._emitted_base.get(sid, 0) + emitted
            )
            started = self._started
        if self.raw:
            # a restart can land BEFORE the quarantine evicts (it
            # cancels the pending quarantine above), so no eviction
            # poison fires — yet the dead worker's last pipe chunk may
            # have ended mid-line. The fresh worker's collector carries
            # no seam with that fragment; resync the consumer's tail
            # framing before the new stream's first chunk.
            self.queue.poison(sid)
        if self._recorder is not None:
            self._recorder.record("fanin.source_restart", source=sid)
        self._count("source_restarts")
        if started:
            fresh.start()
        return True

    # -- supervision -------------------------------------------------------
    def _supervise(self) -> None:
        """One supervision pass (serve thread): detect fresh unclean
        deaths and start their quarantine clocks."""
        with self._roster_lock:
            workers = list(self._workers.values())
        now = self._clock()
        for w in workers:
            if not w.dead_unclean:
                continue
            sid = w.spec.sid
            escalate = False
            flaps = 0
            with self._roster_lock:
                fresh = sid not in self._dead_seen
                if fresh:
                    self._dead_seen.add(sid)
                    self._quarantine[sid] = now + self.quarantine_s
                    # flap bookkeeping: every fresh unclean death is one
                    # flap; escalate once the windowed count hits the cap
                    self._flaps[sid] = self._flaps.get(sid, 0) + 1
                    flaps = self._flaps[sid]
                    if self.max_flaps > 0:
                        window = self._flap_times.setdefault(sid, deque())
                        window.append(now)
                        while window and window[0] < now - self.flap_window_s:
                            window.popleft()
                        if (len(window) >= self.max_flaps
                                and sid not in self._escalated):
                            self._escalated.add(sid)
                            escalate = True
            if fresh:
                self._count("source_deaths")
                if self._recorder is not None:
                    self._recorder.record(
                        "fanin.source_dead", source=sid,
                        name=w.spec.label,
                        quarantine_s=self.quarantine_s,
                    )
            if escalate:
                self._count("source_flap_escalations")
                if self._recorder is not None:
                    self._recorder.record(
                        "fanin.flap_escalated", source=sid,
                        flaps=flaps, window_s=self.flap_window_s,
                        max_flaps=self.max_flaps,
                    )

    def evictions_due(self) -> bool:
        """Whether a quarantine has expired (``take_evictions`` would
        return a sid), without taking it."""
        now = self._clock()
        with self._roster_lock:
            return any(now >= d for d in self._quarantine.values())

    def take_evictions(self) -> list[int]:
        """Sids whose quarantine expired since the last call — the serve
        loop evicts their namespaces (FlowStateEngine.evict_source).
        A sid stays pending until taken, so a caller that must defer
        (pipelined render in flight) simply asks again next tick. The
        sid's queued backlog is purged here: batches the dead source
        enqueued before dying must not be ingested after the eviction
        (they would re-create slots in a namespace nothing will ever
        quarantine again)."""
        now = self._clock()
        out: list[int] = []
        with self._roster_lock:
            for sid, deadline in list(self._quarantine.items()):
                if now >= deadline:
                    del self._quarantine[sid]
                    out.append(sid)
        for sid in out:
            self.queue.purge(sid)
            if self.raw:
                # the purge poisons only when it found queued byte
                # batches — but the consumer may have drained the dead
                # source's last chunk already, leaving its dangling
                # half line in the engine's per-source tail. Poison
                # unconditionally: eviction is the namespace boundary,
                # and anything the old incarnation left mid-line must
                # not be completed by a restarted stream's first chunk.
                self.queue.poison(sid)
        return out

    # -- serve-loop surface ------------------------------------------------
    @property
    def running(self) -> bool:
        """True while any source can still deliver or records remain
        queued — the serve loop's stream-end condition."""
        with self._roster_lock:
            workers = list(self._workers.values())
        return any(w.alive for w in workers) or self.queue.pending > 0

    def alive(self) -> bool:
        """Collector-probe shape for /healthz back-compat: the tier is
        'alive' while ANY source can still deliver telemetry (per-source
        detail lives in the roster)."""
        with self._roster_lock:
            workers = list(self._workers.values())
        return any(w.alive for w in workers)

    def ticks(self, tick_timeout: float = 2.0, poll_s: float = 0.02):
        """Yield one merged record batch per serve tick until every
        source ended and the queue drained — the generator cli's
        ``_tick_source`` plugs into the serve loop. Deterministic merge:
        batches are ordered by source id within a tick (slot assignment
        then depends only on the record streams, not thread timing)."""
        self.start()
        try:
            while True:
                batch = self._next_tick(tick_timeout, poll_s)
                if batch:
                    yield batch
                elif not self.running:
                    break
        finally:
            self.stop()

    def _next_tick(self, timeout: float, poll_s: float):
        """Assemble one serve tick: grant this tick's lockstep credits,
        then collect at most one batch per source until every live
        lockstep source delivered (or died), the timeout passed, or the
        stream ended. Interval-paced and push (cmd) sources ride along
        whenever their batches arrive."""
        with self._roster_lock:
            workers = list(self._workers.values())
        lockstep_pending: set[int] = set()
        for w in workers:
            if w.spec.lockstep and w.alive:
                w.grant()
                lockstep_pending.add(w.spec.sid)
        deadline = self._clock() + timeout
        got: list[tuple[int, list]] = []
        got_sids: set[int] = set()
        while True:
            self._supervise()
            for sid, recs in self.queue.take(exclude=got_sids):
                got_sids.add(sid)
                lockstep_pending.discard(sid)
                got.append((sid, recs))
            if lockstep_pending:
                # a lockstep source that died/ended between the grant
                # and its emission can never deliver — stop waiting
                with self._roster_lock:
                    live = {
                        sid for sid in lockstep_pending
                        if self._workers[sid].alive
                    }
                lockstep_pending = live
            if got and not lockstep_pending:
                break
            if self._clock() >= deadline:
                break
            if not self.running:
                break
            time.sleep(poll_s)
        if not got:
            return None
        # sid-sorted merge either way: slot assignment then depends only
        # on the record streams, not thread arrival timing
        got.sort(key=lambda b: b[0])
        if self.raw:
            self._publish_metrics()
            return RawTick(got)
        merged: list[TelemetryRecord] = []
        for _sid, recs in got:
            merged.extend(recs)
        self._publish_metrics()
        return merged

    # -- obs surface -------------------------------------------------------
    def pop_provenance(self) -> list[tuple]:
        """This tick's taken-batch provenance — ``(sid, emit, enq, deq,
        n)`` per batch consumed since the last call (obs/latency.py's
        ``begin_tick`` shape). Empty unless the tier was built with
        ``stamp=True``."""
        return self.queue.pop_provenance()

    def roster(self) -> list[dict]:
        """Per-source status rows (the JAX tier's /healthz roster and
        per-source gauges):
        id, state, lag since last delivery, drop/record counters, and
        the pending quarantine deadline when one is running."""
        drops = self.queue.drops()
        now = self._clock()
        with self._roster_lock:
            workers = sorted(
                self._workers.values(), key=lambda w: w.spec.sid
            )
            quarantine = dict(self._quarantine)
            flaps = dict(self._flaps)
            escalated = set(self._escalated)
            emitted_base = dict(self._emitted_base)
        out = []
        for w in workers:
            snap = w.snapshot()
            snap["drops"] = drops.get(w.spec.sid, 0)
            snap["emitted"] += emitted_base.get(w.spec.sid, 0)
            snap["flaps"] = flaps.get(w.spec.sid, 0)
            snap["escalated"] = w.spec.sid in escalated
            q = quarantine.get(w.spec.sid)
            if q is not None:
                snap["quarantine_expires_s"] = round(max(0.0, q - now), 3)
            out.append(snap)
        return out

    def _publish_metrics(self) -> None:
        """The per-tick gauges of the tier and of each source."""
        m = self._metrics
        if m is None:
            return
        roster = self.roster()
        m.set("fanin_sources", len(roster))
        m.set("fanin_queued_records", self.queue.pending)
        m.set(
            "fanin_sources_dead",
            sum(1 for r in roster if r["state"] == SOURCE_DEAD),
        )
        total_drops = 0
        for r in roster:
            sid = r["id"]
            m.set(f"source_{sid}_state", _STATE_CODE[r["state"]])
            m.set(f"source_{sid}_drops", r["drops"])
            m.set(f"source_{sid}_flaps", r["flaps"])
            total_drops += r["drops"]
            if r["lag_s"] is not None:
                m.set(f"source_{sid}_lag_s", r["lag_s"])
        m.set("fanin_records_dropped", total_drops)

    def _count(self, name: str) -> None:
        """One tier event: counted on ``counters`` (and on ``metrics``,
        when given)."""
        with self._roster_lock:
            self.counters[name] = self.counters.get(name, 0) + 1
        if self._metrics is not None:
            self._metrics.inc(name)


def specs_from_cli(source: str, n_sources: int, spec_texts, *,
                   capture: str | None = None,
                   monitor_cmd: str | None = None,
                   synthetic_flows: int = 1024, max_restarts: int = 5,
                   interval: float = 1.0, lockstep: bool = False,
                   max_ticks: int = 0) -> list[SourceSpec]:
    """Resolve the CLI's fan-in flags into SourceSpecs.

    Explicit ``--source-spec KIND:ARG`` entries win (mixed tiers, sids
    by position). Otherwise ``--sources N`` builds N homogeneous sources
    from the base ``--source``: synthetic splits the flow population
    into N disjoint namespaces (per-source seed and MAC space), replay
    plays the same capture into N namespaces, ryu/controller spawns N
    monitor subprocesses of the same command."""
    if spec_texts:
        return [
            parse_source_spec(
                t, sid, max_restarts=max_restarts, interval=interval,
                lockstep=lockstep,
            )
            for sid, t in enumerate(spec_texts)
        ]
    if n_sources < 1:
        raise ValueError("--sources must be >= 1")
    common = dict(max_restarts=max_restarts, interval=interval,
                  lockstep=lockstep)
    if source == "synthetic":
        per = max(1, synthetic_flows // n_sources)
        return [
            SourceSpec(kind="synthetic", sid=sid, n_flows=per, seed=sid,
                       mac_base=sid * per, max_ticks=max_ticks, **common)
            for sid in range(n_sources)
        ]
    if source == "replay":
        if not capture:
            raise ValueError("--source replay needs --capture FILE")
        return [
            SourceSpec(kind="capture", sid=sid, path=capture, **common)
            for sid in range(n_sources)
        ]
    if source in ("ryu", "controller"):
        if not monitor_cmd:
            raise ValueError(
                f"--sources with --source {source} needs the resolved "
                f"monitor command"
            )
        if n_sources > 1 and "{sid}" not in monitor_cmd:
            # N copies of the byte-identical command fight over the same
            # port/socket: N-1 of them flap through their restart
            # ladders into DEAD — broken by construction, so refuse
            raise ValueError(
                "N live sources need distinct monitor commands: put "
                "'{sid}' in --monitor-cmd (expanded to 0..N-1 per "
                "source) or use repeated --source-spec cmd:..."
            )
        return [
            SourceSpec(
                kind="cmd", sid=sid,
                cmd=monitor_cmd.replace("{sid}", str(sid)), **common,
            )
            for sid in range(n_sources)
        ]
    raise ValueError(f"--sources does not support --source {source}")
