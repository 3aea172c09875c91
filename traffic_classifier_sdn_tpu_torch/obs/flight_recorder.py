"""Flight recorder: the last N structured events, dumpable post-mortem —
the port's copy of ``traffic_classifier_sdn_tpu/obs/flight_recorder.py``.

A bounded, lock-guarded ring holds the newest structured events: span
completions (``obs.trace.Tracer``), monitor deaths and restarts
(``ingest/supervisor.py``), fan-in source events (``ingest/fanin.py``),
ladder transitions and probes (``serving/degrade.py``), checkpoint saves,
skips and rollbacks (``cli.py``, ``io/serving_checkpoint.py``) and
fault-site fires (``utils.faults.add_observer``). When the serve loop dies
(an unhandled exception, SIGTERM) the CLI dumps the ring as JSONL: a
``meta`` line naming the reason, then one event per line, newest last.

- **Bounded:** ``deque(maxlen=capacity)``.
- **Thread-safe:** events come from the serve loop, the device stage, the
  collector's reader thread and the exposition thread; every ring access
  holds ``_lock``, and per-recorder sequence numbers order the dump.
- **Crash-ordered:** ``dump`` serializes under the lock, then writes with
  ``utils.atomicio.atomic_write_bytes``.
- **Self-limiting values:** fields are forced JSON-serializable at record
  time (``repr`` fallback), so a dump never fails on a payload.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

from ..utils import faults
from ..utils.atomicio import atomic_write_bytes

_JSON_SCALARS = (str, int, float, bool, type(None))


def _jsonable(value):
    """Clamp a field value to something json.dumps cannot refuse."""
    if isinstance(value, _JSON_SCALARS):
        return value
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    return repr(value)


class FlightRecorder:
    """Bounded ring of recent structured events.

    ``clock`` injects the wall-clock source (``time.time``) so tests
    can pin timestamps; sequence numbers are monotonic regardless.
    """

    def __init__(self, capacity: int = 4096, clock=time.time):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._seq = 0
        self._dropped = 0  # events displaced by the bound (lifetime)

    # -- write --------------------------------------------------------------
    def record(self, kind: str, **fields) -> None:
        """Append one event; never raises on payload content."""
        event = {"kind": kind, "ts": self._clock()}
        for k, v in fields.items():
            event[k] = _jsonable(v)
        with self._lock:
            event["seq"] = self._seq
            self._seq += 1
            if len(self._ring) == self.capacity:
                self._dropped += 1
            self._ring.append(event)

    def fault_observer(self, site: str, hit: int, kind: str) -> None:
        """``utils.faults`` observer signature — register with
        ``faults.add_observer(recorder.fault_observer)`` so every fault
        firing lands in the ring with its site, hit count, and kind."""
        self.record("fault.fire", site=site, hit=hit, fault_kind=kind)

    def observing_faults(self):
        """Scoped registration as a context manager — the serve loop's
        idiom; always detaches so a finished run cannot leak an
        observer into the next (the registry is process-global)."""
        return faults.observing(self.fault_observer)

    # -- read ---------------------------------------------------------------
    def tail(self, n: int | None = None) -> list[dict]:
        """The newest ``n`` events (all when None), oldest first."""
        with self._lock:
            events = list(self._ring)
        if n is None:
            return events
        # n == 0 must mean "no events": events[-0:] is the WHOLE list
        return events[-n:] if n > 0 else []

    def count(self, kind: str | None = None) -> int:
        """Events currently in the ring (optionally of one kind)."""
        with self._lock:
            if kind is None:
                return len(self._ring)
            return sum(1 for e in self._ring if e["kind"] == kind)

    @property
    def events_seen(self) -> int:
        """Lifetime recorded count (ring length + displaced)."""
        with self._lock:
            return self._seq

    # -- post-mortem --------------------------------------------------------
    def dump(self, directory: str, reason: str) -> str:
        """Write the ring as a JSONL post-mortem into ``directory``.

        One event per line, oldest first, preceded by a ``meta`` line
        (reason, event count, ring displacement). The filename embeds
        the dump reason and this recorder's sequence frontier, so
        repeated dumps from one process never collide. Returns the
        written path."""
        events = self.tail()
        meta = {
            "kind": "meta",
            "reason": reason,
            "dumped_at": self._clock(),
            "events": len(events),
            "displaced": self._dropped,
            "pid": os.getpid(),
        }
        lines = [json.dumps(meta, sort_keys=True)]
        lines.extend(json.dumps(e, sort_keys=True) for e in events)
        payload = ("\n".join(lines) + "\n").encode()
        os.makedirs(directory, exist_ok=True)
        safe_reason = "".join(
            c if c.isalnum() or c in "-_." else "-" for c in reason
        )
        path = os.path.join(
            directory,
            f"flightrec-{os.getpid()}-{self._seq:08d}-{safe_reason}.jsonl",
        )
        # atomic: a torn post-mortem that parses halfway is worse than
        # none — the committed file is always complete
        atomic_write_bytes(path, payload)
        return path


def dump_metrics_snapshot(metrics, directory: str, reason: str) -> str:
    """Freeze a ``utils.metrics.Metrics`` snapshot as one JSON file in
    ``directory`` — the metrics half of the on-demand (SIGUSR1) dump:
    a flight-recorder JSONL answers *what happened*, this answers
    *what the counters and latency quantiles said when it did*.
    Same discipline as ``FlightRecorder.dump``: atomic write, reason
    embedded in the filename, repeated dumps never collide (the
    monotonic-ns suffix orders them)."""
    snap = metrics.snapshot()
    payload = json.dumps(
        {"kind": "metrics", "reason": reason, "snapshot": snap},
        sort_keys=True, default=repr,
    ).encode()
    os.makedirs(directory, exist_ok=True)
    safe_reason = "".join(
        c if c.isalnum() or c in "-_." else "-" for c in reason
    )
    path = os.path.join(
        directory,
        f"metrics-{os.getpid()}-{time.monotonic_ns()}-{safe_reason}.json",
    )
    atomic_write_bytes(path, payload)
    return path
