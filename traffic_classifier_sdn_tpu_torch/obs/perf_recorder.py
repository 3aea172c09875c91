"""Black-box perf recorder: a bounded ON-DISK ring of per-tick samples.

The flight recorder (obs/flight_recorder.py) answers "what happened in
the 2 s before it died" — but only if something dumps the ring, and a
wedged process never reaches its own dump path.
This module is the crash-proof complement: per-tick samples (stage
timings, dirty-row counts, queue depths, degrade/drift states,
compile/HBM readings) accumulate in memory and commit to disk as whole
segments — ``perf-<seq:08d>.jsonl`` — via the same atomic temp+fsync+
rename discipline as the serving-checkpoint rotation. kill -9 at ANY
instant loses at most the in-memory partial segment; every committed
segment on disk is complete and parseable, so a wedge of hours leaves
hours of per-tick evidence with no cooperation from the dying process.

The port's copy of ``traffic_classifier_sdn_tpu/obs/perf_recorder.py``:
the segment format is the JAX package's byte for byte (``json.dumps``
with sorted keys, fields through the flight recorder's ``_jsonable``), so
each package's ``replay()`` reads the other's ring.

Design constraints:

- **torch-free.** The write path is pure stdlib — a wedged device
  runtime (the exact failure this records) can never wedge the recorder
  too.
- **Bounded.** At most ``keep_segments`` committed segments; older ones
  are pruned after each commit, so a week-long serve holds
  ``keep_segments × ticks_per_segment`` ticks of evidence and no more.
- **Absorbing.** A failed segment commit (fault site ``obs.perf_ring``,
  or a real ENOSPC) drops that segment with a counter
  (``perf_ring_dropped_segments``) and never surfaces to the serve
  tick — the black box must not stall the plane it records.
- **Leaf lock.** ``_lock`` guards only the in-memory buffer and
  counters; all file I/O happens strictly after release (single
  committer: the serve loop). Restarts resume numbering above the
  surviving segments so oldest-first order spans incarnations.

``replay(directory)`` is the forensic reader: every committed segment,
oldest first, as one sample list — it raises on a torn line, because
the atomic commit makes torn committed bytes a real bug, not weather.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time

from ..utils import faults
from ..utils.atomicio import atomic_write_bytes, sweep_stale_tmp
from .flight_recorder import _jsonable

_SEGMENT_RE = re.compile(r"^perf-(\d{8})\.jsonl$")


def segment_files(directory: str) -> list[tuple[int, str]]:
    """Committed ``(seq, path)`` pairs in ``directory``, oldest first."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    out = []
    for name in names:
        m = _SEGMENT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort()
    return out


def replay(directory: str) -> list[dict]:
    """Parse every committed segment, oldest first, into one flat list
    of samples (``meta`` lines skipped). Strict: a line that fails to
    parse raises — committed segments are published atomically, so torn
    committed bytes mean a durability bug, and the forensic reader must
    say so rather than silently shorten the evidence."""
    samples = []
    for _, path in segment_files(directory):
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                event = json.loads(line)
                if event.get("kind") != "meta":
                    samples.append(event)
    return samples


class PerfRecorder:
    """Per-tick sample sink with atomic whole-segment rotation.

    ``record`` buffers one sample; every ``ticks_per_segment`` samples
    the buffer commits as the next segment file. ``flush`` commits a
    partial buffer (shutdown / dump paths). Single committer assumed
    (the serve loop); ``tail`` may be called from the exposition thread.
    """

    def __init__(self, directory: str, *, ticks_per_segment: int = 64,
                 keep_segments: int = 16, metrics=None, clock=time.time):
        if ticks_per_segment <= 0:
            raise ValueError(
                f"ticks_per_segment must be positive, got {ticks_per_segment}"
            )
        if keep_segments <= 0:
            raise ValueError(
                f"keep_segments must be positive, got {keep_segments}"
            )
        self.directory = os.path.abspath(directory)
        self.ticks_per_segment = int(ticks_per_segment)
        self.keep_segments = int(keep_segments)
        self._metrics = metrics
        self._clock = clock
        self._lock = threading.Lock()
        self._buf: list[dict] = []
        self._committed = 0
        self._dropped = 0
        self._last_segment: int | None = None
        os.makedirs(self.directory, exist_ok=True)
        # a kill -9 mid-commit cannot run atomicio's finally — collect
        # the orphaned temp the previous incarnation left behind
        sweep_stale_tmp(self.directory)
        existing = segment_files(self.directory)
        self._seq = existing[-1][0] + 1 if existing else 0

    # -- write --------------------------------------------------------------
    def record(self, sample: dict) -> None:
        """Buffer one per-tick sample; commits a full segment in-line
        (outside the lock) when the buffer reaches the segment size."""
        event = {"ts": self._clock()}
        for k, v in sample.items():
            event[k] = _jsonable(v)
        with self._lock:
            self._buf.append(event)
            if len(self._buf) < self.ticks_per_segment:
                return
            batch, self._buf = self._buf, []
            seq = self._seq
            self._seq += 1
        self._commit(seq, batch)

    def flush(self) -> str | None:
        """Commit the partial buffer as its own segment (None if empty).
        The shutdown/dump-path call — after it, every recorded sample
        is on disk."""
        with self._lock:
            if not self._buf:
                return None
            batch, self._buf = self._buf, []
            seq = self._seq
            self._seq += 1
        return self._commit(seq, batch)

    def _commit(self, seq: int, batch: list[dict]) -> str | None:
        meta = {
            "kind": "meta",
            "segment": seq,
            "samples": len(batch),
            "pid": os.getpid(),
            "committed_at": self._clock(),
        }
        lines = [json.dumps(meta, sort_keys=True)]
        lines.extend(json.dumps(e, sort_keys=True) for e in batch)
        payload = ("\n".join(lines) + "\n").encode()
        path = os.path.join(self.directory, f"perf-{seq:08d}.jsonl")
        try:
            faults.fault_point("obs.perf_ring")
            atomic_write_bytes(path, payload)
        except (faults.FaultInjected, OSError):
            # ABSORBED: the black box must never stall the serve — the
            # segment's samples are lost, the loss is counted, and the
            # next segment starts clean
            with self._lock:
                self._dropped += 1
            if self._metrics is not None:
                self._metrics.inc("perf_ring_dropped_segments")
            return None
        for _, old_path in segment_files(self.directory)[:-self.keep_segments]:
            try:
                os.unlink(old_path)
            except OSError:
                pass
        with self._lock:
            self._committed += 1
            self._last_segment = seq
        if self._metrics is not None:
            self._metrics.inc("perf_ring_segments")
        return path

    # -- read ---------------------------------------------------------------
    def tail(self, n: int) -> list[dict]:
        """The newest ``n`` samples, oldest first — in-memory buffer
        first, then committed segments newest-backwards as needed (the
        SIGUSR1 / post-mortem dump view)."""
        if n <= 0:
            return []
        with self._lock:
            out = list(self._buf)[-n:]
        need = n - len(out)
        if need > 0:
            older: list[dict] = []
            for _, path in reversed(segment_files(self.directory)):
                try:
                    with open(path, encoding="utf-8") as f:
                        seg = [
                            json.loads(ln) for ln in f if ln.strip()
                        ]
                except (OSError, ValueError):
                    continue  # dump path: tolerate, the strict reader is replay()
                older = [e for e in seg if e.get("kind") != "meta"] + older
                if len(older) >= need:
                    break
            out = older[-need:] + out
        return out

    def status(self) -> dict:
        with self._lock:
            return {
                "directory": self.directory,
                "buffered": len(self._buf),
                "segments_committed": self._committed,
                "segments_dropped": self._dropped,
                "last_segment": self._last_segment,
                "ticks_per_segment": self.ticks_per_segment,
                "keep_segments": self.keep_segments,
            }
