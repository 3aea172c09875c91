"""Live telemetry collector: runs the OpenFlow monitor as a subprocess and
streams its line protocol without blocking the classify loop — the port's
copy of ``traffic_classifier_sdn_tpu/ingest/collector.py``.

The reference blocks on ``p.stdout.readline()`` in its single thread
(traffic_classifier.py:147-149), coupling telemetry arrival to classify
latency. Here a reader thread drains the pipe into a queue and the classify
loop takes whatever has arrived per tick.

Works with any command emitting the protocol: the real Ryu monitor
(``sudo ryu run simple_monitor_13.py``, reference traffic_classifier.py:22),
a script printing capture lines, or ``cat`` of a capture file.
"""

from __future__ import annotations

import os
import queue
import signal
import subprocess
import threading
import time

from ..utils.faults import FaultInjected, fault_bytes
from .protocol import TelemetryRecord, parse_line, stamp_records

# The reference's monitor launch command (traffic_classifier.py:22).
DEFAULT_MONITOR_CMD = "sudo ryu run simple_monitor_13.py"


class SubprocessCollector:
    """Spawn a monitor command and iterate parsed records."""

    def __init__(self, cmd: str = DEFAULT_MONITOR_CMD, queue_size: int = 1 << 16,
                 raw: bool = False, recorder=None, stamp: bool = False,
                 prov_clock=time.perf_counter):
        """``raw=True`` queues raw pipe chunks (bytes) instead of parsed
        TelemetryRecords — the zero-Python-per-line path for the native
        C++ engine (FlowStateEngine.ingest_bytes). ``recorder`` (any
        object with ``record(event, **fields)``) receives a structured
        event per dropped-line burst, so a post-mortem shows where
        telemetry was lost. ``stamp=True`` emit-stamps each parsed record
        on the reader thread at pipe-parse time (raw mode has no records
        to stamp)."""
        self.cmd = cmd
        self.raw = raw
        self._stamp = stamp and not raw
        self._prov_clock = prov_clock
        self._recorder = recorder  # set once here, read-only afterwards
        self._queue: queue.Queue = queue.Queue(maxsize=queue_size)
        self._proc: subprocess.Popen | None = None
        self._thread: threading.Thread | None = None
        # Written by the reader thread, read by the classify loop and
        # the supervisor's drain: every access holds _drop_lock (an
        # unlocked += is two interpreter ops and can lose increments
        # under free-threaded builds or a mid-statement drain).
        self._drop_lock = threading.Lock()
        self._lines_dropped = 0
        # The reader thread's fault path calls stop(), which writes
        # self._proc = None while the classify loop may be inside
        # running/returncode/stop polling the same handle — a TOCTOU
        # that turns into AttributeError on .pid/.poll. Every _proc
        # access snapshots the handle under this lock; the Popen object
        # itself is thread-safe to poll once you hold a reference.
        self._proc_lock = threading.Lock()
        # stop() is terminal for this collector object (the supervisor
        # spawns a fresh one per incarnation): the flag closes the
        # spawn-vs-stop race now that start() spawns outside the lock
        self._stopped = False

    def start(self) -> None:
        # spawn OUTSIDE the lock: fork/exec can stall on a loaded host,
        # and _proc_lock is taken by running/returncode/stop from other
        # threads — only the handle PUBLICATION needs the lock
        proc = subprocess.Popen(
            self.cmd,
            shell=True,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            preexec_fn=os.setsid,
        )
        with self._proc_lock:
            published = not self._stopped
            if published:
                self._proc = proc
        if not published:
            # a concurrent stop() won the race while we were spawning:
            # the fresh monitor must not outlive it un-tracked — and
            # with no reader thread coming, WE must close the pipe and
            # reap the child (else: leaked fd + zombie until exit)
            self._kill_group(proc)
            if proc.stdout is not None:
                proc.stdout.close()
            try:
                proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass  # SIGTERM ignored: unreaped, but not our hang
            return
        self._thread = threading.Thread(target=self._reader, daemon=True)
        self._thread.start()

    def _reader(self) -> None:
        with self._proc_lock:
            proc = self._proc
        assert proc is not None and proc.stdout is not None
        if self.raw:
            stream = proc.stdout
            drop_seam = False
            while True:
                chunk = stream.read1(1 << 16)
                if not chunk:
                    break
                try:
                    # chaos seam (utils/faults "collector.read"):
                    # "truncate" loses the chunk's tail mid-record — the
                    # same framing hazard as a queue drop, so it poisons
                    # the seam to the NEXT chunk; "raise" kills the
                    # monitor mid-stream (the pipe dies with it),
                    # exercising the supervisor's death→drain→restart path
                    short = fault_bytes("collector.read", chunk)
                except FaultInjected:
                    self.stop()
                    return
                truncated = len(short) != len(chunk)
                if truncated:
                    lost = chunk.count(b"\n") - short.count(b"\n")
                    with self._drop_lock:
                        self._lines_dropped += lost
                    if self._recorder is not None:
                        self._recorder.record(
                            "collector.drop", cause="truncated_chunk",
                            lines=lost,
                        )
                    chunk = short
                if drop_seam:
                    # a dropped/truncated chunk broke line framing: poison
                    # the seam so the fragments on either side of the gap
                    # can't splice into one corrupted-but-parseable
                    # record. A bare "\n" is not enough — it would
                    # *terminate* the pre-gap partial line, letting a
                    # truncated counter parse as a smaller valid value
                    # (garbage negative delta). The NUL makes the pre-gap
                    # fragment unparseable (fails the data-prefix match /
                    # int parse), mirroring the supervisor's restart
                    # poison seam.
                    chunk = b"\x00\n" + chunk
                try:
                    self._queue.put_nowait(chunk)
                    drop_seam = truncated
                except queue.Full:
                    lost = chunk.count(b"\n")
                    with self._drop_lock:
                        self._lines_dropped += lost
                    if self._recorder is not None:
                        self._recorder.record(
                            "collector.drop", cause="queue_full",
                            lines=lost,
                        )
                    drop_seam = True
            return
        for line in proc.stdout:
            r = parse_line(line)
            if r is None:
                continue
            if self._stamp:
                # per line, reader-thread-side: an absorbed obs.stamp
                # fire leaves the record unstamped, never undelivered
                stamp_records((r,), self._prov_clock())
            try:
                self._queue.put_nowait(r)
            except queue.Full:
                # back-pressure: drop oldest-style accounting, keep newest
                with self._drop_lock:
                    self._lines_dropped += 1
                if self._recorder is not None:
                    self._recorder.record(
                        "collector.drop", cause="queue_full", lines=1,
                    )

    @property
    def lines_dropped(self) -> int:
        """Lines lost to queue overflow or injected truncation (same
        counter the pre-lock attribute exposed; the reader thread owns
        the writes, so reads synchronize on the same lock)."""
        with self._drop_lock:
            return self._lines_dropped

    def poll_records(self, max_records: int = 1 << 20) -> list[TelemetryRecord]:
        """Drain whatever has arrived (non-blocking)."""
        out = []
        try:
            while len(out) < max_records:
                out.append(self._queue.get_nowait())
        except queue.Empty:
            pass
        return out

    def wait_record(self, timeout: float) -> TelemetryRecord | None:
        try:
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            return None

    @property
    def running(self) -> bool:
        with self._proc_lock:
            proc = self._proc
        return proc is not None and proc.poll() is None

    @property
    def returncode(self) -> int | None:
        """Exit status of the monitor process (None while running or
        before start)."""
        with self._proc_lock:
            proc = self._proc
        return proc.poll() if proc is not None else None

    @property
    def finished(self) -> bool:
        """Process exited AND the reader thread has drained the pipe to
        EOF — only then is every line the monitor ever wrote in the
        queue. Supervisors must wait for this, not just ``not running``:
        a fast monitor (cat of a capture) exits while megabytes are
        still in flight in the pipe."""
        if self.running:
            return False
        t = self._thread
        return t is None or not t.is_alive()

    def stop(self) -> None:
        """Terminate the monitor's process group (the reference's
        ``os.killpg`` teardown at traffic_classifier.py:222). Terminal:
        a start() racing this stop sees ``_stopped`` and kills its own
        fresh spawn instead of publishing it."""
        with self._proc_lock:
            self._stopped = True
            proc, self._proc = self._proc, None
        if proc is not None:
            self._kill_group(proc)

    @staticmethod
    def _kill_group(proc) -> None:
        if proc.poll() is None:
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
            except ProcessLookupError:
                pass

    def drain(self) -> list:
        """All queued items (records or raw chunks), non-blocking."""
        return self.poll_records()
