"""Failure detection and elastic recovery for the telemetry source — the
port's copy of ``traffic_classifier_sdn_tpu/ingest/supervisor.py``.

The reference's failure handling is one ``p.poll()`` check that breaks
the ingest loop (traffic_classifier.py:150-151) — a dead monitor ends the
run. Here a supervisor wraps SubprocessCollector with crash detection,
exponential-backoff restart, and a restart budget, so a wedged or killed
monitor (controller crash, Ryu OOM, switch flap) costs seconds of
telemetry instead of the whole session. Flow state survives restarts: the
device flow table and the C++/Python flow index live in the classifier
process, and counters in the protocol are cumulative, so a restarted
monitor's first poll simply produces one large delta per flow (the same
thing the reference would see after a missed poll).

Restart semantics:
- a monitor that exits **0** finished on purpose (``cat capture.txt``,
  a bounded fake monitor) — no restart, the source just ends
- nonzero exit / signal death → restart after exponential backoff, up to
  ``max_restarts`` times
- records still queued at death are preserved and served before the new
  incarnation's output; in raw mode a ``b"\\x00\\n"`` poison-seam is
  injected so the dead monitor's trailing partial line is rejected by
  the parser (a bare newline would *complete* a truncated record) and
  can never splice with the first chunk of the new one (same framing
  hazard SubprocessCollector._reader guards against on queue overflow)
"""

from __future__ import annotations

import time
from collections import deque

from ..utils.faults import FaultInjected, fault_point
from .collector import SubprocessCollector


class SupervisedCollector:
    """SubprocessCollector with restart-on-crash and backoff.

    Same surface the CLI uses (start/stop/wait_record/poll_records/
    running/lines_dropped) so it drops into _tick_source unchanged.

    ``clock`` injects a monotonic time source so tests can assert the
    exact backoff schedule (base·2^restarts, capped) and the budget
    exhaustion path without real sleeps.
    """

    def __init__(self, cmd: str, raw: bool = False, max_restarts: int = 5,
                 backoff_base: float = 0.5, backoff_cap: float = 30.0,
                 metrics=None, clock=time.monotonic, recorder=None,
                 stamp: bool = False):
        self.cmd = cmd
        self.raw = raw
        # latency-provenance emit stamping, forwarded to every
        # collector incarnation
        self.stamp = stamp
        self.max_restarts = max_restarts
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.restarts = 0
        self._metrics = metrics
        self._clock = clock
        # event recorder (``record(event, **fields)``): monitor deaths,
        # restarts, and terminal failure become structured events so a
        # post-mortem shows the supervision ladder's last steps
        self._recorder = recorder
        self._collector: SubprocessCollector | None = None
        self._next_restart_at = 0.0
        self._done = False  # clean exit or budget exhausted
        self._stopped = False  # explicit stop(): terminal, overrides all
        self._carryover: deque = deque()  # preserved across restarts
        self._dropped_prior = 0  # lines_dropped from dead incarnations
        # why the supervision ended (None while live): "clean-exit" for
        # a monitor that exited 0, "restart-budget" once the ladder is
        # exhausted, "stopped" for an explicit stop() — tells a finished
        # source from a crashed one.
        self.terminal_reason: str | None = None

    # -- lifecycle ---------------------------------------------------------
    def _spawn(self) -> SubprocessCollector:
        """Collector factory — the seam chaos tests override to script
        incarnation lifecycles without real subprocesses."""
        return SubprocessCollector(
            self.cmd, raw=self.raw, recorder=self._recorder,
            stamp=self.stamp,
        )

    def start(self) -> None:
        self._collector = self._spawn()
        self._collector.start()

    def stop(self) -> None:
        """Terminal: ``running`` is False from here on, and ``_check``
        will never resurrect the monitor (without ``_done`` a subsequent
        ``wait_record`` would see a killed collector and restart it)."""
        self._done = True
        self._stopped = True
        if self.terminal_reason is None:
            self.terminal_reason = "stopped"
        if self._collector is not None:
            self._collector.stop()

    @property
    def lines_dropped(self) -> int:
        now = self._collector.lines_dropped if self._collector else 0
        return self._dropped_prior + now

    @property
    def running(self) -> bool:
        """True while the monitor runs OR a restart is still possible OR
        preserved records remain — the caller's loop condition. An
        explicit ``stop()`` is terminal regardless (preserved records
        stay drainable via ``poll_records``, but a caller polling
        ``running`` as its loop condition must terminate)."""
        if self._stopped:
            return False
        if self._carryover:
            return True
        if self._collector is not None and self._collector.running:
            return True
        return not self._done

    @property
    def phase(self) -> str:
        """Coarse supervision phase for per-source state reporting:
        ``running`` while the current monitor
        incarnation is alive, ``backoff`` between a death and its
        restart, ``done`` once supervision ended (clean exit, budget
        exhaustion, or explicit stop — ``terminal_reason`` says which).
        Reads only what the caller's own poll thread mutates, so it is
        safe from the thread that drives wait_record/poll_records."""
        if self._stopped or self._done:
            return "done"
        if self._collector is not None and self._collector.running:
            return "running"
        return "backoff"

    # -- supervision -------------------------------------------------------
    def _check(self) -> None:
        """Detect a dead monitor and restart it after backoff.

        Death is declared only once the collector is ``finished`` — the
        process exited AND its reader thread hit pipe EOF — so the drain
        below is complete by construction (no race with late chunks: a
        fast monitor can exit while most of its output is still in the
        pipe buffer). The dead incarnation is torn down immediately and
        exactly once, which also keeps lines_dropped single-counted."""
        if self._done:
            return
        c = self._collector
        now = self._clock()
        if c is not None:
            if not c.finished:
                return  # alive, or reader still draining the pipe
            self._carryover.extend(c.drain())
            self._dropped_prior += c.lines_dropped
            rc = c.returncode
            if self.raw:
                # poison + seam: a NUL makes the dead monitor's trailing
                # partial line unparseable (a bare \n would *complete* a
                # truncated record, e.g. a half-written byte counter),
                # and the \n stops it splicing with the new monitor's
                # first bytes
                self._carryover.append(b"\x00\n")
            c.stop()
            self._collector = None
            if rc == 0:
                self._done = True
                self.terminal_reason = "clean-exit"
                if self._recorder is not None:
                    self._recorder.record(
                        "monitor.clean_exit",
                        lines_dropped=self._dropped_prior,
                    )
                return
            if self._recorder is not None:
                self._recorder.record(
                    "monitor.death", returncode=rc,
                    restarts=self.restarts,
                    lines_dropped=self._dropped_prior,
                )
            if self.restarts >= self.max_restarts:
                self._done = True
                self.terminal_reason = "restart-budget"
                if self._recorder is not None:
                    self._recorder.record(
                        "supervisor.terminal",
                        reason="restart budget exhausted",
                        restarts=self.restarts,
                        max_restarts=self.max_restarts,
                        lines_dropped=self._dropped_prior,
                    )
                return
            delay = min(
                self.backoff_cap, self.backoff_base * (2 ** self.restarts)
            )
            self._next_restart_at = now + delay
            if self._metrics is not None:
                self._metrics.inc("monitor_deaths")
            return
        # collector already torn down: waiting out the backoff
        if now < self._next_restart_at:
            return
        self._next_restart_at = 0.0
        self.restarts += 1
        if self._metrics is not None:
            self._metrics.inc("monitor_restarts")
        if self._recorder is not None:
            self._recorder.record(
                "monitor.restart", attempt=self.restarts,
                max_restarts=self.max_restarts,
            )
        try:
            fault_point("supervisor.restart")
            self.start()
        except (FaultInjected, OSError, RuntimeError) as e:
            # spawn failure — injected (chaos) or real (Popen EMFILE/
            # ENOMEM, Thread.start): the attempt consumed a budget slot;
            # either give up (budget spent) or back off and try again —
            # the same ladder a crashing incarnation climbs
            if not isinstance(e, FaultInjected):
                import sys

                print(f"WARNING: monitor restart failed: {e}",
                      file=sys.stderr)
            self._collector = None
            if self._recorder is not None:
                self._recorder.record(
                    "monitor.spawn_failed", attempt=self.restarts,
                    error=type(e).__name__, detail=str(e),
                )
            if self.restarts >= self.max_restarts:
                self._done = True
                self.terminal_reason = "restart-budget"
                if self._recorder is not None:
                    self._recorder.record(
                        "supervisor.terminal",
                        reason="restart budget exhausted (spawn failure)",
                        restarts=self.restarts,
                        max_restarts=self.max_restarts,
                        lines_dropped=self._dropped_prior,
                    )
                return
            self._next_restart_at = now + min(
                self.backoff_cap, self.backoff_base * (2 ** self.restarts)
            )

    # -- collector surface -------------------------------------------------
    def wait_record(self, timeout: float):
        self._check()
        if self._carryover:
            return self._carryover.popleft()
        if self._collector is None:
            time.sleep(min(timeout, 0.05))
            return None
        rec = self._collector.wait_record(timeout=timeout)
        if rec is None:
            self._check()
            if self._carryover:
                return self._carryover.popleft()
        return rec

    def poll_records(self, max_records: int = 1 << 20):
        out = []
        while self._carryover and len(out) < max_records:
            out.append(self._carryover.popleft())
        if self._collector is not None and len(out) < max_records:
            out.extend(self._collector.poll_records(max_records - len(out)))
        return out
