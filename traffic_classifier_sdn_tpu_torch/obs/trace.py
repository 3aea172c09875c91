"""Span tracer — the port's copy of
``traffic_classifier_sdn_tpu/obs/trace.py``.

Named spans with a start and a duration, explicit nesting (a
thread-local stack) and two sinks wired at construction:

- a ``utils.metrics.Metrics`` registry: every completion is observed into
  the ``stage_<name>_s`` histogram, so ``--metrics-every`` and
  ``/metrics`` carry per-stage latency;
- an ``obs.flight_recorder.FlightRecorder``: every completion appends a
  ``span`` event (name, depth, parent, duration, error), which lets a
  post-mortem dump name the failing span.

A span measures host time between its enter and its exit. On the card a
launch returns before its kernel ends, so a span that closes right after
a launch times the launch, not the work: the serve loops close their
``predict`` spans after a synchronizing copy to the host (the device
stage's ``.cpu()``, the degrade ladder's device call), and add no sync
just to close a span (README, PERF.md).

Clock injection (``clock=time.perf_counter``) keeps the timing testable
without sleeps. ``span()`` never swallows an exception: the span
completes first, its event marked ``error=<type name>``.
"""

from __future__ import annotations

import threading
import time
from collections.abc import Callable
from dataclasses import dataclass, field


@dataclass
class Span:
    """One completed (or in-flight) named timing region."""

    name: str
    start: float
    depth: int = 0
    parent: str | None = None
    end: float | None = None
    error: str | None = None
    attrs: dict = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return (self.end - self.start) if self.end is not None else 0.0


class _SpanCtx:
    """Context manager returned by ``Tracer.span`` — a tiny hand-rolled
    class (not ``contextlib.contextmanager``) so entering a span does
    not allocate a generator per tick stage."""

    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: Tracer, span: Span):
        self._tracer = tracer
        self.span = span

    def __enter__(self) -> Span:
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._tracer._finish(self.span, exc_type)
        return False  # never swallow — the serve loop's policy decides


class Tracer:
    """Factory + sink wiring for spans.

    ``metrics`` and ``recorder`` are both optional: a Tracer with
    neither still tracks nesting (useful in tests), one with only
    ``metrics`` is the always-on serving default, and ``recorder``
    joins when the flight recorder is enabled. The span stack is
    thread-local, so concurrent threads (collector reader vs serve
    loop) each get their own nesting without locking the hot path —
    the recorder's ring does its own locking at the append.
    """

    METRIC_PREFIX = "stage_"

    def __init__(self, metrics=None, recorder=None,
                 clock: Callable[[], float] = time.perf_counter):
        self.metrics = metrics
        self.recorder = recorder
        self.clock = clock
        self._local = threading.local()

    def _stack(self) -> list[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, **attrs) -> _SpanCtx:
        """Open a nested span; use as ``with tracer.span("predict"):``."""
        stack = self._stack()
        parent = stack[-1].name if stack else None
        s = Span(
            name=name, start=self.clock(), depth=len(stack),
            parent=parent, attrs=attrs,
        )
        stack.append(s)
        return _SpanCtx(self, s)

    def current(self) -> Span | None:
        """The innermost open span on this thread (None outside spans)."""
        stack = self._stack()
        return stack[-1] if stack else None

    def _finish(self, span: Span, exc_type) -> None:
        span.end = self.clock()
        if exc_type is not None:
            span.error = exc_type.__name__
        stack = self._stack()
        # the common case is a perfectly nested pop; tolerate a caller
        # finishing out of order rather than corrupting the stack
        if stack and stack[-1] is span:
            stack.pop()
        elif span in stack:
            stack.remove(span)
        if self.metrics is not None:
            # the pipeline's stage-boundary spans are named "stage.host"/
            # "stage.device" (serving/pipeline.py); strip the family
            # prefix so their histograms land as stage_host_s rather
            # than the double-prefixed stage_stage.host_s
            base = span.name
            if base.startswith("stage."):
                base = base[len("stage."):]
            self.metrics.observe(
                f"{self.METRIC_PREFIX}{base}_s", span.duration
            )
        if self.recorder is not None:
            self.recorder.record(
                "span",
                name=span.name,
                parent=span.parent,
                depth=span.depth,
                duration_s=span.duration,
                error=span.error,
                **span.attrs,
            )
