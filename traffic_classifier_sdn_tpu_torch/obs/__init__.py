"""Observability plane of the port: structured tracing, crash forensics,
latency provenance and exposition — the port of
``traffic_classifier_sdn_tpu/obs`` without its device-runtime half.

- ``obs.trace``: the span tracer; completions land in per-stage
  ``stage_<name>_s`` histograms of ``utils.metrics`` and in the flight
  recorder.
- ``obs.flight_recorder``: a bounded ring of recent structured events,
  dumped as JSONL on an unhandled serve exception or SIGTERM.
- ``obs.latency``: record-level latency provenance (emit to render), the
  ``e2e_emit_to_render_s`` and ``wf_*`` histograms and the /healthz
  ``latency`` block.
- ``obs.exposition``: ``/metrics`` (Prometheus text), ``/healthz``,
  ``/events`` and ``/profile`` on a stdlib HTTP thread (CLI
  ``--obs-port``).

Not ported yet (ROADMAP Queue 1 item 6): the device-runtime telemetry
(the JAX ``obs/device.py``, here to come as ``torch.cuda`` memory stats),
its ``ProfilerCapture`` behind ``/profile`` (``torch.profiler``), and the
black-box perf ring (``obs/perf_recorder.py``).
"""

from .exposition import (
    ExpositionServer,
    HealthState,
    ProfilerBusy,
    prometheus_text,
)
from .flight_recorder import FlightRecorder, dump_metrics_snapshot
from .latency import LatencyProvenance
from .trace import Span, Tracer

__all__ = [
    "ExpositionServer",
    "FlightRecorder",
    "HealthState",
    "LatencyProvenance",
    "ProfilerBusy",
    "Span",
    "Tracer",
    "dump_metrics_snapshot",
    "prometheus_text",
]
