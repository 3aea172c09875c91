"""Observability plane of the port: structured tracing, crash forensics,
latency provenance, exposition and the device-runtime plane — the port
of ``traffic_classifier_sdn_tpu/obs``.

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
- ``obs.device``: the device-runtime half — ``DeviceTelemetry`` (device
  memory from ``torch.cuda.memory_stats``, the last-dispatch age, the
  /healthz ``device`` block; XLA's compile counters have no torch
  counterpart and stay at 0) and ``ProfilerCapture`` (``torch.profiler``
  behind ``/profile``).
- ``obs.perf_recorder``: the black-box perf ring, per-tick samples
  committed to disk as atomic segments in the JAX package's format.
"""

from .device import DeviceTelemetry, ProfilerBusy, ProfilerCapture
from .exposition import ExpositionServer, HealthState, prometheus_text
from .flight_recorder import FlightRecorder, dump_metrics_snapshot
from .latency import LatencyProvenance
from .perf_recorder import PerfRecorder
from .trace import Span, Tracer

__all__ = [
    "DeviceTelemetry",
    "ExpositionServer",
    "FlightRecorder",
    "HealthState",
    "LatencyProvenance",
    "PerfRecorder",
    "ProfilerBusy",
    "ProfilerCapture",
    "Span",
    "Tracer",
    "dump_metrics_snapshot",
    "prometheus_text",
]
