"""Scrapeable serving telemetry: /metrics, /healthz, /events, /profile —
the port's copy of ``traffic_classifier_sdn_tpu/obs/exposition.py``.

A stdlib ``http.server`` thread:

- ``/metrics``: Prometheus text exposition format 0.0.4. Counters and
  gauges map directly; each ``utils.metrics.Histogram`` renders as a
  summary (window quantiles 0.5/0.9/0.99, lifetime ``_sum`` and
  ``_count``). Every family carries the ``tcsdn_`` prefix, so
  ``stage_predict_s`` scrapes as ``tcsdn_stage_predict_s``.
- ``/healthz``: JSON liveness — collector alive, last-tick age against the
  staleness bound, checkpoint freshness, and the ``degrade``,
  ``label_cache``, ``sources`` and ``latency`` blocks. 200 while healthy,
  503 once stale or dead.
- ``/events``: the flight-recorder tail as a JSON array (``?n=``).
- ``/profile?seconds=N``: on-demand ``torch.profiler`` trace capture into
  the obs dir (obs/device.ProfilerCapture), armed only when the CLI runs
  with ``--obs-dir``; 404 "profiler not armed" otherwise. Mutually
  exclusive (409 while one runs), a failed capture is a 500 — never a
  serve-loop crash.

Handlers read under the metrics/ring locks only long enough to snapshot;
``/metrics`` copies each family dict before iterating, so a scrape while
the device-stage worker writes a histogram never fails. ``stop()`` closes
the socket and joins the thread.
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .device import ProfilerBusy


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


_PREFIX = "tcsdn_"

# the bounded-window quantiles exposed per histogram (label, percentile)
_QUANTILES = (("0.5", 50.0), ("0.9", 90.0), ("0.99", 99.0))


def _metric_name(name: str) -> str:
    return _PREFIX + _NAME_RE.sub("_", name)


def _fmt(value: float) -> str:
    """Prometheus-friendly float rendering (repr keeps full precision;
    integers shed their trailing .0 for counter readability)."""
    f = float(value)
    return str(int(f)) if f.is_integer() else repr(f)


def prometheus_text(metrics, now: float | None = None) -> str:
    """Render a ``utils.metrics.Metrics`` registry in Prometheus text
    format. ``now`` injects the uptime clock so golden tests are exact;
    the serving path leaves it None (wall clock)."""
    if now is None:
        now = time.time()
    # shallow-copy each family dict before iterating: the serve loop
    # registers new metrics concurrently, and iterating a resizing dict
    # raises; a dict() copy is atomic under the GIL
    counters = dict(metrics.counters)
    gauges = dict(metrics.gauges)
    histograms = dict(metrics.histograms)
    lines: list[str] = []
    up = _metric_name("uptime_seconds")
    lines.append(f"# HELP {up} Seconds since the metrics registry reset.")
    lines.append(f"# TYPE {up} gauge")
    lines.append(f"{up} {_fmt(max(0.0, now - metrics.started_at))}")
    for name in sorted(counters):
        pname = _metric_name(name)
        lines.append(f"# TYPE {pname} counter")
        lines.append(f"{pname} {_fmt(counters[name])}")
    for name in sorted(gauges):
        pname = _metric_name(name)
        lines.append(f"# TYPE {pname} gauge")
        lines.append(f"{pname} {_fmt(gauges[name])}")
    for name in sorted(histograms):
        h = histograms[name]
        pname = _metric_name(name)
        lines.append(
            f"# HELP {pname} Window quantiles are exact nearest-rank "
            f"over the newest {h.window} samples; sum/count are "
            f"lifetime."
        )
        lines.append(f"# TYPE {pname} summary")
        values = h.quantiles([q for _, q in _QUANTILES])
        for (label, _), v in zip(_QUANTILES, values):
            lines.append(f'{pname}{{quantile="{label}"}} {_fmt(v)}')
        lines.append(f"{pname}_sum {_fmt(h.total)}")
        lines.append(f"{pname}_count {h.count}")
    return "\n".join(lines) + "\n"


class HealthState:
    """Liveness/staleness aggregate behind ``/healthz``.

    The serve loop beats ``tick()`` once per poll tick and
    ``checkpoint()`` after each committed snapshot; ``probe`` (when
    set) reports whether the telemetry collector is alive. ``check``
    folds the three into one verdict: healthy until the last tick (or
    the start, before any tick) is older than ``max_tick_age_s``, the
    collector probe says dead, or — when a checkpoint cadence is
    declared — the last checkpoint is older than
    ``max_checkpoint_age_s``. Clock-injected and lock-guarded: beats
    come from the serve loop, reads from the exposition thread.
    """

    def __init__(self, clock=time.monotonic, max_tick_age_s: float = 30.0,
                 max_checkpoint_age_s: float | None = None):
        self._clock = clock
        self.max_tick_age_s = max_tick_age_s
        self.max_checkpoint_age_s = max_checkpoint_age_s
        self._lock = threading.Lock()
        self._started_at = clock()
        self._last_tick_at: float | None = None
        self._last_checkpoint_at: float | None = None
        self._model_loaded_at: float | None = None
        self._model_promoted_at: float | None = None
        self._ticks = 0
        self._probe = None
        self._degrade = None
        self._drift = None
        self._openset = None
        self._label_cache = None
        self._sources = None
        self._latency = None
        self._device = None
        self._actuation = None
        self._obs_port: int | None = None

    def model_loaded(self) -> None:
        """The serve registered its boot model — the ``model_age_s``
        staleness anchor. A serve that never promotes reports its age
        from here, so 'healthy but ancient' is visible without the
        drift loop being on at all."""
        with self._lock:
            self._model_loaded_at = self._clock()

    def model_promoted(self) -> None:
        """A fresh checkpoint was hot-promoted (serving/drift.py):
        ``model_age_s`` re-anchors here and
        ``model_promoted_age_s`` starts reporting."""
        with self._lock:
            self._model_promoted_at = self._clock()

    def set_drift(self, status_fn) -> None:
        """``status_fn() -> dict`` (serving/drift.DriftController
        .status): the drift loop's self-report, folded into /healthz as
        a ``drift`` object — state machine position, score, and the
        retrain/promotion/rollback counters."""
        with self._lock:
            self._drift = status_fn

    def set_degrade(self, status_fn) -> None:
        """``status_fn() -> dict`` (serving/degrade.DegradeLadder.status):
        the degradation ladder's self-report. Folded into /healthz as
        200-but-degraded — a degraded serve still produces every tick,
        so it must NOT probe-fail and get restarted into the same sick
        device; the ``degraded`` flag plus the ladder rung tell the
        operator (and the alerting rule) what actually needs attention."""
        with self._lock:
            self._degrade = status_fn

    def set_openset(self, status_fn) -> None:
        """``status_fn() -> dict`` (serving/openset.OpenSetGate
        .status): the open-set rejection tier's self-report — state
        (CALIBRATING/ARMED), the calibrated threshold and margin, and
        the rejection counters — folded into /healthz as an
        ``openset`` object."""
        with self._lock:
            self._openset = status_fn

    def set_label_cache(self, status_fn) -> None:
        """``status_fn() -> dict`` (serving/incremental.IncrementalLabels
        .status): the incremental label cache's self-report — mode,
        cache coverage (fraction of the table served from cache at the
        last render), rows re-predicted, and invalidation count —
        folded into /healthz as a ``label_cache`` object."""
        with self._lock:
            self._label_cache = status_fn

    def set_latency(self, status_fn) -> None:
        """``status_fn() -> dict`` (obs/latency.LatencyProvenance
        .status): the live end-to-end latency budget, folded into
        /healthz as a ``latency`` object — e2e p50/p99 since emit, the
        dominant stage of the waterfall, and the SLO-breach flag when
        ``--latency-slo`` is armed."""
        with self._lock:
            self._latency = status_fn

    def set_device(self, status_fn) -> None:
        """``status_fn() -> dict`` (obs/device.DeviceTelemetry.status): the
        device-runtime plane's self-report — backend/platform, device
        memory and its watermark, last-dispatch age,
        donation effectiveness — folded into /healthz as a ``device``
        object. Informational, never a health verdict: a retrace or a
        high watermark is an alerting signal, not a restart reason."""
        with self._lock:
            self._device = status_fn

    def set_actuation(self, status_fn) -> None:
        """``status_fn() -> dict`` (serving/actuation.ActuationPlane
        .status): the actuation tier's self-report — mode, live state
        (push/dry-run/degraded/demoted), the rule FSM census, the exact
        intended == installed + refused + retracted ledger, and the
        flap counters — folded into /healthz as an ``actuation``
        object. Informational like ``device``: a degraded plane keeps
        serving classifications, so it never flips the verdict."""
        with self._lock:
            self._actuation = status_fn

    def set_obs_port(self, port: int) -> None:
        """The exposition server's ACTUAL bound port — the /healthz
        self-reference. With ``--obs-port 0`` (ephemeral bind) this is
        how a supervisor that parsed nothing from stderr still learns
        where the plane landed."""
        with self._lock:
            self._obs_port = int(port)

    def set_collector_probe(self, probe) -> None:
        """``probe() -> bool | None`` (None = no collector, e.g. replay
        sources — reported but never unhealthy)."""
        with self._lock:
            self._probe = probe

    def set_source_roster(self, roster_fn) -> None:
        """``roster_fn() -> list[dict]`` (ingest/fanin.FanInIngest
        .roster): the fan-in tier's per-source status — id, state
        (HEALTHY/RESTARTING/DEAD), lag since last delivery, drop and
        record counters, pending quarantine — folded into /healthz as a
        ``sources`` array. The single-boolean ``collector_alive`` keeps
        reporting alongside it (the fan-in tier feeds it via the
        collector probe), so pre-fan-in alerting rules survive the
        multi-source upgrade unchanged."""
        with self._lock:
            self._sources = roster_fn

    def tick(self) -> None:
        with self._lock:
            self._last_tick_at = self._clock()
            self._ticks += 1

    def checkpoint(self) -> None:
        with self._lock:
            self._last_checkpoint_at = self._clock()

    def check(self) -> tuple[bool, dict]:
        """(healthy, report) — the /healthz payload."""
        with self._lock:
            now = self._clock()
            last_tick = self._last_tick_at
            last_ckpt = self._last_checkpoint_at
            ticks = self._ticks
            probe = self._probe
            degrade = self._degrade
            drift = self._drift
            openset = self._openset
            label_cache = self._label_cache
            sources = self._sources
            latency = self._latency
            device = self._device
            actuation = self._actuation
            obs_port = self._obs_port
            model_loaded = self._model_loaded_at
            model_promoted = self._model_promoted_at
            started = self._started_at
        tick_age = now - (last_tick if last_tick is not None else started)
        stale = tick_age > self.max_tick_age_s
        collector_alive = None
        if probe is not None:
            try:
                collector_alive = probe()
            except Exception as e:  # noqa: BLE001 — health must not crash
                collector_alive = False
                probe_error = str(e)
            else:
                probe_error = None
        else:
            probe_error = None
        ckpt_age = None if last_ckpt is None else now - last_ckpt
        ckpt_stale = False
        if self.max_checkpoint_age_s is not None:
            # before the first checkpoint, freshness is measured from
            # start — a serve that never checkpoints must go unhealthy,
            # not report "no checkpoint yet" forever
            ckpt_stale = (
                (ckpt_age if ckpt_age is not None else now - started)
                > self.max_checkpoint_age_s
            )
        healthy = (
            not stale and collector_alive is not False and not ckpt_stale
        )
        report = {
            "healthy": healthy,
            "ticks": ticks,
            "last_tick_age_s": round(tick_age, 6),
            "max_tick_age_s": self.max_tick_age_s,
            "tick_stale": stale,
            "collector_alive": collector_alive,
            "checkpoint_age_s": (
                None if ckpt_age is None else round(ckpt_age, 6)
            ),
            "max_checkpoint_age_s": self.max_checkpoint_age_s,
            "checkpoint_stale": ckpt_stale,
            # model staleness relative to the live stream: age since
            # the last promotion (or boot load, before any) — an
            # operator distinguishes "healthy but ancient" from
            # "freshly promoted" without correlating logs
            "model_age_s": (
                None if model_loaded is None else round(
                    now - (
                        model_promoted if model_promoted is not None
                        else model_loaded
                    ), 6,
                )
            ),
            "model_promoted_age_s": (
                None if model_promoted is None
                else round(now - model_promoted, 6)
            ),
        }
        if probe_error is not None:
            report["collector_probe_error"] = probe_error
        if degrade is not None:
            try:
                dstatus = degrade()
            except Exception as e:  # noqa: BLE001 — health must not crash
                dstatus = {"state": "unknown", "error": str(e)}
            report["degrade"] = dstatus
            # 200-but-degraded: the serve still answers every tick, so
            # it stays "healthy" for the restart-probe — the rung is
            # the alerting signal, not a reason to kill the process
            report["degraded"] = dstatus.get("state") != "HEALTHY"
        if drift is not None:
            try:
                report["drift"] = drift()
            except Exception as e:  # noqa: BLE001 — health must not crash
                report["drift"] = {"state": "unknown", "error": str(e)}
        if openset is not None:
            try:
                report["openset"] = openset()
            except Exception as e:  # noqa: BLE001 — health must not crash
                report["openset"] = {"state": "unknown", "error": str(e)}
        if label_cache is not None:
            try:
                report["label_cache"] = label_cache()
            except Exception as e:  # noqa: BLE001 — health must not crash
                report["label_cache"] = {
                    "mode": "unknown", "error": str(e),
                }
        if sources is not None:
            try:
                report["sources"] = sources()
            except Exception as e:  # noqa: BLE001 — health must not crash
                report["sources"] = [{"state": "unknown",
                                      "error": str(e)}]
        if latency is not None:
            try:
                report["latency"] = latency()
            except Exception as e:  # noqa: BLE001 — health must not crash
                report["latency"] = {"observed": False, "error": str(e)}
        if device is not None:
            try:
                report["device"] = device()
            except Exception as e:  # noqa: BLE001 — health must not crash
                report["device"] = {"armed": False, "error": str(e)}
        if actuation is not None:
            try:
                report["actuation"] = actuation()
            except Exception as e:  # noqa: BLE001 — health must not crash
                report["actuation"] = {"state": "unknown", "error": str(e)}
        if obs_port is not None:
            report["obs_port"] = obs_port
        return healthy, report


class _Handler(BaseHTTPRequestHandler):
    # the server instance injects these via the class-factory below
    server_version = "tcsdn-obs/1"

    def _send(self, status: int, content_type: str, body: bytes) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        owner: ExpositionServer = self.server.owner  # type: ignore[attr-defined]
        url = urlparse(self.path)
        if url.path == "/metrics":
            body = prometheus_text(owner.metrics).encode()
            self._send(
                200, "text/plain; version=0.0.4; charset=utf-8", body
            )
        elif url.path == "/healthz":
            if owner.health is None:
                payload: dict = {"healthy": True, "detail": "no health state"}
                healthy = True
            else:
                healthy, payload = owner.health.check()
            body = json.dumps(payload, sort_keys=True).encode()
            self._send(
                200 if healthy else 503, "application/json", body
            )
        elif url.path == "/events":
            if owner.recorder is None:
                events: list = []
            else:
                n = None
                raw = parse_qs(url.query).get("n")
                if raw:
                    try:
                        n = max(0, int(raw[0]))
                    except ValueError:
                        self._send(400, "application/json",
                                   b'{"error": "n must be an integer"}')
                        return
                events = owner.recorder.tail(n)
            body = json.dumps(events).encode()
            self._send(200, "application/json", body)
        elif url.path == "/profile":
            # on-demand device profiler capture — blocks THIS handler
            # thread for the capture window
            # (ThreadingHTTPServer: /metrics scrapes keep answering);
            # the busy guard makes concurrent requests a 409, so the
            # capture itself is never concurrent with another
            if owner.profiler is None:
                self._send(
                    404, "application/json",
                    b'{"error": "profiler not armed (serve with '
                    b'--obs-dir)"}',
                )
                return
            raw = parse_qs(url.query).get("seconds")
            try:
                seconds = float(raw[0]) if raw else 2.0
            except ValueError:
                self._send(400, "application/json",
                           b'{"error": "seconds must be a number"}')
                return
            try:
                result = owner.profiler.capture(seconds)
            except ProfilerBusy as e:
                self._send(409, "application/json",
                           json.dumps({"error": str(e)}).encode())
            except ValueError as e:
                self._send(400, "application/json",
                           json.dumps({"error": str(e)}).encode())
            except Exception as e:  # noqa: BLE001 — absorbed: 500, not a crash
                self._send(500, "application/json",
                           json.dumps({"error": str(e)}).encode())
            else:
                self._send(200, "application/json",
                           json.dumps(result, sort_keys=True).encode())
        else:
            self._send(404, "application/json", b'{"error": "not found"}')

    def log_message(self, fmt, *args) -> None:  # noqa: D102
        pass  # scrapes every few seconds must not spam stderr


class ExpositionServer:
    """Owns the HTTP listener thread. ``port=0`` binds an ephemeral
    port (tests); ``self.port`` is the actual bound port after
    ``start()``. The default bind is loopback — /events carries
    filesystem paths and failure detail, so reaching beyond the host
    (``host="0.0.0.0"`` for a real scrape target) is the caller's
    explicit choice (CLI: ``--obs-host``)."""

    def __init__(self, metrics, recorder=None, health=None,
                 port: int = 0, host: str = "127.0.0.1", profiler=None):
        self.metrics = metrics
        self.recorder = recorder
        self.health = health
        self.profiler = profiler
        self.host = host
        self.port = port
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._server is not None:
            raise RuntimeError("exposition server already started")
        server = ThreadingHTTPServer((self.host, self.port), _Handler)
        server.daemon_threads = True
        server.owner = self  # type: ignore[attr-defined]
        self._server = server
        self.port = server.server_address[1]
        self._thread = threading.Thread(
            target=server.serve_forever, name="tcsdn-obs-exposition",
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        """Clean shutdown: stop accepting, close the socket, join the
        thread. Idempotent (the CLI's ``finally`` may race a crash)."""
        server, self._server = self._server, None
        thread, self._thread = self._thread, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=5.0)
