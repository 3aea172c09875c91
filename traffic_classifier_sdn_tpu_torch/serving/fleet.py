"""Fleet serving: take the serve horizontal — the port's copy of
``traffic_classifier_sdn_tpu/serving/fleet.py``.

A serve owns a PARTITION of the telemetry sources; a fleet is N such
processes sharing one model-checkpoint rotation directory
(``--drift-dir``). The sharing is what makes the fleet one system
instead of N serves:

- **Promotion propagation.** Every member runs the drift loop; one
  member's trip retrains and stages a candidate into the SHARED
  rotation (serving/retrain's seq-numbered members). Every other member
  runs with ``follow_rotation`` (CLI ``--drift-follow``): its
  controller scans the rotation each poll, adopts a newer member as its
  own candidate, and promotes it only through its OWN parity-gated
  probes against its OWN live labels — fleet-wide propagation that
  never bypasses the wrong-but-fresh gate, and never lets one member's
  bad fit install anywhere it cannot reproduce the live labels.
- **Blast radius.** Followers never discard a rejected adopted member
  (it is the peer's, possibly the peer's promoted model); they remember
  its seq and move on.

This module holds the process-independent pieces: the source
partitioner and the ``/healthz`` roster-of-rosters aggregator — one
scrape target that folds every member's health report (each already a
roster of its fan-in sources) into a fleet view.
``tools/torch_fleet_serve.py`` is the launcher that wires both to real
serve processes of the port's CLI.

Stdlib only (urllib + http.server), matching obs/exposition.py.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def partition_sources(n_sources: int, n_members: int) -> list[tuple[int, int]]:
    """Contiguous balanced ``(first_source, count)`` spans, one per
    member — member i serves sources [first, first+count). Remainder
    sources go to the earliest members, so no member ever carries more
    than one extra source."""
    if n_members <= 0:
        raise ValueError(f"n_members must be positive, got {n_members}")
    if n_sources < 0:
        raise ValueError(f"n_sources must be >= 0, got {n_sources}")
    base, extra = divmod(n_sources, n_members)
    out = []
    start = 0
    for i in range(n_members):
        count = base + (1 if i < extra else 0)
        out.append((start, count))
        start += count
    return out


def fetch_member_health(url: str, timeout: float = 2.0) -> dict:
    """One member's ``/healthz`` as a roster entry: ``reachable``,
    ``healthy``, HTTP ``status``, and the member's full ``report``.
    A 503 is REACHABLE-but-unhealthy and still carries the report (the
    exposition server answers 503 with the same JSON body); only a
    transport failure is unreachable. Never raises."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            status = resp.status
            body = resp.read()
    except urllib.error.HTTPError as e:
        status = e.code
        try:
            body = e.read()
        except Exception:  # noqa: BLE001 — a half-dead member must not kill the scrape
            body = b""
    except Exception as e:  # noqa: BLE001 — unreachable is a report, not a crash
        return {
            "url": url, "reachable": False, "healthy": False,
            "error": f"{type(e).__name__}: {e}",
        }
    try:
        report = json.loads(body.decode())
    except Exception as e:  # noqa: BLE001 — a torn payload is a report, not a crash
        return {
            "url": url, "reachable": True, "healthy": False,
            "status": status, "error": f"bad payload: {e}",
        }
    return {
        "url": url, "reachable": True,
        "healthy": bool(report.get("healthy", status == 200)),
        "status": status, "report": report,
    }


def aggregate(member_urls, timeout: float = 2.0,
              fetch=fetch_member_health) -> dict:
    """The roster-of-rosters: every member's health report folded into
    one fleet view. ``healthy`` is the conjunction over members (an
    unreachable member is unhealthy — a fleet with a silent member must
    probe-fail); ``sources`` concatenates each member's fan-in roster
    with a ``member`` index, so one scrape shows every source in the
    region; ``drift_states``/``promoted`` surface whether a promotion
    has propagated fleet-wide."""
    members = [fetch(u, timeout=timeout) for u in member_urls]
    sources = []
    drift_states = []
    swapped = []
    promotions_total = 0
    for i, m in enumerate(members):
        report = m.get("report") or {}
        for src in report.get("sources") or []:
            sources.append({**src, "member": i})
        drift = report.get("drift") or {}
        drift_states.append(drift.get("state"))
        swapped.append(bool(drift.get("swapped")))
        promotions_total += int(drift.get("promotions") or 0)
    return {
        "healthy": bool(members) and all(m["healthy"] for m in members),
        "fleet_size": len(members),
        "members_reachable": sum(
            1 for m in members if m["reachable"]
        ),
        "members_healthy": sum(1 for m in members if m["healthy"]),
        "members": members,
        "sources": sources,
        "drift_states": drift_states,
        "swapped": swapped,
        "promotions_total": promotions_total,
    }


class _AggregatorHandler(BaseHTTPRequestHandler):
    server_version = "tcsdn-fleet/1"

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        owner: FleetAggregator = self.server.owner  # type: ignore[attr-defined]
        if self.path.split("?", 1)[0] != "/healthz":
            body = b'{"error": "not found"}'
            self.send_response(404)
        else:
            healthy, report = owner.check()
            body = json.dumps(report, sort_keys=True).encode()
            self.send_response(200 if healthy else 503)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args) -> None:  # noqa: D102
        pass  # probes every few seconds must not spam stderr


class FleetAggregator:
    """The fleet's one scrape target: ``/healthz`` answering the
    roster-of-rosters (``aggregate``), 200 while every member is
    healthy, 503 otherwise. Members are polled ON DEMAND per request —
    no background thread, so the answer's freshness is the scrape's
    freshness and an idle aggregator costs nothing. ``port=0`` binds
    ephemeral (tests); ``self.port`` is the bound port after
    ``start()``. Loopback bind by default, same rationale as
    obs/exposition.ExpositionServer."""

    def __init__(self, member_urls, port: int = 0,
                 host: str = "127.0.0.1", timeout: float = 2.0,
                 fetch=fetch_member_health):
        self.member_urls = list(member_urls)
        self.host = host
        self.port = port
        self.timeout = float(timeout)
        self._fetch = fetch
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def check(self) -> tuple[bool, dict]:
        """(healthy, roster-of-rosters) — the /healthz payload; also
        the embedding API for callers that skip HTTP."""
        report = aggregate(
            self.member_urls, timeout=self.timeout, fetch=self._fetch
        )
        return report["healthy"], report

    def start(self) -> None:
        if self._server is not None:
            raise RuntimeError("fleet aggregator already started")
        server = ThreadingHTTPServer(
            (self.host, self.port), _AggregatorHandler
        )
        server.daemon_threads = True
        server.owner = self  # type: ignore[attr-defined]
        self._server = server
        self.port = server.server_address[1]
        self._thread = threading.Thread(
            target=server.serve_forever, name="tcsdn-fleet-aggregator",
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        server, self._server = self._server, None
        thread, self._thread = self._thread, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=5.0)

    def __enter__(self) -> FleetAggregator:
        self.start()
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
