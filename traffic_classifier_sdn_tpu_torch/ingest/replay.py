"""Replay and synthetic telemetry sources — the first-class test seam the
reference lacks (SURVEY.md §4b: the line protocol at simple_monitor_13.py:66
is trivially fakeable; here it is an explicit interface).

Sources yield ``TelemetryRecord`` batches grouped by poll tick, so the whole
ingest→classify path runs without Mininet/OVS/Ryu: from a recorded monitor
capture, or from a synthetic flow population (used by benchmarks to generate
millions of concurrent flows). A copy of
``traffic_classifier_sdn_tpu/ingest/replay.py``: for the same seed the
records and bytes are identical.
"""

from __future__ import annotations

from dataclasses import dataclass
from collections.abc import Iterator

import numpy as np

from .protocol import TelemetryRecord, parse_line


def iter_capture(path: str) -> Iterator[list[TelemetryRecord]]:
    """Replay a recorded monitor stdout capture, yielding one list of
    records per poll timestamp (lines with equal time field)."""
    tick: list[TelemetryRecord] = []
    current_t = None
    with open(path, "rb") as f:
        for line in f:
            r = parse_line(line)
            if r is None:
                continue
            if current_t is not None and r.time != current_t and tick:
                yield tick
                tick = []
            current_t = r.time
            tick.append(r)
    if tick:
        yield tick


def iter_capture_bytes(path: str) -> Iterator[tuple[bytes, int]]:
    """Raw-wire replay for the native ingest path: yields ``(payload,
    n_records)`` per poll tick — the SAME tick boundaries as
    ``iter_capture`` (the time field of valid telemetry lines), but the
    payload is the capture's original line bytes, so the C++ parser sees
    exactly what was recorded and the record streams of the two
    iterators are identical (the byte-identity anchor for native-ingest
    fan-in). Invalid lines are dropped here like ``iter_capture`` drops
    them — the validation already ran to find the tick boundary."""
    tick: list[bytes] = []
    current_t = None
    with open(path, "rb") as f:
        for line in f:
            r = parse_line(line)
            if r is None:
                continue
            if current_t is not None and r.time != current_t and tick:
                yield b"".join(tick), len(tick)
                tick = []
            current_t = r.time
            if not line.endswith(b"\n"):
                line += b"\n"  # final capture line may lack the newline
            tick.append(line)
    if tick:
        yield b"".join(tick), len(tick)


@dataclass
class SyntheticFlows:
    """A population of bidirectional flows with per-class-like rate
    characteristics, emitted in the monitor's line protocol semantics
    (cumulative counters, 1 Hz polls).

    Each conversation produces two records per tick (one per direction),
    mimicking what the monitor logs for the two learned-switch flow entries
    of a host pair (simple_monitor_13.py:49-66).

    ``churn`` controls the per-tick updated-flow fraction: each tick a
    seeded random subset of ``round(churn * n_flows)`` conversations
    emits telemetry (counters advance), the rest stay silent — the knob
    behind the incremental-serving dirty sweep
    (tools/bench_serve.py --churn-fraction). At the default 1.0 the
    emission order and RNG consumption are unchanged from the
    historical all-flows-every-tick behavior.

    ``mac_base`` offsets the conversation index inside the 48-bit MAC
    space: N fan-in sources with disjoint bases emit disjoint host
    populations (ingest/fanin.py's multi-source load generator), so the
    aggregate looks like N real switches, not N copies of one. The
    default 0 reproduces the historical addresses exactly.
    """

    n_flows: int
    seed: int = 0
    start_time: int = 1
    churn: float = 1.0
    mac_base: int = 0

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        self.pps_fwd = rng.gamma(2.0, 50.0, self.n_flows)
        self.pps_rev = rng.gamma(2.0, 40.0, self.n_flows)
        self.bpp_fwd = rng.uniform(60, 1400, self.n_flows)
        self.bpp_rev = rng.uniform(60, 1400, self.n_flows)
        self.cum_pkts_fwd = np.zeros(self.n_flows, np.int64)
        self.cum_bytes_fwd = np.zeros(self.n_flows, np.int64)
        self.cum_pkts_rev = np.zeros(self.n_flows, np.int64)
        self.cum_bytes_rev = np.zeros(self.n_flows, np.int64)
        self.t = self.start_time
        self._rng = rng

    def _mac(self, i: int, side: int) -> str:
        b = ((self.mac_base + i) * 2 + side).to_bytes(6, "big")
        return ":".join(f"{x:02x}" for x in b)

    def _active(self) -> np.ndarray:
        """This tick's emitting conversations (sorted, seeded)."""
        if self.churn >= 1.0:
            return np.arange(self.n_flows)
        k = int(round(self.churn * self.n_flows))
        if k <= 0:
            return np.empty(0, np.int64)
        return np.sort(self._rng.choice(self.n_flows, k, replace=False))

    def step_counters(self) -> np.ndarray:
        """Advance the cumulative counters of this tick's emitting
        conversations and return them (sorted). The caller renders the
        tick at time ``self.t`` and then increments ``self.t``; ``tick``
        and ``tick_bytes`` are the two renderings."""
        act = self._active()
        dp = np.int64(self.pps_fwd[act] * self._rng.poisson(1.0, act.size))
        self.cum_pkts_fwd[act] += dp
        self.cum_bytes_fwd[act] += np.int64(dp * self.bpp_fwd[act])
        dr = np.int64(self.pps_rev[act] * self._rng.poisson(1.0, act.size))
        self.cum_pkts_rev[act] += dr
        self.cum_bytes_rev[act] += np.int64(dr * self.bpp_rev[act])
        return act

    def tick(self) -> list[TelemetryRecord]:
        act = self.step_counters()
        out = []
        for i in (int(j) for j in act):
            src, dst = self._mac(i, 0), self._mac(i, 1)
            out.append(TelemetryRecord(
                time=self.t, datapath="1", in_port="1", eth_src=src,
                eth_dst=dst, out_port="2",
                packets=int(self.cum_pkts_fwd[i]),
                bytes=int(self.cum_bytes_fwd[i]),
            ))
            out.append(TelemetryRecord(
                time=self.t, datapath="1", in_port="2", eth_src=dst,
                eth_dst=src, out_port="1",
                packets=int(self.cum_pkts_rev[i]),
                bytes=int(self.cum_bytes_rev[i]),
            ))
        self.t += 1
        return out

    def tick_bytes(self) -> bytes:
        """One tick rendered straight to the monitor wire format — the
        bulk path for scale tests (2²⁰ flows): building TelemetryRecord
        objects per flow would dominate; this emits one bytes blob for
        the monitor pipe."""
        act = self.step_counters()
        if not hasattr(self, "_mac_cache"):
            self._mac_cache = [
                (self._mac(i, 0), self._mac(i, 1))
                for i in range(self.n_flows)
            ]
        t = self.t
        parts = []
        pf, bf = self.cum_pkts_fwd, self.cum_bytes_fwd
        pr, br = self.cum_pkts_rev, self.cum_bytes_rev
        for i in act:
            src, dst = self._mac_cache[i]
            parts.append(
                f"data\t{t}\t1\t1\t{src}\t{dst}\t2\t{pf[i]}\t{bf[i]}\n"
                f"data\t{t}\t1\t2\t{dst}\t{src}\t1\t{pr[i]}\t{br[i]}\n"
            )
        self.t += 1
        return "".join(parts).encode()
