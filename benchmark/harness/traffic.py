"""The benchmark's traffic generator: one general generator, driven by a
traffic file (``benchmark/traffic/<mix>.json``).

A deployment is ``switches`` switches of ``conversations_per_switch``
conversations each. Burst ``b`` is switch ``b % switches``'s flow-stats
reply for its poll round ``b // switches``: every conversation reports two
lines (forward and reverse) in the monitor protocol of the port's
``ingest/protocol.py``, with cumulative counters that rise in every poll.
The poll rounds are ``poll_seconds`` apart on the telemetry clock and all
switches of a round share its time stamp, as the replies of one poll of
Ryu's monitor do.

Each conversation has one traffic class for the whole run; the classes
come in exact shares (``share``), placed by the seed. A class's per-poll
forward packets are ``max(1, round(gamma(pkts_shape, pkts_scale)))``, its
bytes ``max(1, round(packets * bytes_per_pkt))``, and the reverse
direction carries ``rev_share`` of the packets at the same bytes per
packet: the arithmetic of the port's ``ingest/workload.synthetic_delta_pools``
and of the seeded training rows behind the stand-in checkpoints
(``chip_smoke.reference_csvs``). As ``ingest/workload.ClassWorkload`` does,
each poll samples every conversation's deltas from its class's pool
(``pool_rows`` rows drawn from the seed), vectorised. The same seed gives
the same bytes whatever the timing.

The generator keeps the last ``history`` rounds of every switch's counters,
which is what the plain reference reads after the window (it never reads
anything the port made), and copies of the rounds that a check asks for at
a given burst (``keep``: burst -> [(switch, round), ...], each copied from
the history when that burst is made)."""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np

from . import linegen

# counter columns of a conversation: forward packets, forward bytes,
# reverse packets, reverse bytes
FP, FB, RP, RB = range(4)


@dataclass(frozen=True)
class ClassShape:
    name: str
    share: float
    pkts_shape: float
    pkts_scale: float
    bytes_per_pkt: float
    rev_share: float


def class_shapes(spec: list) -> list[ClassShape]:
    return [ClassShape(**c) for c in spec]


def class_counts(shares, n: int) -> np.ndarray:
    """Exact per-class counts of ``n`` items under ``shares`` (largest
    remainder, ties to the lower class)."""
    shares = np.asarray(shares, np.float64)
    raw = shares / shares.sum() * n
    counts = np.floor(raw).astype(np.int64)
    rest = n - int(counts.sum())
    order = np.argsort(-(raw - counts), kind="stable")
    counts[order[:rest]] += 1
    return counts


def draw_deltas(rng: np.random.Generator, cls: np.ndarray,
                shapes: list[ClassShape]) -> np.ndarray:
    """(len(cls), 4) int64 per-poll counter deltas of conversations of
    classes ``cls``: every delta is at least 1."""
    shape = np.array([c.pkts_shape for c in shapes])[cls]
    scale = np.array([c.pkts_scale for c in shapes])[cls]
    bpp = np.array([c.bytes_per_pkt for c in shapes])[cls]
    rev = np.array([c.rev_share for c in shapes])[cls]
    fp = np.maximum(1.0, np.round(rng.gamma(shape, scale)))
    rp = np.maximum(1.0, np.round(fp * rev))
    out = np.empty((cls.shape[0], 4), np.int64)
    out[:, FP] = fp
    out[:, FB] = np.maximum(1.0, np.round(fp * bpp))
    out[:, RP] = rp
    out[:, RB] = np.maximum(1.0, np.round(rp * bpp))
    return out


def mac_strings(switch: int, n: int, side: int) -> np.ndarray:
    """(n, 17) uint8 MAC text of the hosts on ``side`` (0 or 1) of the
    switch's n conversations: ``02:ss:cc:cc:cc:0<side>``, locally
    administered and unique across switches and conversations."""
    c = np.arange(n, dtype=np.int64)
    octets = np.stack([np.full(n, 2), np.full(n, switch & 0xFF),
                       (c >> 16) & 0xFF, (c >> 8) & 0xFF, c & 0xFF,
                       np.full(n, side)], 1)
    hexd = np.frombuffer(b"0123456789abcdef", np.uint8)
    out = np.full((n, 17), ord(":"), np.uint8)
    for i in range(6):
        out[:, 3 * i] = hexd[octets[:, i] >> 4]
        out[:, 3 * i + 1] = hexd[octets[:, i] & 15]
    return out


def mac_text(switch: int, conv: int, side: int) -> str:
    """One MAC of ``mac_strings``."""
    octets = (2, switch & 0xFF, (conv >> 16) & 0xFF, (conv >> 8) & 0xFF,
              conv & 0xFF, side)
    return ":".join(f"{o:02x}" for o in octets)


def line_middles(switch: int, n: int) -> np.ndarray:
    """(2n, width) uint8: ``dp\\tin\\tsrc\\tdst\\tout\\t`` of the forward
    (even rows) and reverse (odd rows) line of each conversation."""
    a, b = mac_strings(switch, n, 0), mac_strings(switch, n, 1)
    dp = f"{switch + 1}\t".encode()
    tab = np.full((n, 1), 9, np.uint8)

    def rows(inp, src, dst, outp):
        pre = np.frombuffer(dp + inp + b"\t", np.uint8)[None].repeat(n, 0)
        post = np.frombuffer(b"\t" + outp + b"\t", np.uint8)[None].repeat(n, 0)
        return np.concatenate([pre, src, tab, dst, post], 1)

    fwd, rev = rows(b"1", a, b, b"2"), rows(b"2", b, a, b"1")
    out = np.empty((2 * n, fwd.shape[1]), np.uint8)
    out[0::2], out[1::2] = fwd, rev
    return out


class TrafficSpec:
    """A traffic file's parameters."""

    def __init__(self, d: dict):
        self.name = d["name"]
        self.loop = d["loop"]
        if self.loop not in ("closed", "open"):
            raise ValueError(f"traffic {self.name}: loop must be closed or open")
        self.switches = int(d["switches"])
        self.conversations = int(d["conversations_per_switch"])
        self.start_time = int(d["start_time"])
        self.poll_seconds = int(d["poll_seconds"])
        self.classes = class_shapes(d["classes"])
        self.rate = float(d["rate_bursts_per_s"]) if self.loop == "open" else None
        self.pool_rows = int(d.get("pool_rows", 4096))
        self.queue_depth = int(d.get("queue_depth", 4))
        self.render_samples = int(d.get("render_samples", 16))
        self.trace_bursts = int(d.get("trace_bursts", 2 * self.switches))
        self.trace_offset_bursts = int(d.get("trace_offset_bursts",
                                             4 * self.switches))
        if not 1 <= self.queue_depth <= self.switches:
            # the generator runs at most one round ahead of the serve, so
            # the history holds the rounds the reference reads
            raise ValueError("queue_depth must be 1 to the switch count")
        if 2 ** 31 <= self.start_time + 10 ** 6 * self.poll_seconds:
            raise ValueError("time stamps must stay in int32")

    @property
    def capacity(self) -> int:
        return self.switches * self.conversations

    def time_of(self, rnd: int) -> int:
        return self.start_time + rnd * self.poll_seconds


class Generator:
    """Bursts of one traffic mix from one seed, in order. ``burst(b)`` must
    be called with b = 0, 1, 2, ...; ``state(s, k)`` returns switch s's
    counters after round k while they are in the history."""

    HISTORY = 3

    def __init__(self, spec: TrafficSpec, seed: int, keep: dict | None = None):
        self.spec = spec
        S, N = spec.switches, spec.conversations
        counts = class_counts([c.share for c in spec.classes], N)
        base = np.repeat(np.arange(len(counts)), counts).astype(np.int64)
        self.cls = np.stack([
            np.random.default_rng([seed, 0, s]).permutation(base)
            for s in range(S)])
        self._rngs = [np.random.default_rng([seed, 1, s]) for s in range(S)]
        pool_rng = np.random.default_rng([seed, 6])
        self.pools = np.stack([
            draw_deltas(pool_rng, np.full(spec.pool_rows, c), spec.classes)
            for c in range(len(spec.classes))])  # (classes, pool_rows, 4)
        self._mids = [line_middles(s, N) for s in range(S)]
        self._scratch = np.zeros(max(m.size for m in self._mids)
                                 + 2 * N * (32 + 2 * linegen.NUMBER_BYTES),
                                 np.uint8)
        self._hist = np.zeros((S, self.HISTORY, N, 4), np.int64)
        self.rounds = np.zeros(S, np.int64)  # rounds produced per switch
        self.next_burst = 0
        self.kept: dict = {}  # (switch, round) -> counters, kept on request
        self._keep = dict(keep or {})
        self._lock = threading.Lock()

    # -- production ---------------------------------------------------------

    def burst(self, b: int) -> bytes:
        spec = self.spec
        if b != self.next_burst:
            raise ValueError(f"bursts come in order: expected {self.next_burst}, got {b}")
        s, k = b % spec.switches, b // spec.switches
        N = spec.conversations
        d = np.take(self.pools.reshape(-1, 4), self.cls[s] * spec.pool_rows
                    + self._rngs[s].integers(0, spec.pool_rows, N), axis=0)
        with self._lock:
            cum = d if k == 0 else self._hist[s, (k - 1) % self.HISTORY] + d
            self._hist[s, k % self.HISTORY] = cum
            self.rounds[s] = k + 1
            self.next_burst = b + 1
            for sw, rnd in self._keep.pop(b, ()):
                if rnd >= 0 and (sw, rnd) not in self.kept:
                    self.kept[(sw, rnd)] = self._history(sw, rnd).copy()
        head = f"data\t{spec.time_of(k)}\t".encode()
        return linegen.format_lines(head, self._mids[s], cum, self._scratch)

    # -- what the reference reads --------------------------------------------
    def state(self, switch: int, rnd: int) -> np.ndarray:
        """(N, 4) counters of ``switch`` after round ``rnd``."""
        with self._lock:
            if (switch, rnd) in self.kept:
                return self.kept[(switch, rnd)]
            return self._history(switch, rnd).copy()

    def _history(self, switch: int, rnd: int) -> np.ndarray:
        newest = int(self.rounds[switch]) - 1
        if rnd < 0 or not 0 <= newest - rnd < self.HISTORY:
            raise KeyError(f"round {rnd} of switch {switch} is not kept")
        return self._hist[switch, rnd % self.HISTORY]


def burst_switch_round(spec: TrafficSpec, b: int) -> tuple[int, int]:
    return b % spec.switches, b // spec.switches


def rounds_after(spec: TrafficSpec, last_burst: int) -> np.ndarray:
    """Rounds each switch has reported once bursts 0..last_burst are in."""
    s = np.arange(spec.switches)
    return np.where(s <= last_burst, (last_burst - s) // spec.switches + 1, 0)


class Feeder:
    """Makes bursts ahead of the serve on a thread of its own, at most
    ``queue_depth`` ahead, and hands them over in order. ``get()`` blocks
    until the next burst is ready and records how long it waited."""

    def __init__(self, gen: Generator, depth: int):
        self.gen = gen
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._depth = depth
        self._stop = False
        self._error: BaseException | None = None
        self.wait_s = 0.0  # time the serve waited on the generator
        self.make_s = 0.0  # time spent making bursts
        self.made = 0
        self._thread = threading.Thread(target=self._run, name="bench-traffic",
                                        daemon=True)

    def start(self) -> "Feeder":
        self._thread.start()
        return self

    def _run(self) -> None:
        try:
            # the serve's threads come first when cores are short
            os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 19)
        except (AttributeError, OSError):
            pass
        try:
            while True:
                with self._cv:
                    while len(self._q) >= self._depth and not self._stop:
                        self._cv.wait()
                    if self._stop:
                        return
                    b = self.gen.next_burst
                t0 = time.perf_counter()
                payload = self.gen.burst(b)
                dt = time.perf_counter() - t0
                with self._cv:
                    self.make_s += dt
                    self.made += 1
                    self._q.append((b, payload))
                    self._cv.notify_all()
        except BaseException as e:  # noqa: BLE001 - re-raised by get()
            with self._cv:
                self._error = e
                self._cv.notify_all()

    def get(self) -> tuple[int, bytes]:
        t0 = time.perf_counter()
        with self._cv:
            while not self._q and self._error is None:
                self._cv.wait()
            if self._error is not None:
                raise self._error
            item = self._q.popleft()
            self._cv.notify_all()
        self.wait_s += time.perf_counter() - t0
        return item

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=30)
        if self._thread.is_alive():
            raise RuntimeError("the traffic thread did not stop")
