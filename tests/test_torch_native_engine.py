"""Parity of the port's native ingest engine (``traffic_classifier_sdn_tpu_torch
/native``): the same telemetry bytes go through the port's ``NativeBatcher``
spine, the port's Python ``FlowIndex`` + ``Batcher`` spine and the JAX
package's ``NativeBatcher`` spine, and the cases follow the JAX package's
tests/test_native_engine.py (junk lines, partial chunks, CR framing,
counter resets, non-UTF-8 fields, per-source tails, capacity drops,
namespaces, faults at the parse seam).

Held bitwise: the packed wire matrices of the two native spines (the same
C++ source), the wire rows of the Python spine (as a multiset: the Python
batcher orders a tick's rows by flow, the engine by arrival), the device
table state of all three, slot metadata (as the native engines read it
back), ``slots_for_source``, records parsed, drops and parse-error counts.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from traffic_classifier_sdn_tpu.core import flow_table as jft
from traffic_classifier_sdn_tpu.ingest.batcher import (
    FlowStateEngine as JaxEngine,
)
from traffic_classifier_sdn_tpu.utils import faults as jfaults
from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
from traffic_classifier_sdn_tpu_torch.ingest.batcher import FlowStateEngine
from traffic_classifier_sdn_tpu_torch.ingest.protocol import (
    TelemetryRecord,
    format_line,
    parse_line,
)
from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows
from traffic_classifier_sdn_tpu_torch.native import engine as native_engine
from traffic_classifier_sdn_tpu_torch.native.engine import NativeBatcher
from traffic_classifier_sdn_tpu_torch.utils import faults

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIELDS = ("pkts_lo", "pkts_f", "bytes_lo", "bytes_f", "delta_pkts",
          "delta_bytes", "inst_pps", "avg_pps", "inst_bps", "avg_bps",
          "last_time", "active")


def _bits(a: np.ndarray) -> np.ndarray:
    """The raw bits of a numeric array (bools as they are)."""
    return a if a.dtype == bool else a.view(f"u{a.itemsize}")


def _table_bits(table) -> dict:
    """Every column of a flow table (JAX or port) as raw bits."""
    def arr(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    out = {"time_start": arr(table.time_start), "in_use": arr(table.in_use)}
    for d in ("fwd", "rev"):
        for f in FIELDS:
            out[f"{d}.{f}"] = arr(getattr(getattr(table, d), f))
    return {k: _bits(v) for k, v in out.items()}


def _as_read(field: str) -> str:
    """A string field as both native engines read it back for the UI: at
    most 63 bytes (``NativeBatcher.slot_meta``'s 64-byte buffers), up to
    the first NUL. Routing uses the whole field on every spine."""
    return field.encode()[:63].split(b"\0")[0].decode(errors="replace")


def _capture_wires(engine) -> list:
    """Record a copy of every wire ``engine`` applies."""
    wires = []
    apply = engine._apply_wire

    def recording(w):
        wires.append(np.array(w, copy=True))
        return apply(w)

    engine._apply_wire = recording
    return wires


class Spines:
    """The port's Python and native spines and the JAX native spine, fed
    the same telemetry."""

    def __init__(self, capacity: int = 16):
        self.py = FlowStateEngine(capacity, device="cpu")
        self.nat = FlowStateEngine(capacity, device="cpu", native=True)
        self.jax = JaxEngine(capacity, native=True)
        self.wires = {name: _capture_wires(e) for name, e in self.all()}
        self.sources = {0}

    def all(self):
        return (("py", self.py), ("nat", self.nat), ("jax", self.jax))

    def ingest_bytes(self, data: bytes, source: int = 0) -> int:
        self.sources.add(source)
        counts = {name: e.ingest_bytes(data, source) for name, e in self.all()}
        assert len(set(counts.values())) == 1, counts
        return counts["py"]

    def ingest(self, records) -> None:
        for _, e in self.all():
            e.ingest(records)

    def step(self) -> None:
        for _, e in self.all():
            e.step()

    def check(self) -> None:
        """Flush all three, then hold them to each other."""
        self.step()
        w_nat, w_jax = self.wires["nat"], self.wires["jax"]
        assert len(w_nat) == len(w_jax)
        for a, b in zip(w_nat, w_jax):
            assert a.dtype == b.dtype == np.uint32 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        cap = self.py.table.capacity
        rows = [  # the non-padding rows, widened to one width
            sorted(tuple(r) for w in ws for r in ft.widen_wire(w)
                   if (r[0] & 0x3FFFFFFF) != cap)
            for ws in (self.wires["py"], w_nat)
        ]
        assert rows[0] == rows[1]
        t_py = _table_bits(self.py.table)
        for name in ("nat", "jax"):
            t = _table_bits(getattr(self, name).table)
            for k, v in t_py.items():
                np.testing.assert_array_equal(v, t[k], err_msg=f"{name} {k}")
        meta = {slot: tuple(map(_as_read, m))
                for slot, m in self.py.slot_metadata().items()}
        assert self.nat.slot_metadata() == meta == self.jax.slot_metadata()
        for attr in ("dropped", "last_time"):
            assert (getattr(self.py, attr) == getattr(self.nat, attr)
                    == getattr(self.jax, attr)), attr
        assert self.py.num_flows() == self.nat.num_flows() == self.jax.num_flows()
        for source in (None, *self.sources):
            assert (self.py.parse_errors(source) == self.nat.parse_errors(source)
                    == self.jax.parse_errors(source)), source
        for source in self.sources:
            slots = self.py.slots_for_source(source)
            np.testing.assert_array_equal(slots, self.nat.slots_for_source(source))
            np.testing.assert_array_equal(slots, self.jax.slots_for_source(source))


def _random_stream(seed, n_ticks=12, n_hosts=6, lines_per_tick=12):
    """Telemetry with direction collisions, repeated flows and monotone
    counters (the JAX test's generator)."""
    rng = np.random.RandomState(seed)
    macs = [f"00:00:00:00:00:{i:02x}" for i in range(1, n_hosts + 1)]
    counters = {}
    ticks = []
    for t in range(1, n_ticks + 1):
        recs = []
        for _ in range(lines_per_tick):
            a, b = rng.choice(len(macs), 2, replace=False)
            key = (macs[a], macs[b])
            pk, by = counters.get(key, (0, 0))
            pk += int(rng.randint(1, 50))
            by += int(rng.randint(40, 5000))
            counters[key] = (pk, by)
            recs.append(TelemetryRecord(
                time=t, datapath="1", in_port=str(a + 1), eth_src=macs[a],
                eth_dst=macs[b], out_port=str(b + 1), packets=pk, bytes=by,
            ))
        ticks.append(recs)
    return ticks


def test_library_is_built_from_the_port_source():
    """The engine loads the library built from the port's own copy of the
    source, into the port's build directory, named by the source's hash."""
    assert native_engine.available()
    path = native_engine.build()
    port = ROOT / "traffic_classifier_sdn_tpu_torch"
    assert path.parent == port / "csrc" / "build" and path.exists()
    assert path.name.startswith("flow_engine-") and path.suffix == ".so"
    assert native_engine.SOURCE == port / "native" / "flow_engine.cpp"
    jax_src = ROOT / "traffic_classifier_sdn_tpu" / "native" / "flow_engine.cpp"
    mine = native_engine.SOURCE.read_text().splitlines()
    theirs = jax_src.read_text().splitlines()
    # the same C++ but for one comment that names the other framework
    assert len(mine) == len(theirs)
    assert [(a, b) for a, b in zip(mine, theirs) if a != b] == [(
        "// PyTorch layer scatters into the device-resident flow table",
        "// JAX layer scatters into the device-resident flow table",
    )]


@pytest.mark.parametrize("seed", [0, 7])
def test_random_stream_all_spines_agree(seed):
    s = Spines(capacity=64)
    for recs in _random_stream(seed):
        s.ingest_bytes(b"".join(format_line(r) for r in recs))
        s.check()


@pytest.mark.parametrize("seed", [1, 5])
def test_record_path_all_spines_agree(seed):
    """The record-object path (replay and synthetic sources): the native
    spines feed one formatted line per record."""
    s = Spines(capacity=64)
    for recs in _random_stream(seed):
        s.ingest(recs)
        s.check()


def test_junk_and_partial_chunks():
    s = Spines(capacity=8)
    line = format_line(TelemetryRecord(3, "1", "1", "aa", "bb", "2", 10, 400))
    noise = b"loading app simple_monitor_13.py\ndatapath         in-port\n"
    assert s.ingest_bytes(noise) == 0
    n = s.ingest_bytes(noise[:10])
    n += s.ingest_bytes(noise[10:] + line[:7])
    n += s.ingest_bytes(line[7:])
    assert n == 1
    s.check()
    assert s.nat.num_flows() == 1


def test_fuzz_mutated_lines_all_spines_agree():
    """Valid lines with random byte corruptions, fed in random chunks:
    accepted or rejected alike by the three spines, chunk by chunk."""
    rng = np.random.RandomState(5)
    base = [
        format_line(TelemetryRecord(
            time=int(rng.randint(1, 9)), datapath="1",
            in_port=str(rng.randint(1, 5)),
            eth_src=f"00:00:00:00:00:{a:02x}",
            eth_dst=f"00:00:00:00:00:{b:02x}",
            out_port=str(rng.randint(1, 5)),
            packets=int(rng.randint(1, 10**9)),
            bytes=int(rng.randint(1, 10**12)),
        ))
        for a, b in rng.randint(1, 30, (40, 2))
        if a != b
    ]

    def mutate(line: bytes) -> bytes:
        body = bytearray(line.rstrip(b"\n"))
        for _ in range(rng.randint(1, 4)):
            op = rng.randint(5)
            if not body:
                break
            i = rng.randint(len(body))
            if op == 0:
                body[i] ^= 1 << rng.randint(8)
            elif op == 1:
                body = body[:i]
            elif op == 2:
                body[i:i] = bytes([rng.choice([9, 0, 0xC3, 0xFF, 45])])
            elif op == 3:
                j = rng.randint(i, len(body) + 1)
                body[i:i] = body[i:j]
            else:
                j = rng.randint(i, len(body) + 1)
                del body[i:j]
        return bytes(body) + b"\n"

    stream = b"".join(
        mutate(base[rng.randint(len(base))]) if rng.rand() < 0.7
        else base[rng.randint(len(base))]
        for _ in range(400)
    )
    s = Spines(capacity=256)
    off = 0
    while off < len(stream):
        step = int(rng.randint(1, 997))
        s.ingest_bytes(stream[off: off + step])
        off += step
    s.check()
    assert s.py.parse_errors() > 0


def test_direction_folding_and_meta():
    s = Spines(capacity=8)
    fwd = TelemetryRecord(1, "1", "1", "aa", "bb", "2", 5, 100)
    rev = TelemetryRecord(1, "1", "2", "bb", "aa", "1", 3, 60)
    s.ingest_bytes(format_line(fwd) + format_line(rev))
    s.check()
    assert list(s.nat.slot_metadata().values()) == [("aa", "bb")]
    f12 = ft.features12(s.nat.table).numpy()
    assert f12[0, 0] == 0 and f12[0, 6] == 3


def test_capacity_drop_and_release():
    s = Spines(capacity=2)
    recs = [TelemetryRecord(1, "1", "1", f"h{i}", f"g{i}", "2", 1, 10)
            for i in range(4)]
    s.ingest_bytes(b"".join(format_line(r) for r in recs))
    s.check()
    assert s.nat.num_flows() == 2 and s.nat.dropped == 2
    for _, e in s.all():
        assert e.evict_idle(now=100, idle_seconds=1) == 2
    s.check()
    s.ingest_bytes(format_line(recs[3]))
    s.check()
    assert s.nat.num_flows() == 1 and s.nat.dropped == 2


def test_same_tick_create_then_updates():
    """Three same-direction reports in one tick: the engine starts a new
    generation at the third, the Python batcher flushes before it."""
    s = Spines(capacity=4)
    s.ingest([
        TelemetryRecord(1, "1", "1", "aa", "bb", "2", 5, 100),
        TelemetryRecord(2, "1", "1", "aa", "bb", "2", 9, 180),
        TelemetryRecord(3, "1", "1", "aa", "bb", "2", 20, 500),
        TelemetryRecord(3, "1", "2", "bb", "aa", "1", 4, 90),
    ])
    s.check()


def test_non_utf8_rejected_and_counted_per_source():
    bad = b"data\t1\t1\t1\t\xff\xfe\tbb\t2\t5\t100\n"
    good = b"data\t1\t1\t1\ta\xc3\xa9\tbb\t2\t5\t100\n"
    assert parse_line(bad) is None and parse_line(good) is not None
    s = Spines()
    assert s.ingest_bytes(bad, source=3) == 0
    assert s.ingest_bytes(bad, source=4) == 0
    assert s.ingest_bytes(bad, source=4) == 0
    assert s.ingest_bytes(good) == 1
    s.check()
    assert s.nat.parse_errors(3) == 1 and s.nat.parse_errors(4) == 2
    assert s.nat.slot_metadata() == {0: ("a\xe9", "bb")}


@pytest.mark.parametrize("data, want", [
    (b"progress\r" + format_line(
        TelemetryRecord(1, "1", "1", "aa", "bb", "2", 5, 100)), 0),
    (b"progress\r\n" + format_line(
        TelemetryRecord(1, "1", "1", "aa", "bb", "2", 5, 100)), 1),
])
def test_cr_framing(data, want):
    """Only \\n ends a line: noise joined to telemetry by a bare \\r is one
    line that is not telemetry."""
    s = Spines(capacity=8)
    assert s.ingest_bytes(data) == want
    s.check()


@pytest.mark.parametrize("pk, by", [
    (b"-5", b"400"), (b"10", b"-400"),
    (b"99999999999999999999", b"400"), (b"10", b"18446744073709551616"),
    (b"10", b"40\x00"),
])
def test_malformed_counters_rejected(pk, by):
    line = b"data\t3\t1\t1\taa\tbb\t2\t%s\t%s\n" % (pk, by)
    s = Spines(capacity=8)
    assert s.ingest_bytes(line) == 0
    assert s.ingest_bytes(b"data\t3\t1\t1\taa\tbb\t2\t10\t400\n") == 1
    s.check()
    assert s.nat.parse_errors() == 1


def test_truncated_final_line_carries_per_source():
    s = Spines()
    l0 = format_line(TelemetryRecord(1, "1", "1", "aa", "bb", "2", 5, 100))
    l1 = format_line(TelemetryRecord(1, "1", "1", "cc", "dd", "2", 7, 700))
    assert s.ingest_bytes(l0[:9], source=1) == 0
    assert s.ingest_bytes(l1, source=2) == 1
    assert s.ingest_bytes(l0[9:], source=1) == 1
    s.check()
    assert s.nat.num_flows() == 2
    assert s.nat.slots_for_source(1).tolist() == [1]


def test_oversized_token_heap_path():
    s = Spines()
    big = "aa" * 400
    assert s.ingest_bytes(f"data\t1\t1\t1\t{big}\tbb\t2\t5\t100\n".encode()) == 1
    assert s.ingest_bytes(b"x" * 2048 + b"\n") == 0
    assert s.ingest_bytes(f"data\t2\t1\t2\tbb\t{big}\t1\t3\t60\n".encode()) == 1
    s.check()
    assert s.nat.num_flows() == 1


def test_cumulative_counter_reset():
    s = Spines()
    lines = (
        b"data\t1\t1\t1\taa\tbb\t2\t1000\t90000\n"
        b"data\t2\t1\t1\taa\tbb\t2\t2000\t180000\n"
        b"data\t3\t1\t1\taa\tbb\t2\t5\t400\n"
        b"data\t4\t1\t1\taa\tbb\t2\t10\t800\n"
    )
    for chunk in (lines[:40], lines[40:]):
        s.ingest_bytes(chunk)
        s.check()
    assert ft.features12(s.nat.table)[0, 0] == 5.0


def test_namespace_round_trip_and_evict_source():
    s = Spines(capacity=64)
    blob = (format_line(TelemetryRecord(1, "1", "1", "aa", "bb", "2", 5, 100))
            + format_line(TelemetryRecord(2, "1", "1", "aa", "bb", "2", 9, 180)))
    for sid in (0, 1, 5):
        assert s.ingest_bytes(blob, source=sid) == 2
    s.check()
    assert s.nat.num_flows() == 3
    assert [s.nat.batcher.source_parsed(sid) for sid in (0, 1, 5)] == [2, 2, 2]
    for _, e in s.all():
        assert e.evict_source(1) == 1
    s.check()
    assert s.nat.num_flows() == 2


def test_flush_wire_equals_pack_of_flush():
    """``flush_wire`` writes exactly ``pack_wire(flush())``, generation by
    generation, and switches to the full-width wire when a counter's f32
    image reaches 2^31."""
    recs = [
        TelemetryRecord(1, "1", "1", "aa", "bb", "2", 5, 100),
        TelemetryRecord(1, "1", "1", "cc", "dd", "2", 7, 1 << 33),
        TelemetryRecord(2, "1", "1", "aa", "bb", "2", 9, 180),
        TelemetryRecord(3, "1", "1", "aa", "bb", "2", 11, 250),
    ]
    blob = b"".join(format_line(r) for r in recs)
    a, b = NativeBatcher(capacity=16), NativeBatcher(capacity=16)
    a.feed(blob)
    b.feed(blob)
    widths = []
    while (w := a.flush_wire()) is not None:
        batch = b.flush()
        widths.append(w.shape[1])
        np.testing.assert_array_equal(w, ft.pack_wire(batch))
    assert b.flush() is None and 6 in widths and len(widths) == 2
    # double buffering: a flush's view survives the next flush
    c = NativeBatcher(capacity=16)
    c.feed(blob)
    v1 = c.flush_wire()
    snap = v1.copy()
    assert c.flush_wire() is not None
    np.testing.assert_array_equal(v1, snap)


@pytest.mark.parametrize("native", [True, False])
def test_eviction_churn_reuses_slots_without_drops(native):
    cap = 512
    stable_n, churn_n = cap // 2, cap // 8
    eng = FlowStateEngine(cap, device="cpu", native=native)
    generation = evicted = 0
    for tick in range(1, 11):
        if tick % 2 == 0:
            generation += 1
        recs = [
            TelemetryRecord(tick, "1", "1", f"st-{i:04x}", "gw", "2",
                            tick * 3, tick * 100)
            for i in range(stable_n)
        ] + [
            TelemetryRecord(tick, "1", "1", f"ch{generation}-{i:04x}", "gw",
                            "2", tick * 3, tick * 100)
            for i in range(churn_n)
        ]
        eng.ingest(recs)
        eng.step()
        evicted += eng.evict_idle(now=tick, idle_seconds=2)
        assert eng.dropped == 0
        assert eng.num_flows() <= stable_n + 2 * churn_n
    assert evicted >= 3 * churn_n


def _fault_plans(site: str, seed: int):
    return (
        faults.FaultPlan([faults.FaultRule(site, after=0, times=1)], seed),
        jfaults.FaultPlan([jfaults.FaultRule(site, after=0, times=1)], seed),
    )


@pytest.mark.chaos
def test_parse_fault_with_pending_tail_never_tears_framing():
    """An ``ingest.native_parse`` fire while a partial line is carried
    turns the boundary line malformed; both native spines (each under its
    own package's plan) count it and keep the records after it."""
    s = Spines(capacity=32)
    l0, l1, l2 = (format_line(TelemetryRecord(1, "1", "1", a, b, "2", p, q))
                  for a, b, p, q in (("aa", "bb", 5, 100), ("cc", "dd", 7, 700),
                                     ("ee", "ff", 9, 900)))
    half = len(l0) // 2
    for _, e in s.all():
        assert e.ingest_bytes(l0[:half], source=1) == 0
    plan, jplan = _fault_plans("ingest.native_parse", 1234)
    with faults.installed(plan), jfaults.installed(jplan):
        n_nat = s.nat.ingest_bytes(l0[half:] + l1 + l2, source=1)
        n_jax = s.jax.ingest_bytes(l0[half:] + l1 + l2, source=1)
    assert plan.fires == [("ingest.native_parse", 1)] == jplan.fires
    assert n_nat == n_jax == 2
    assert s.nat.parse_errors(1) == s.jax.parse_errors(1) == 1
    s.nat.step()
    s.jax.step()
    assert s.nat.slot_metadata() == s.jax.slot_metadata() == {
        0: ("cc", "dd"), 1: ("ee", "ff")}
    t_nat, t_jax = _table_bits(s.nat.table), _table_bits(s.jax.table)
    for k, v in t_nat.items():
        np.testing.assert_array_equal(v, t_jax[k], err_msg=k)


@pytest.mark.chaos
def test_parse_fault_on_newline_less_fragment_keeps_framing():
    l0 = format_line(TelemetryRecord(1, "1", "1", "aa", "bb", "2", 5, 100))
    l1 = format_line(TelemetryRecord(1, "1", "1", "cc", "dd", "2", 7, 700))
    nat = FlowStateEngine(32, device="cpu", native=True)
    jax_nat = JaxEngine(32, native=True)
    plan, jplan = _fault_plans("ingest.native_parse", 99)
    with faults.installed(plan), jfaults.installed(jplan):
        assert nat.ingest_bytes(l0[: len(l0) // 2], source=1) == 0
        assert jax_nat.ingest_bytes(l0[: len(l0) // 2], source=1) == 0
    assert plan.fires == jplan.fires == [("ingest.native_parse", 1)]
    for e in (nat, jax_nat):
        assert e.ingest_bytes(l0[len(l0) // 2:] + l1, source=1) == 1
        e.step()
        assert e.parse_errors(1) == 1 and e.num_flows() == 1
        assert list(e.slot_metadata().values()) == [("cc", "dd")]


@pytest.mark.chaos
def test_native_load_fault_is_absorbed_uncached():
    plan = faults.FaultPlan([faults.FaultRule("native.load", times=1)])
    with faults.installed(plan):
        assert native_engine.available() is False
        assert native_engine.available() is True


@pytest.mark.parametrize("restart", ["poison", "evict"])
def test_stale_tail_dies_at_restart(restart):
    """A dead stream's half line must not splice onto the restarted
    stream's first line: ``evict_source`` drops the tail on every spine,
    and the ``\\x00\\n`` seam ends it."""
    s = Spines(capacity=32)
    l0 = format_line(TelemetryRecord(1, "1", "1", "aa", "bb", "2", 5, 100))
    l1 = format_line(TelemetryRecord(2, "1", "1", "cc", "dd", "2", 7, 700))
    assert s.ingest_bytes(l0[:12], source=1) == 0
    for _, e in s.all():
        e.evict_source(1)
    head = b"\x00\n" if restart == "poison" else b""
    assert s.ingest_bytes(head + l1, source=1) == 1
    s.check()
    assert list(s.nat.slot_metadata().values()) == [("cc", "dd")]


def test_staging_overwrite_guard_persists_across_steps():
    """The double-buffered staging's guard counts in-flight flushes on the
    engine, across step() calls, as the JAX engine does."""
    nat = FlowStateEngine(64, device="cpu", native=True)
    jax_nat = JaxEngine(64, native=True)
    for e in (nat, jax_nat):
        assert e._staged_flushes == 0
        for expect, t in ((1, 1), (2, 2), (1, 3)):
            e.ingest_bytes(format_line(
                TelemetryRecord(t, "1", "1", "aa", "bb", "2", 5 * t, 100 * t)))
            assert e.step() is True
            assert e._staged_flushes == expect
    np.testing.assert_array_equal(ft.features12(nat.table).numpy(),
                                  np.asarray(jft.features12(jax_nat.table)))
    assert float(ft.features12(nat.table)[0, 0]) > 0.0


def test_capacity_at_wire_flag_bound_rejected():
    with pytest.raises(RuntimeError, match="2\\^30"):
        NativeBatcher(1 << 30)


def test_extra_fields_rejected_and_counted():
    s = Spines()
    assert s.ingest_bytes(b"data\t1\t1\t1\taa\tbb\t2\t5\t100\tjunk\n",
                          source=1) == 0
    assert s.ingest_bytes(b"data\t1\t1\t1\taa\tbb\t2\t5\t100\n", source=1) == 1
    s.check()
    assert s.nat.parse_errors(1) == 1


def test_counter_reset_storm():
    """Every flow's counters reset in one tick (a switch reboot): the
    three spines stay bitwise equal, with no 2^32 wrap artifact."""
    s = Spines(capacity=64)
    gen = SyntheticFlows(40, seed=3)
    for _ in range(2):
        s.ingest_bytes(gen.tick_bytes())
        s.check()
    reset = SyntheticFlows(40, seed=3, start_time=gen.t)
    for _ in range(2):
        s.ingest_bytes(reset.tick_bytes())
        s.check()
    assert float(ft.features12(s.nat.table).abs().max()) < 1e9


def test_threaded_parse_matches_python():
    """The engine's threaded parse (forced with TC_ENGINE_THREADS, which
    the engine reads at its first feed) against the Python spine, in a
    fresh process."""
    code = r"""
import numpy as np, torch
from traffic_classifier_sdn_tpu_torch.ingest.batcher import FlowStateEngine
from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows
gen = SyntheticFlows(700, seed=11, churn=0.6)
py = FlowStateEngine(1024, device="cpu")
nat = FlowStateEngine(1024, device="cpu", native=True)
for t in range(3):
    data = b"junk line\n" + gen.tick_bytes()
    py.ingest_bytes(data)
    cut = len(data) // 2 + 3
    nat.ingest_bytes(data[:cut]); nat.ingest_bytes(data[cut:])
    py.step(); nat.step()
    assert torch.equal(py.features(), nat.features())
    assert py.num_flows() == nat.num_flows()
print("THREADED_PARITY_OK")
"""
    env = dict(os.environ, TC_ENGINE_THREADS="4")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=240, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "THREADED_PARITY_OK" in r.stdout
