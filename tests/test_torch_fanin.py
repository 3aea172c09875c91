"""The port's fan-in ingest tier (``ingest/fanin.py``) and the CLI's fan-in
flags: bounded MPSC semantics, per-source namespacing and blast radius,
the serve loop's namespace eviction, and stdout against the JAX CLI.

The unit cases are the port's own copies of the JAX package's
(``tests/test_fanin.py``), run on the port's classes only. The CLI cases
hold the port's ``gaussiannb`` serve, on the same seeded checkpoint
carried across by ``interop``, to the JAX CLI's stdout byte for byte
where the JAX serve is deterministic (``--pipeline off``: the port commits
coalesced renders the JAX pipeline loses), and to itself across the
fan-in and direct paths. Every threaded case runs its sources in
lockstep, and every wait has a deadline that fails the test.
"""

import contextlib
import io
import time

import numpy as np
import pytest

import chip_smoke
from traffic_classifier_sdn_tpu import cli as jcli
from traffic_classifier_sdn_tpu.io import checkpoint as jck
from traffic_classifier_sdn_tpu.models import gnb as jgnb
from traffic_classifier_sdn_tpu_torch import cli, interop
from traffic_classifier_sdn_tpu_torch.ingest import fanin
from traffic_classifier_sdn_tpu_torch.ingest.batcher import (
    FlowIndex,
    FlowStateEngine,
)
from traffic_classifier_sdn_tpu_torch.ingest.protocol import (
    TelemetryRecord,
    format_line,
    stable_flow_key,
)
from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows
from traffic_classifier_sdn_tpu_torch.io import checkpoint as tck
from traffic_classifier_sdn_tpu_torch.native import engine as native_engine
from traffic_classifier_sdn_tpu_torch.utils import faults

needs_native = pytest.mark.skipif(
    not native_engine.available(), reason="the C++ engine does not build here")


def _rec(t, src, dst, pkts, bts, source=0):
    return TelemetryRecord(
        time=t, datapath="1", in_port="1", eth_src=src, eth_dst=dst,
        out_port="2", packets=pkts, bytes=bts, source=source,
    )


def _engine(capacity, native=False):
    return FlowStateEngine(capacity, device="cpu", native=native)


# ---------------------------------------------------------------------------
# key namespacing
# ---------------------------------------------------------------------------

def test_stable_flow_key_source_zero_is_legacy():
    assert stable_flow_key("1", "aa", "bb") == stable_flow_key(
        "1", "aa", "bb", source=0
    )


def test_stable_flow_key_namespaces_are_disjoint():
    keys = {stable_flow_key("1", "aa", "bb", source=s) for s in range(8)}
    assert len(keys) == 8


def test_flow_index_tracks_slot_source():
    idx = FlowIndex(capacity=16)
    a0 = idx.assign(_rec(1, "aa", "bb", 1, 10))
    a1 = idx.assign(_rec(1, "aa", "bb", 1, 10, source=1))
    a2 = idx.assign(_rec(1, "cc", "dd", 1, 10, source=2))
    # identical tuples in different namespaces take different slots
    assert a0.slot != a1.slot
    assert sorted(idx.slots_for_source(1)) == [a1.slot]
    assert sorted(idx.slots_for_source(2)) == [a2.slot]
    assert sorted(idx.slots_for_source(0)) == [a0.slot]
    # reverse-direction folding stays inside the namespace
    rev = idx.assign(_rec(2, "bb", "aa", 1, 10, source=1))
    assert rev.slot == a1.slot and not rev.is_fwd
    idx.release_slot(a1.slot)
    assert idx.slots_for_source(1) == []


# ---------------------------------------------------------------------------
# the MPSC queue
# ---------------------------------------------------------------------------

def test_queue_bound_drops_incoming_per_source():
    q = fanin.FanInQueue(max_records=5)
    assert q.put(0, [_rec(1, "a", "b", 1, 1)] * 3)
    # source 1's oversized batch drops — and is counted against source 1
    assert not q.put(1, [_rec(1, "c", "d", 1, 1)] * 4)
    assert q.put(0, [_rec(2, "a", "b", 2, 2)] * 2)
    assert q.drops() == {1: 4}
    assert q.accepted() == {0: 5}
    assert q.pending == 5


def test_queue_take_one_batch_per_source_in_arrival_order():
    q = fanin.FanInQueue(max_records=100)
    q.put(0, [_rec(1, "a", "b", 1, 1)])
    q.put(1, [_rec(1, "c", "d", 1, 1)])
    q.put(0, [_rec(2, "a", "b", 2, 2)])  # source 0's SECOND poll tick
    got = q.take()
    assert [sid for sid, _ in got] == [0, 1]
    assert got[0][1][0].time == 1  # the oldest batch, not the newest
    got2 = q.take()
    assert [(sid, recs[0].time) for sid, recs in got2] == [(0, 2)]
    assert q.pending == 0


def test_queue_take_exclude_skips_sources():
    q = fanin.FanInQueue(max_records=100)
    q.put(0, [_rec(1, "a", "b", 1, 1)])
    q.put(1, [_rec(1, "c", "d", 1, 1)])
    got = q.take(exclude={0})
    assert [sid for sid, _ in got] == [1]
    assert q.pending == 1  # source 0's batch stays queued


def test_queue_purge_counts_drops_against_the_dead_source():
    q = fanin.FanInQueue(max_records=100)
    q.put(0, [_rec(1, "a", "b", 1, 1)])
    q.put(1, [_rec(1, "c", "d", 1, 1)] * 3)
    q.put(1, [_rec(2, "c", "d", 2, 2)] * 2)
    assert q.purge(1) == 5
    assert q.drops() == {1: 5} and q.purged() == {1: 5}
    assert q.pending == 1  # source 0's batch untouched
    assert [sid for sid, _ in q.take()] == [0]


def test_raw_queue_bound_purge_and_provenance():
    """put_bytes shares the record-counted bound, the per-source drop
    accounting, the eviction-time purge and the provenance stamps."""
    clock = iter([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]).__next__
    q = fanin.FanInQueue(
        max_records=10, collect_provenance=True, prov_clock=clock,
    )
    assert q.put_bytes(0, b"l1\nl2\n", 2, emit_ts=0.5)
    assert q.put_bytes(1, b"x\n" * 9, 9) is False  # bound: 2+9 > 10
    assert q.drops() == {1: 9}
    assert q.take() == [(0, b"l1\nl2\n")]
    assert q.pop_provenance() == [(0, 0.5, 1.0, 3.0, 2)]
    assert q.put_bytes(2, b"y\n", 1)
    assert q.purge(2) == 1
    assert q.drops()[2] == 1
    assert q.take() == []


@pytest.mark.chaos
def test_fanin_put_fault_drops_against_its_own_source():
    """Fault site ``ingest.fanin_put``: a fire drops the incoming batch,
    counted against its source only; the next put of the other source
    and of the same source go through."""
    q = fanin.FanInQueue(max_records=100)
    plan = faults.FaultPlan([faults.FaultRule("ingest.fanin_put", after=1)])
    with faults.installed(plan):
        assert q.put(0, [_rec(1, "a", "b", 1, 1)] * 2)
        assert not q.put(1, [_rec(1, "c", "d", 1, 1)] * 3)  # fires
        assert q.put(1, [_rec(2, "c", "d", 2, 2)])
        assert q.put_bytes(2, b"data\thalf", 1)
    assert plan.fires == [("ingest.fanin_put", 2)]
    assert q.drops() == {1: 3}
    assert q.accepted() == {0: 2, 1: 1, 2: 1}
    assert [sid for sid, _ in q.take()] == [0, 1, 2]


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def test_parse_source_spec_kinds():
    s = fanin.parse_source_spec("cmd:python x.py", 3)
    assert s.kind == "cmd" and s.cmd == "python x.py" and s.sid == 3
    s = fanin.parse_source_spec("capture:/tmp/c.tsv", 1)
    assert s.kind == "capture" and s.path == "/tmp/c.tsv"
    s = fanin.parse_source_spec("synthetic:64", 2)
    assert s.kind == "synthetic" and s.n_flows == 64
    assert s.mac_base == 2 * 64  # disjoint MAC space per namespace


@pytest.mark.parametrize("text", ["noarg", "weird:thing",
                                  "synthetic:notanint", "capture:"])
def test_parse_source_spec_refusals(text):
    with pytest.raises(ValueError):
        fanin.parse_source_spec(text, 0)


def test_specs_from_cli_synthetic_split_disjoint():
    specs = fanin.specs_from_cli("synthetic", 4, None, synthetic_flows=64)
    assert [s.sid for s in specs] == [0, 1, 2, 3]
    assert all(s.n_flows == 16 for s in specs)
    assert [s.mac_base for s in specs] == [0, 16, 32, 48]


def test_specs_from_cli_replay_and_explicit_specs():
    specs = fanin.specs_from_cli("replay", 2, None, capture="c.tsv",
                                 interval=0.0, lockstep=True)
    assert [(s.kind, s.sid, s.path) for s in specs] == [
        ("capture", 0, "c.tsv"), ("capture", 1, "c.tsv")]
    assert all(s.lockstep and s.interval == 0.0 for s in specs)
    mixed = fanin.specs_from_cli("ryu", 0, ["synthetic:8", "capture:x"])
    assert [(s.kind, s.sid) for s in mixed] == [("synthetic", 0),
                                               ("capture", 1)]


def test_specs_from_cli_refusals():
    with pytest.raises(ValueError):
        fanin.specs_from_cli("workload", 2, None)
    with pytest.raises(ValueError):
        fanin.specs_from_cli("synthetic", 0, None)
    with pytest.raises(ValueError, match="--capture"):
        fanin.specs_from_cli("replay", 2, None)
    with pytest.raises(ValueError):
        fanin.FanInIngest([
            fanin.SourceSpec(kind="synthetic", sid=0, n_flows=1),
            fanin.SourceSpec(kind="synthetic", sid=0, n_flows=1),
        ])
    with pytest.raises(ValueError):
        fanin.FanInIngest([])


def test_specs_from_cli_rejects_identical_live_commands():
    with pytest.raises(ValueError, match="sid"):
        fanin.specs_from_cli("ryu", 3, None,
                            monitor_cmd="python -m mon --port 6653")
    specs = fanin.specs_from_cli("ryu", 3, None,
                                 monitor_cmd="python -m mon --port 66{sid}")
    assert [s.cmd for s in specs] == [
        "python -m mon --port 660", "python -m mon --port 661",
        "python -m mon --port 662",
    ]
    one = fanin.specs_from_cli("ryu", 1, None, monitor_cmd="mon")
    assert one[0].cmd == "mon"


# ---------------------------------------------------------------------------
# blast radius: kill one of three, others keep serving
# ---------------------------------------------------------------------------

def _drive(tier, eng, gen, ticks):
    """Advance the serve side: ingest ``ticks`` fan-in batches (record
    lists or RawTicks), applying expired quarantines as the CLI does."""
    evicted = {}
    for _ in range(ticks):
        batch = next(gen, None)
        if batch is None:
            break
        eng.mark_tick()
        if isinstance(batch, fanin.RawTick):
            for sid, data in batch:
                eng.ingest_bytes(data, sid)
        else:
            eng.ingest(batch)
        eng.step()
        for sid in tier.take_evictions():
            evicted[sid] = eng.evict_source(sid)
    return evicted


def _synthetic_specs(n, flows, **kw):
    return [fanin.SourceSpec(kind="synthetic", sid=i, n_flows=flows, seed=i,
                             mac_base=i * flows, lockstep=True, **kw)
            for i in range(n)]


@pytest.mark.parametrize("native", [False, pytest.param(True, marks=needs_native)],
                         ids=["python", "native"])
def test_kill_one_of_three_evicts_only_its_namespace(native):
    """Both spines: a killed source's quarantine evicts exactly its own
    slots, the survivors' slots are unchanged and keep advancing, and a
    restart re-registers the source into its old namespace."""
    tier = fanin.FanInIngest(_synthetic_specs(3, 4), quarantine_s=0.1,
                             raw=native)
    eng = _engine(64, native)
    gen = tier.ticks(tick_timeout=5.0)
    try:
        _drive(tier, eng, gen, 3)
        assert eng.num_flows() == 12
        before = {sid: eng.slots_for_source(sid).tolist() for sid in range(3)}
        assert all(len(s) == 4 for s in before.values())

        tier.kill_source(1)
        evicted = {}
        deadline = time.monotonic() + 20.0
        while not evicted and time.monotonic() < deadline:
            evicted.update(_drive(tier, eng, gen, 1))
        assert evicted == {1: 4}
        assert eng.slots_for_source(1).size == 0
        assert eng.slots_for_source(0).tolist() == before[0]
        assert eng.slots_for_source(2).tolist() == before[2]
        assert eng.num_flows() == 8
        t_before = int(eng.last_time)
        _drive(tier, eng, gen, 2)
        assert int(eng.last_time) > t_before
        states = {r["id"]: r["state"] for r in tier.roster()}
        assert states == {0: "HEALTHY", 1: "DEAD", 2: "HEALTHY"}
        assert tier.counters["source_deaths"] == 1

        assert tier.restart_source(1)
        deadline = time.monotonic() + 20.0
        while (eng.slots_for_source(1).size < 4
               and time.monotonic() < deadline):
            _drive(tier, eng, gen, 1)
        assert eng.slots_for_source(1).size == 4
        assert {r["id"]: r["state"] for r in tier.roster()}[1] == "HEALTHY"
        assert tier.counters["source_restarts"] == 1
    finally:
        gen.close()


def test_restart_within_quarantine_cancels_eviction():
    tier = fanin.FanInIngest(_synthetic_specs(2, 2), quarantine_s=60.0)
    eng = _engine(16)
    gen = tier.ticks(tick_timeout=5.0)
    try:
        _drive(tier, eng, gen, 2)
        tier.kill_source(1)
        deadline = time.monotonic() + 20.0
        while (tier.roster()[1]["state"] != "DEAD"
               and time.monotonic() < deadline):
            _drive(tier, eng, gen, 1)
        _drive(tier, eng, gen, 1)  # a supervision pass sees the death
        assert "quarantine_expires_s" in tier.roster()[1]
        tier.restart_source(1)
        assert "quarantine_expires_s" not in tier.roster()[1]
        assert _drive(tier, eng, gen, 3) == {}  # the eviction was cancelled
        assert len(eng.index.slots_for_source(1)) == 2
    finally:
        gen.close()


@pytest.mark.chaos
def test_source_dead_fault_quarantines_and_evicts():
    """Fault site ``ingest.source_dead``: source 1's pump dies on its third
    emission; the tier quarantines it and evicts its namespace while
    source 0 keeps delivering."""
    plan = faults.FaultPlan([faults.FaultRule("ingest.source_dead", after=4)])
    tier = fanin.FanInIngest(_synthetic_specs(2, 3), quarantine_s=0.0)
    eng = _engine(16)
    with faults.installed(plan):
        gen = tier.ticks(tick_timeout=5.0)
        try:
            evicted = {}
            deadline = time.monotonic() + 20.0
            while not evicted and time.monotonic() < deadline:
                evicted.update(_drive(tier, eng, gen, 1))
            _drive(tier, eng, gen, 2)
        finally:
            gen.close()
    assert len(plan.fires) == 1
    dead = [r for r in tier.roster() if not r["clean"]]
    assert [r["id"] for r in dead] == list(evicted) and evicted[dead[0]["id"]] == 3
    live = 1 - dead[0]["id"]
    assert eng.slots_for_source(live).size == 3
    assert eng.num_flows() == 3
    assert tier.counters["source_deaths"] == 1


def test_eviction_purges_dead_sources_queued_backlog():
    clock = {"t": 0.0}
    tier = fanin.FanInIngest(_synthetic_specs(2, 2), quarantine_s=5.0,
                             clock=lambda: clock["t"])
    w = tier._workers[1]
    with w._state_lock:
        w._state = fanin.SOURCE_DEAD
        w._clean = False
    for t in (1, 2, 3):
        tier.queue.put(1, [_rec(t, "x", "y", t, t, source=1)])
    tier._supervise()  # starts the quarantine clock at t=0
    assert tier.take_evictions() == []
    clock["t"] = 6.0
    assert tier.take_evictions() == [1]
    assert tier.queue.take(exclude=()) == []
    assert tier.queue.drops()[1] == 3
    clock["t"] = 60.0
    assert tier.take_evictions() == []


def test_eviction_poisons_raw_framing_even_when_queue_drained():
    clock = {"t": 0.0}
    tier = fanin.FanInIngest(_synthetic_specs(2, 2), quarantine_s=5.0,
                             clock=lambda: clock["t"], raw=True)
    w = tier._workers[1]
    with w._state_lock:
        w._state = fanin.SOURCE_DEAD
        w._clean = False
    tier.queue.put_bytes(1, b"data\thalf-a-line", 1)
    assert tier.queue.take() == [(1, b"data\thalf-a-line")]
    tier._supervise()
    clock["t"] = 6.0
    assert tier.take_evictions() == [1]
    assert tier.queue.purge(1) == 0  # drained — the purge alone saw nothing
    assert tier.queue.put_bytes(1, b"data\tfresh\n", 1)
    assert tier.queue.take() == [(1, b"\x00\ndata\tfresh\n")]
    assert tier.queue.put_bytes(0, b"data\tok\n", 1)
    assert tier.queue.take() == [(0, b"data\tok\n")]


@pytest.mark.parametrize("native", [False, pytest.param(True, marks=needs_native)],
                         ids=["python", "native"])
def test_evicted_source_tail_is_dropped_on_both_spines(native):
    """A dead source's dangling half line goes with its namespace: the
    restarted stream's first chunk, behind the queue's poison seam, never
    completes it, and other sources' tails are untouched."""
    eng = _engine(16, native)
    line = format_line(_rec(1, "aa", "bb", 5, 100))
    eng.ingest_bytes(line + line[:12], 1)
    eng.ingest_bytes(line[:12], 2)
    eng.step()
    assert eng.evict_source(1) == 1
    # what a restarted incarnation's first batch looks like after the
    # queue's poison (the dead tail would have completed into a record)
    assert eng.ingest_bytes(b"\x00\n" + line[12:], 1) == 0
    assert eng.ingest_bytes(line[12:], 2) == 1
    eng.step()
    assert eng.slots_for_source(1).size == 0
    assert eng.slots_for_source(2).size == 1


@needs_native
def test_native_evict_source_clears_exactly_one_namespace():
    nat, py = _engine(32, True), _engine(32, False)
    data = b"".join(
        format_line(_rec(1, f"h{i}", f"g{i}", 5, 100)) for i in range(4)
    )
    for sid in (0, 1, 2):
        nat.ingest_bytes(data, source=sid)
        py.ingest_bytes(data, source=sid)
    nat.step(), py.step()
    assert nat.num_flows() == py.num_flows() == 12
    assert set(nat.slots_for_source(1).tolist()) == set(
        py.index.slots_for_source(1))
    assert nat.evict_source(1) == py.evict_source(1) == 4
    assert nat.num_flows() == py.num_flows() == 8
    nat.ingest_bytes(data, source=3)
    py.ingest_bytes(data, source=3)
    nat.step(), py.step()
    assert nat.num_flows() == py.num_flows() == 12
    assert nat.slots_for_source(3).tolist() == py.slots_for_source(3).tolist()


class _Tier:
    def __init__(self, sids):
        self.sids = list(sids)
        self.asked = 0

    def evictions_due(self):
        return bool(self.sids)

    def take_evictions(self):
        self.asked += 1
        out, self.sids = self.sids, []
        return out


class _Engine:
    device = None

    def __init__(self):
        self.evicted = []

    def evict_source(self, sid):
        self.evicted.append(sid)
        return 7


class _Pipe:
    """A render in flight until ``drain`` (when the render finishes in
    time) or for good."""

    def __init__(self, idle, finishes=True):
        self._idle, self._finishes = idle, finishes
        self.drains = 0

    def idle(self):
        return self._idle

    def drain(self, timeout=None):
        self.drains += 1
        self._idle = self._finishes
        return self._idle


def test_evict_dead_namespaces_waits_for_the_render_in_flight(monkeypatch,
                                                              capsys):
    """The serve loop's pass: with nothing due, a render in flight is left
    alone; with an eviction due, the render in flight is waited for and
    the namespace evicted in the same tick (recorded on the summary and
    warned about with the JAX wording); a render still in flight after the
    wait defers the eviction, which stays pending."""
    monkeypatch.setattr(cli, "_sync", lambda device: None)
    eng = _Engine()
    summary = cli.ServeSummary(engine=eng)
    summary.ticks = 5
    pipe = _Pipe(idle=False)
    cli._evict_dead_namespaces(_Tier([]), eng, pipe, summary)
    assert pipe.drains == 0 and eng.evicted == []
    stuck, tier = _Pipe(idle=False, finishes=False), _Tier([3])
    cli._evict_dead_namespaces(tier, eng, stuck, summary)
    assert stuck.drains == 1 and tier.asked == 0 and eng.evicted == []
    cli._evict_dead_namespaces(tier, eng, pipe, summary)
    assert pipe.drains == 1 and eng.evicted == [3]
    assert [(t, sid, n) for t, sid, n, _ in summary.source_evictions] == [
        (5, 3, 7)]
    assert summary.evicted_flows == 7
    assert capsys.readouterr().err == (
        "WARNING: telemetry source 3 dead past quarantine — evicted 7 flows "
        "from its namespace\n")


# -- flap escalation ---------------------------------------------------------

class _Recorder:
    def __init__(self):
        self.events = []

    def record(self, kind, **fields):
        self.events.append(kind)


def _scripted_tier(clock, max_flaps=2, flap_window_s=60.0, recorder=None):
    return fanin.FanInIngest(
        _synthetic_specs(2, 2), quarantine_s=5.0, clock=lambda: clock["t"],
        max_flaps=max_flaps, flap_window_s=flap_window_s, recorder=recorder,
    )


def _die(tier, sid):
    w = tier._workers[sid]
    with w._state_lock:
        w._state = fanin.SOURCE_DEAD
        w._clean = False
    tier._supervise()


def test_flap_escalation_refuses_restart_and_finally_evicts():
    clock = {"t": 0.0}
    rec = _Recorder()
    tier = _scripted_tier(clock, max_flaps=2, recorder=rec)
    _die(tier, 1)
    assert tier.roster()[1]["flaps"] == 1
    assert tier.restart_source(1) is True
    assert "quarantine_expires_s" not in tier.roster()[1]
    clock["t"] = 1.0
    _die(tier, 1)  # flap 2 inside the window → escalated
    row = tier.roster()[1]
    assert row["flaps"] == 2 and row["escalated"] is True
    assert tier.restart_source(1) is False
    assert "quarantine_expires_s" in tier.roster()[1]
    clock["t"] = 7.0
    assert tier.take_evictions() == [1]
    assert "fanin.flap_escalated" in rec.events
    assert "fanin.restart_refused" in rec.events
    assert tier.counters["source_flap_escalations"] == 1
    assert tier.counters["source_restarts_refused"] == 1
    assert tier.restart_source(1, force=True) is True
    assert tier.roster()[1]["escalated"] is False


def test_flap_window_prunes_old_deaths():
    clock = {"t": 0.0}
    tier = _scripted_tier(clock, max_flaps=2, flap_window_s=10.0)
    for t in (0.0, 20.0, 40.0):
        clock["t"] = t
        _die(tier, 1)
        assert tier.roster()[1]["escalated"] is False
        assert tier.restart_source(1) is True
    assert tier.roster()[1]["flaps"] == 3


def test_flap_escalation_disabled_with_zero_cap():
    clock = {"t": 0.0}
    tier = _scripted_tier(clock, max_flaps=0)
    for i in range(6):
        clock["t"] = float(i)
        _die(tier, 1)
        assert tier.restart_source(1) is True
    assert tier.roster()[1]["escalated"] is False


def test_emitted_counter_survives_restart():
    clock = {"t": 0.0}
    tier = _scripted_tier(clock)
    tier._workers[1]._emitted = 7
    _die(tier, 1)
    assert tier.restart_source(1) is True
    assert tier.roster()[1]["emitted"] == 7
    tier._workers[1]._emitted = 3
    assert tier.roster()[1]["emitted"] == 10


def test_roster_rows_carry_the_per_source_counters():
    """The JAX tier's per-source gauges, read through ``roster()``."""
    tier = fanin.FanInIngest(_synthetic_specs(2, 2), quarantine_s=60.0)
    gen = tier.ticks(tick_timeout=5.0)
    try:
        next(gen)
        rows = tier.roster()
    finally:
        gen.close()
    assert [r["id"] for r in rows] == [0, 1]
    for r in rows:
        assert r["state"] == "HEALTHY" and r["drops"] == 0
        assert r["records"] == r["emitted"] == 4 and r["ticks"] == 1
        assert r["flaps"] == 0 and r["escalated"] is False
        assert r["lag_s"] is not None


# ---------------------------------------------------------------------------
# the CLI against itself and against the JAX CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gnb_checkpoints(tmp_path_factory):
    """The JAX test suite's seeded two-class GNB, saved by both packages."""
    rng = np.random.RandomState(0)
    jp = jgnb.from_numpy({
        "theta": rng.gamma(2.0, 100.0, (2, 12)),
        "var": rng.gamma(2.0, 50.0, (2, 12)) + 1.0,
        "class_prior": np.full(2, 0.5),
    })
    root = tmp_path_factory.mktemp("ckpt")
    jdir, tdir = str(root / "jax"), str(root / "port")
    jck.save_model(jdir, "gnb", jp, classes=("ping", "voice"))
    tck.save_model(tdir, "gnb", interop.gnb_params_from_numpy(jp, "cpu"),
                   classes=("ping", "voice"))
    return jdir, tdir


def _serve(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        summary = main(argv)
    return out.getvalue(), summary, err.getvalue()


def _base_args(ckpt):
    return ["gaussiannb", "--native-checkpoint", ckpt, "--capacity", "64",
            "--print-every", "2", "--max-ticks", "6", "--table-rows", "8"]


def _port(ckpt):
    return _base_args(ckpt) + ["--device", "cpu"]


@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_single_source_fanin_byte_identical(gnb_checkpoints, monkeypatch,
                                            pipeline):
    """``--sources 1 --source-lockstep`` prints what the direct path
    prints: the tier is a transparent wrapper until there are more
    sources."""
    monkeypatch.setattr(cli, "PIPELINE_DEPTH", 64)
    common = _port(gnb_checkpoints[1]) + [
        "--source", "synthetic", "--synthetic-flows", "8",
        "--pipeline", pipeline,
    ]
    direct, _, _ = _serve(cli.main, common)
    through, summary, _ = _serve(cli.main, common + ["--sources", "1",
                                                     "--source-lockstep"])
    assert "Flow ID" in direct and through == direct
    assert [(r["id"], r["state"]) for r in summary.roster] == [(0, "HEALTHY")]
    assert summary.source_evictions == []


def _partitioned_captures(tmp_path):
    """One capture of 8 conversations over 6 ticks, and the same records
    split into two 4-conversation captures with identical timestamps."""
    syn = SyntheticFlows(n_flows=8, seed=7)
    ticks = [syn.tick() for _ in range(6)]
    paths = [str(tmp_path / n) for n in ("whole.tsv", "a.tsv", "b.tsv")]
    macs_a = {syn._mac(i, 0) for i in range(4)}
    with open(paths[0], "wb") as fw, open(paths[1], "wb") as fa, \
            open(paths[2], "wb") as fb:
        for tick in ticks:
            for r in tick:
                fw.write(format_line(r))
                in_a = r.eth_src in macs_a or r.eth_dst in macs_a
                (fa if in_a else fb).write(format_line(r))
    return paths


@pytest.mark.parametrize("native", [
    "off", pytest.param("on", marks=needs_native)])
@pytest.mark.parametrize("incremental", ["auto", "off"])
def test_two_capture_fanin_stdout_equals_jax(gnb_checkpoints, tmp_path,
                                             incremental, native):
    """Two ``--source-spec capture:`` sources in lockstep, serial: the
    port prints exactly what the JAX CLI prints, on either ingest spine
    (raw bytes into the C++ engine per source, or records)."""
    _, part_a, part_b = _partitioned_captures(tmp_path)
    flags = ["--pipeline", "off", "--incremental", incremental,
             "--native-ingest", native, "--source-lockstep",
             "--source-spec", f"capture:{part_a}",
             "--source-spec", f"capture:{part_b}"]
    want, _, _ = _serve(jcli.main, _base_args(gnb_checkpoints[0]) + flags)
    got, summary, _ = _serve(cli.main, _port(gnb_checkpoints[1]) + flags)
    assert "Flow ID" in want and got == want
    assert summary.engine.native == (native == "on")
    assert summary.engine.num_flows() == 8


def _parse_tables(out):
    """Rendered tables as {(src, dst): (label, fwd, rev)}: the
    namespace-stripped view (slot ids relocate across namespaces)."""
    tables, current = [], None
    for line in out.splitlines():
        if line.startswith("| Flow ID"):
            current = {}
            tables.append(current)
            continue
        if current is None or not line.startswith("|"):
            continue
        cells = [c.strip() for c in line.strip("|").split("|")]
        if len(cells) == 6:
            _, src, dst, label, fwd, rev = cells
            current[(src, dst)] = (label, fwd, rev)
    return tables


@pytest.mark.parametrize("pipeline", ["off", "on"])
@pytest.mark.parametrize("incremental", ["auto", "off"])
def test_namespace_identity_one_vs_two_sources(gnb_checkpoints, tmp_path,
                                               monkeypatch, pipeline,
                                               incremental):
    """The same records through one source or split across two give the
    same per-flow labels at every render, namespace-stripped."""
    monkeypatch.setattr(cli, "PIPELINE_DEPTH", 64)
    whole, part_a, part_b = _partitioned_captures(tmp_path)
    base = _port(gnb_checkpoints[1]) + [
        "--pipeline", pipeline, "--incremental", incremental,
        "--source-lockstep",
    ]
    one, _, _ = _serve(cli.main, base + ["--source-spec", f"capture:{whole}"])
    two, summary, _ = _serve(cli.main, base + [
        "--source-spec", f"capture:{part_a}",
        "--source-spec", f"capture:{part_b}",
    ])
    t_one, t_two = _parse_tables(one), _parse_tables(two)
    assert t_one and t_one == t_two
    assert len(t_one[-1]) == 8
    assert sorted(summary.engine.slots_for_source(1).tolist()) != []


@needs_native
@pytest.mark.parametrize("incremental", ["auto", "off"])
def test_native_multisource_pipelined_equals_python(gnb_checkpoints,
                                                    tmp_path, monkeypatch,
                                                    incremental):
    """The pipelined two-source serve prints the same with raw bytes into
    the C++ engine as with records through the Python batcher."""
    monkeypatch.setattr(cli, "PIPELINE_DEPTH", 64)
    _, part_a, part_b = _partitioned_captures(tmp_path)
    base = _port(gnb_checkpoints[1]) + [
        "--incremental", incremental, "--source-lockstep",
        "--source-spec", f"capture:{part_a}",
        "--source-spec", f"capture:{part_b}",
    ]
    nat, _, _ = _serve(cli.main, base + ["--native-ingest", "on"])
    py, _, _ = _serve(cli.main, base + ["--native-ingest", "off"])
    assert "Flow ID" in nat and nat == py


@pytest.mark.parametrize("native", [
    "off", pytest.param("on", marks=needs_native)])
@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_cli_kill_one_of_three_evicts_its_namespace(gnb_checkpoints,
                                                    pipeline, native):
    """``--sources 3 --source synthetic``, source 1 killed after tick 2:
    exactly its namespace is evicted (with the warning), sources 0 and 2
    keep every slot and every tick, and the roster ends HEALTHY, DEAD,
    HEALTHY."""
    argv = [
        "gaussiannb", "--native-checkpoint", gnb_checkpoints[1],
        "--device", "cpu", "--capacity", "64", "--print-every", "2",
        "--max-ticks", "8", "--table-rows", "8", "--source", "synthetic",
        "--synthetic-flows", "24", "--sources", "3", "--source-lockstep",
        "--source-quarantine", "0", "--pipeline", pipeline,
        "--native-ingest", native,
    ]
    with chip_smoke.kill_after(2, 1):
        out, summary, err = _serve(cli.main, argv)
    assert [(sid, n) for _, sid, n, _ in summary.source_evictions] == [(1, 8)]
    # killed after tick 2: its death is seen at tick 3 or 4, and with no
    # quarantine the namespace goes at once (later under the pipeline
    # only while a render is in flight)
    assert 3 <= summary.source_evictions[0][0] < summary.ticks
    assert ("WARNING: telemetry source 1 dead past quarantine — evicted 8 "
            "flows from its namespace") in err
    eng = summary.engine
    assert eng.slots_for_source(1).size == 0
    assert eng.slots_for_source(0).size == eng.slots_for_source(2).size == 8
    assert eng.num_flows() == 16
    rows = {r["id"]: r for r in summary.roster}
    assert {s: r["state"] for s, r in rows.items()} == {
        0: "HEALTHY", 1: "DEAD", 2: "HEALTHY"}
    assert rows[0]["ticks"] == rows[2]["ticks"] == 8 and rows[1]["ticks"] == 2
    assert out.count("Flow ID") == 4


def test_cli_fanin_flags_have_the_jax_defaults():
    ja = jcli._build_parser().parse_args(["gaussiannb"])
    ta = cli._build_parser().parse_args(["gaussiannb",
                                         "--native-checkpoint", "x"])
    for flag, want in (("sources", 0), ("source_spec", None),
                       ("source_quarantine", 5.0), ("source_interval", 1.0),
                       ("source_lockstep", False)):
        assert getattr(ta, flag) == getattr(ja, flag) == want


@pytest.mark.parametrize("capacity,bound", [(64, 1 << 16), (32768, 1 << 16),
                                            (65536, 1 << 17)])
def test_fanin_queue_holds_a_poll_of_every_flow(capacity, bound):
    """The CLI's tier bounds its queue at two records per tracked flow, and
    never below the JAX tier's 65,536 records: three lockstep sources of a
    65,536-flow table put 43,690 records each, and a 65,536-record queue
    dropped a whole poll whenever two were queued together."""
    args = cli._build_parser().parse_args([
        "gaussiannb", "--native-checkpoint", "x", "--source", "synthetic",
        "--sources", "3", "--capacity", str(capacity)])
    assert cli._fanin_tier(args, raw=True).queue.max_records == bound


def test_cli_refuses_a_bad_source_spec(gnb_checkpoints):
    with pytest.raises(SystemExit, match="not KIND:ARG"):
        cli.main(_port(gnb_checkpoints[1]) + ["--source-spec", "noarg"])
