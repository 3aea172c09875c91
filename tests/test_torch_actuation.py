"""The port's actuation tier (``controller/policy.py``,
``serving/actuation.py``, ``tools/torch_fake_switch.AccountingSwitch``)
against the JAX package's.

- ``parse_policy`` gives JAX's actions and refuses what JAX refuses, with
  JAX's message; ``compile_install``/``compile_retract``/``compile_wipe``
  give JAX's bytes, bit for bit.
- One seeded label sequence (slot reuse, blips, flips, stale renders,
  drift rollbacks and promotions, quarantine retracts) driven through
  both planes in dry-run: ledger, counters, gauges, flight-recorder
  events and the dry-run table text equal after every tick.
- Push against the port's ``AccountingSwitch``: the refusal, stalled
  barrier, ADD-replace, quarantine-retract (both ingest spines), span and
  end-to-end cases of JAX's tests/test_actuation.py; where both packages
  run a case, the plane's status equals JAX's.
- The plane never holds its FSM lock across the wire: ``status`` and
  ``retract_source`` answer while another thread's barrier stalls, and
  concurrent observers keep the ledger exact.
- The CLI: ``--actuation dry-run`` stdout is the JAX serial serve's, byte
  for byte (serial) or by the frame-subsequence rule (pipelined); the
  usage errors are JAX's.

Tolerances: none — every comparison is exact.
"""

import contextlib
import importlib
import io
import os
import random
import sys
import threading
import time

import numpy as np
import pytest

import chip_smoke
from traffic_classifier_sdn_tpu import cli as jcli
from traffic_classifier_sdn_tpu.controller import policy as jpolicy
from traffic_classifier_sdn_tpu.io import checkpoint as jck
from traffic_classifier_sdn_tpu.models import gnb as jgnb
from traffic_classifier_sdn_tpu.obs import FlightRecorder as JRecorder
from traffic_classifier_sdn_tpu.serving import actuation as jact
from traffic_classifier_sdn_tpu.utils.metrics import Metrics as JMetrics
from traffic_classifier_sdn_tpu_torch import cli as tcli
from traffic_classifier_sdn_tpu_torch import interop
from traffic_classifier_sdn_tpu_torch.controller import openflow as of
from traffic_classifier_sdn_tpu_torch.controller import policy as tpolicy
from traffic_classifier_sdn_tpu_torch.ingest.batcher import FlowStateEngine
from traffic_classifier_sdn_tpu_torch.ingest.protocol import TelemetryRecord
from traffic_classifier_sdn_tpu_torch.io import checkpoint as tck
from traffic_classifier_sdn_tpu_torch.obs import FlightRecorder, HealthState
from traffic_classifier_sdn_tpu_torch.scenarios.runner import (
    _accounting_switch_cls,
)
from traffic_classifier_sdn_tpu_torch.serving import actuation as tact
from traffic_classifier_sdn_tpu_torch.utils import faults
from traffic_classifier_sdn_tpu_torch.utils.metrics import Metrics

CLASSES = ("video", "attack", "bulk", "web")
SPEC = "video=queue:1,attack=drop,bulk=meter:2"
SRC = "aa:bb:cc:00:00:01"
DST = "aa:bb:cc:00:00:02"


def _jax_switch_cls():
    """The JAX package's AccountingSwitch (tools/fake_switch.py), for the
    cases both packages run."""
    tools = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return importlib.import_module("fake_switch").AccountingSwitch


def _plane(mod, vclock, mode="dry-run", switch=None, k_install=3,
           k_retract=3, out=None, **kw):
    link_factory = None
    if switch is not None:
        link_factory = lambda: mod.SwitchLink(switch.host, switch.port)  # noqa: E731
    pol = tpolicy if mod is tact else jpolicy
    return mod.ActuationPlane(
        pol.parse_policy(SPEC, CLASSES), mode=mode,
        k_install=k_install, k_retract=k_retract,
        clock=lambda: vclock["t"], link_factory=link_factory,
        out=out if out is not None else io.StringIO(), **kw,
    )


def _rows(label, n=3):
    return [
        (i, f"aa:00:00:00:00:{2 * i + 1:02x}", f"aa:00:00:00:00:{2 * i + 2:02x}",
         label)
        for i in range(n)
    ]


def _settle(sw, accessor, n, timeout=5.0):
    deadline = time.monotonic() + timeout
    while len(getattr(sw, accessor)()) < n:
        if time.monotonic() > deadline:
            break
        time.sleep(0.01)
    return getattr(sw, accessor)()


# ---------------------------------------------------------------------------
# policy spec and flow-mod bytes
# ---------------------------------------------------------------------------

SPECS = [
    "video=queue:1,attack=drop,bulk=meter:2,web=mirror:7",
    " video = queue:0 , , web=drop",
    "bulk=meter:65535",
    "nosuch=drop", "video=frobnicate:1", "video=queue", "video=queue:x",
    "video=queue:-1", "video=drop:1", "video=queue:1,video=drop", "video",
    "", "unknown=drop", "=drop", "video=mirror:",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_policy_equals_jax(spec):
    def run(mod):
        try:
            out = mod.parse_policy(spec, CLASSES + ("unknown",))
        except ValueError as e:
            return "refused", str(e)
        return "ok", {k: (a.kind, a.arg, a.describe()) for k, a in out.items()}

    assert run(tpolicy) == run(jpolicy)


ACTIONS = [("queue", 1), ("queue", 0), ("meter", 5), ("drop", 0),
           ("mirror", 7), ("mirror", 0xFFFFFF00)]


@pytest.mark.parametrize("kind,arg", ACTIONS)
@pytest.mark.parametrize("xid,cookie", [(1, 1), (7, 9), (2**32 - 1, 2**64 - 1)])
def test_flow_mod_bytes_equal_jax(kind, arg, xid, cookie):
    ta, ja = tpolicy.PolicyAction(kind, arg), jpolicy.PolicyAction(kind, arg)
    assert (tpolicy.compile_instructions(ta)
            == jpolicy.compile_instructions(ja))
    assert (tpolicy.compile_install(xid, SRC, DST, ta, cookie)
            == jpolicy.compile_install(xid, SRC, DST, ja, cookie))
    assert (tpolicy.compile_retract(xid, SRC, DST, cookie)
            == jpolicy.compile_retract(xid, SRC, DST, cookie))
    assert tpolicy.compile_wipe(xid, SRC, DST) == jpolicy.compile_wipe(
        xid, SRC, DST)
    assert tpolicy.POLICY_PRIORITY == jpolicy.POLICY_PRIORITY


def test_install_golden_bytes():
    """JAX's pinned encoding of compile_install(7, SRC, DST, queue:1,
    cookie=9), and the structure parse_flow_mod reads back."""
    golden = bytes.fromhex(
        "040e00680000000700000000000000090000000000000000000000000000000a"
        "ffffffffffffffffffffffff000000000001001880000606aabbcc0000028000"
        "0806aabbcc0000010004002000000000001500080000000100000010fffffffa"
        "ffff000000000000"
    )
    raw = tpolicy.compile_install(7, SRC, DST, tpolicy.PolicyAction("queue", 1),
                                  cookie=9)
    assert raw == golden
    mod = of.parse_flow_mod(raw[of.OFP_HEADER.size:])
    assert mod["match"] == {"eth_src": SRC, "eth_dst": DST}
    assert mod["priority"] == tpolicy.POLICY_PRIORITY
    retract = of.parse_flow_mod(
        tpolicy.compile_retract(4, SRC, DST, 42)[of.OFP_HEADER.size:])
    assert retract["command"] == of.OFPFC_DELETE
    assert retract["cookie_mask"] == 0xFFFFFFFFFFFFFFFF
    wipe = of.parse_flow_mod(
        tpolicy.compile_wipe(5, SRC, DST)[of.OFP_HEADER.size:])
    assert wipe["cookie_mask"] == 0


# ---------------------------------------------------------------------------
# the hysteresis FSM: one label sequence through both planes
# ---------------------------------------------------------------------------

LABELS = CLASSES + ("unknown",)


def _script(seed, ticks=40, slots=6):
    """A seeded observation script: per tick the rows (sticky labels with
    blips and flips, a slot now and then reused by another pair), the
    stale flag and the drift state, and an occasional quarantine retract
    of two slots."""
    rng = random.Random(seed)
    pair = {s: s for s in range(slots)}
    label = {s: rng.choice(LABELS) for s in range(slots)}
    steps = []
    drift = "STEADY"
    for t in range(ticks):
        for s in range(slots):
            r = rng.random()
            if r < 0.08:
                label[s] = rng.choice(LABELS)  # a flip that sticks
            if r > 0.97:
                pair[s] += slots  # the slot now holds another conversation
        blip = {s: "unknown" for s in range(slots) if rng.random() < 0.06}
        rows = [
            (s, f"aa:00:00:00:{pair[s]:02x}:01",
             f"aa:00:00:00:{pair[s]:02x}:02", blip.get(s, label[s]))
            for s in range(slots) if rng.random() < 0.9
        ]
        if rng.random() < 0.05:
            drift = "ROLLED_BACK"
        elif drift == "ROLLED_BACK" and rng.random() < 0.3:
            drift = "PROMOTED"
        stale = rng.random() < 0.05
        quarantine = (sorted(rng.sample(range(slots), 2))
                      if rng.random() < 0.05 else None)
        steps.append((rows, stale, drift if rng.random() < 0.8 else None,
                      quarantine))
    return steps


def _fsm_trace(mod, rec_cls, metrics_cls, seed, k_install, k_retract):
    out, m, rec = io.StringIO(), metrics_cls(), rec_cls(clock=lambda: 0.0)
    vclock = {"t": 0.0}
    plane = _plane(mod, vclock, k_install=k_install, k_retract=k_retract,
                   out=out, metrics=m, recorder=rec)
    trace = []
    for rows, stale, drift, quarantine in _script(seed):
        plane.observe(rows, stale=stale, drift_state=drift)
        if quarantine is not None:
            plane.retract_source(7, quarantine)
        vclock["t"] += 1.0
        trace.append((plane.status(), out.getvalue(), dict(m.counters),
                      dict(m.gauges)))
    events = [{k: v for k, v in e.items() if k != "ts"}
              for e in rec.tail(100000)]
    return trace, events


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("k", [(1, 1), (2, 3), (3, 2)])
def test_fsm_equals_jax_on_one_label_sequence(seed, k):
    got = _fsm_trace(tact, FlightRecorder, Metrics, seed, *k)
    want = _fsm_trace(jact, JRecorder, JMetrics, seed, *k)
    assert got[0] == want[0]
    assert got[1] == want[1]
    statuses = [st for st, *_ in got[0]]
    assert all(st["ledger"]["exact"] for st in statuses)
    # the script exercises what it is for
    assert statuses[-1]["ledger"]["intended"] > 0
    assert statuses[-1]["flaps_suppressed"] > 0


def test_install_after_exactly_k_ticks():
    vclock = {"t": 0.0}
    plane = _plane(tact, vclock, k_install=3)
    for tick in range(2):
        plane.observe(_rows("video"))
        assert plane.status()["installed_rules"] == 0, f"tick {tick}"
    plane.observe(_rows("video"))
    st = plane.status()
    assert st["installed_rules"] == 3
    assert st["ledger"] == {
        "intended": 3, "installed": 3, "refused": 0, "retracted": 0,
        "exact": True,
    }


def test_ledger_spans_restarts():
    vclock = {"t": 0.0}
    plane = _plane(tact, vclock, k_install=1)
    plane.observe(_rows("video", 2))
    plane.observe(_rows("video", 2))
    carried = dict(plane.status()["ledger"],
                   flaps_suppressed=plane.status()["flaps_suppressed"],
                   rule_flaps=plane.status()["rule_flaps"])
    reborn = tact.ActuationPlane(
        tpolicy.parse_policy(SPEC, CLASSES), k_install=1,
        clock=lambda: vclock["t"], ledger=carried, out=io.StringIO(),
    )
    assert reborn.status()["ledger"]["installed"] == 2
    reborn.observe(_rows("attack", 1))
    reborn.observe(_rows("attack", 1))
    st = reborn.status()
    assert st["ledger"]["intended"] == 3 and st["ledger"]["exact"]


def test_healthz_actuation_block_and_stdout_untouched():
    vclock = {"t": 0.0}
    out = io.StringIO()
    plane = _plane(tact, vclock, k_install=1, out=out)
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        plane.observe(_rows("video", 2))
        plane.observe(_rows("video", 2))
    assert stdout.getvalue() == ""
    assert "actuation[dry-run] intended mods:" in out.getvalue()
    health = HealthState(clock=lambda: vclock["t"])
    health.set_actuation(plane.status)
    health.tick()
    ok, report = health.check()
    assert ok
    assert report["actuation"]["state"] == "dry-run"
    assert report["actuation"]["installed_rules"] == 2
    assert report["actuation"]["ledger"]["exact"]
    health.set_actuation(lambda: 1 / 0)
    ok, report = health.check()
    assert ok and report["actuation"]["state"] == "unknown"


# ---------------------------------------------------------------------------
# push against the accounting switch
# ---------------------------------------------------------------------------


def _both(case):
    """``case(plane_module, switch_class)`` run through the port and JAX;
    returns both results."""
    return (case(tact, _accounting_switch_cls()),
            case(jact, _jax_switch_cls()))


def test_accounting_switch_is_the_ports_own():
    cls = _accounting_switch_cls()
    assert cls.__module__ == "torch_fake_switch"
    assert "fake_switch" not in sys.modules or (
        sys.modules["fake_switch"].AccountingSwitch is not cls)


def test_push_refusal_accounts_and_degrades():
    def case(mod, sw_cls):
        vclock = {"t": 0.0}
        with sw_cls() as sw:
            sw.script_refuse(1)
            plane = _plane(mod, vclock, mode="push", switch=sw, k_install=1)
            try:
                plane.observe(_rows("video"))
                plane.observe(_rows("video"))
                st = plane.status()
                refusals = len(_settle(sw, "refusals", 1))
                live = len(sw.live_cookies())
            finally:
                plane.close()
        return st, refusals, live

    (st, refusals, live), want = _both(case)
    assert (st, refusals, live) == want
    assert st["ledger"]["refused"] == 1 and st["ledger"]["installed"] == 2
    assert st["ledger"]["exact"] and st["state"] == "degraded"
    assert refusals == 1 and live == 2


def test_push_stalled_barrier_refuses_flush():
    def case(mod, sw_cls):
        vclock = {"t": 0.0}
        with sw_cls() as sw:
            sw.script_stall_barrier(1)
            plane = _plane(mod, vclock, mode="push", switch=sw, k_install=1)
            try:
                plane.observe(_rows("video"))
                t0 = time.monotonic()
                plane.observe(_rows("video"))
                held = time.monotonic() - t0
                return plane.status(), held
            finally:
                plane.close()

    (st, held), (want, _) = _both(case)
    assert st == want
    assert st["state"] == "degraded"
    assert st["ledger"]["refused"] == 3 and st["ledger"]["exact"]
    assert st["orphan_pairs"] == 3
    # the wait is bounded by the link's timeout (4 × 0.25 s)
    assert held < 1.5, held


def test_switch_add_replace_semantics():
    with _accounting_switch_cls()() as sw:
        link = tact.SwitchLink(sw.host, sw.port)
        link.open()
        try:
            link.send(tpolicy.compile_install(
                link.next_xid(), SRC, DST, tpolicy.PolicyAction("queue", 1), 1))
            link.send(tpolicy.compile_install(
                link.next_xid(), SRC, DST, tpolicy.PolicyAction("drop"), 2))
            assert link.barrier(link.next_xid()) == set()
        finally:
            link.close()
        assert len(_settle(sw, "installs", 2)) == 2
        assert sw.live_cookies() == {2}


def _source_rec(t, sid, i):
    return TelemetryRecord(
        time=t, datapath="1", in_port=1,
        eth_src=f"0{sid}:00:00:00:00:{i:02x}", eth_dst="ff:00:00:00:00:01",
        out_port=2, packets=10 * t + i, bytes=1000 * t + i,
        source=sid,
    )


def _engine(native, sids=(1, 2, 3)):
    eng = FlowStateEngine(capacity=64, device="cpu", native=native)
    eng.mark_tick()
    eng.ingest([_source_rec(1, sid, i) for sid in sids for i in range(2)])
    eng.step()
    return eng


@pytest.mark.parametrize("native", [False, True])
def test_quarantine_retracts_exactly_dead_namespace(native):
    if native:
        from traffic_classifier_sdn_tpu_torch.native import engine as ne

        if not ne.available():
            pytest.skip("native engine unavailable")
    eng = _engine(native)
    vclock = {"t": 0.0}
    with _accounting_switch_cls()() as sw:
        plane = _plane(tact, vclock, mode="push", switch=sw, k_install=1)
        try:
            meta = eng.slot_metadata()
            rows = [(slot, src, dst, "video")
                    for slot, (src, dst) in sorted(meta.items())]
            plane.observe(rows)
            plane.observe(rows)
            assert plane.status()["installed_rules"] == 6
            dead_slots = eng.slots_for_source(2)
            assert len(dead_slots) == 2
            dead_pairs = {meta[int(s)] for s in dead_slots}
            plane.retract_source(2, dead_slots)
            assert eng.evict_source(2) == 2
            st = plane.status()
            assert st["installed_rules"] == 4
            assert st["ledger"]["retracted"] == 2 and st["ledger"]["exact"]
            deletes = _settle(sw, "deletes", 2)
            assert {(d["match"]["eth_src"], d["match"]["eth_dst"])
                    for d in deletes} == dead_pairs
            assert len(sw.live_cookies()) == 4
            for sid in (1, 3):
                assert len(eng.slots_for_source(sid)) == 2
        finally:
            plane.close()


def test_span_filters_foreign_slots():
    eng = _engine(False, sids=(1, 2))
    vclock = {"t": 0.0}
    plane = tact.ActuationPlane(
        tpolicy.parse_policy(SPEC, CLASSES), k_install=1,
        clock=lambda: vclock["t"],
        span=frozenset({1}), slots_for_source=eng.slots_for_source,
        out=io.StringIO(),
    )
    rows = [(slot, src, dst, "video")
            for slot, (src, dst) in sorted(eng.slot_metadata().items())]
    plane.observe(rows)
    plane.observe(rows)
    st = plane.status()
    assert st["installed_rules"] == 2 and st["ledger"]["intended"] == 2


def test_end_to_end_replay_against_fake_switch():
    """classify → install → quarantine retract → drift-rollback demote →
    re-promotion re-installs → an armed actuation.send fault degrades,
    and the backoff re-probe reconciles the switch to the plane's census
    (JAX's acceptance case, through the port)."""
    eng = _engine(False)
    meta = eng.slot_metadata()
    rows = [(slot, src, dst, "video") for slot, (src, dst) in sorted(meta.items())]
    vclock = {"t": 0.0}
    with _accounting_switch_cls()() as sw:
        plane = _plane(tact, vclock, mode="push", switch=sw,
                       k_install=2, k_retract=2, backoff_base_s=1.0)
        try:
            plane.observe(rows, drift_state="STEADY")
            assert plane.status()["installed_rules"] == 0
            plane.observe(rows, drift_state="STEADY")
            assert plane.status()["installed_rules"] == 6
            assert len(_settle(sw, "installs", 6)) == 6
            dead_slots = eng.slots_for_source(2)
            plane.retract_source(2, dead_slots)
            eng.evict_source(2)
            assert plane.status()["installed_rules"] == 4
            assert len(_settle(sw, "deletes", 2)) == 2
            rows = [r for r in rows if r[0] not in set(map(int, dead_slots))]
            plane.observe(rows, drift_state="ROLLED_BACK")
            st = plane.status()
            assert st["state"] == "demoted" and st["installed_rules"] == 0
            _settle(sw, "deletes", 6)
            assert len(sw.live_cookies()) == 0
            plane.observe(rows, drift_state="PROMOTED")
            plane.observe(rows)
            st = plane.status()
            assert st["state"] == "push" and st["installed_rules"] == 4
            assert st["rule_flaps"] == 0
            eng.mark_tick()
            eng.ingest([_source_rec(2, 4, i) for i in range(2)])
            eng.step()
            rows = [(slot, src, dst, "video")
                    for slot, (src, dst) in sorted(eng.slot_metadata().items())]
            with faults.installed(faults.FaultPlan(
                    [faults.FaultRule("actuation.send", times=1)], 0)) as plan:
                plane.observe(rows)
                t0 = time.monotonic()
                plane.observe(rows)
                held = time.monotonic() - t0
                assert plan.fires == [("actuation.send", 1)]
            assert held < 1.0, held
            st = plane.status()
            assert st["state"] == "degraded" and st["ledger"]["exact"]
            plane.observe(rows)
            plane.observe(rows)
            vclock["t"] += 5.0
            plane.observe(rows)
            st = plane.status()
            assert st["state"] == "push" and st["installed_rules"] == 6
            assert st["ledger"]["exact"] and st["rule_flaps"] == 0
            deadline = time.monotonic() + 5.0
            while len(sw.live_cookies()) != 6 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert len(sw.live_cookies()) == 6
        finally:
            plane.close()


# ---------------------------------------------------------------------------
# the FSM lock is never held across the wire
# ---------------------------------------------------------------------------


def test_a_stalled_barrier_holds_neither_status_nor_retract_source():
    """One thread's flush waits on a withheld barrier reply; meanwhile
    another thread's ``status`` and ``retract_source`` return at once
    (the retract is queued and the stalled flusher pushes it), and at the
    end every op is resolved with the ledger exact."""
    vclock = {"t": 0.0}
    with _accounting_switch_cls()() as sw:
        plane = _plane(tact, vclock, mode="push", switch=sw, k_install=1)
        try:
            plane.observe(_rows("video"))
            plane.observe(_rows("video"))  # installed, confirmed
            assert plane.status()["installed_rules"] == 3
            sw.script_stall_barrier(1)
            flipped = [(0, *_rows("video")[0][1:3], "attack")]
            stalled = threading.Thread(
                target=lambda: [plane.observe(flipped, drift_state="ROLLED_BACK")])
            stalled.start()
            time.sleep(0.2)  # inside the barrier wait
            t0 = time.monotonic()
            plane.status()
            plane.retract_source(3, [1])
            answered = time.monotonic() - t0
            stalled.join(timeout=10.0)
            assert not stalled.is_alive()
            assert answered < 0.2, answered
            st = plane.status()
            assert st["ledger"]["exact"]
            assert (st["ledger"]["intended"] == st["ledger"]["installed"]
                    + st["ledger"]["refused"] + st["ledger"]["retracted"])
            assert st["state"] == "demoted"
        finally:
            plane.close()


def test_concurrent_observers_keep_the_ledger_exact():
    """Eight threads (more than the sandbox's cores) observe, retract and
    read status on one dry-run plane under a short switch interval: no op
    is lost, the ledger is exact and nothing stays in flight."""
    plane = _plane(tact, {"t": 0.0}, k_install=1, k_retract=1)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def worker(w):
        rng = random.Random(w)
        for _ in range(200):
            label = rng.choice(LABELS)
            base = rng.randrange(4) * 3
            plane.observe([(base + i, f"aa:00:00:00:{base + i:02x}:01",
                            f"aa:00:00:00:{base + i:02x}:02", label)
                           for i in range(3)])
            if rng.random() < 0.1:
                plane.retract_source(w, [rng.randrange(12)])
            plane.status()

    try:
        threads = [threading.Thread(target=worker, args=(w,)) for w in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    st = plane.status()
    assert st["ledger"]["exact"] and st["ledger"]["intended"] > 0
    assert plane._inflight == 0 and plane._pending == []
    assert st["ledger"] == plane.ledger.as_dict()


# ---------------------------------------------------------------------------
# CLI: transparency + validation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    rng = np.random.RandomState(0)
    d = {
        "theta": rng.gamma(2.0, 100.0, (2, 12)),
        "var": rng.gamma(2.0, 50.0, (2, 12)) + 1.0,
        "class_prior": np.full(2, 0.5),
    }
    root = tmp_path_factory.mktemp("act_ckpt")
    jdir, tdir = str(root / "jax"), str(root / "port")
    jck.save_model(jdir, "gnb", jgnb.from_numpy(d), classes=("ping", "voice"))
    tck.save_model(tdir, "gnb", interop.gnb_params_from_numpy(d, device="cpu"),
                   classes=("ping", "voice"))
    return jdir, tdir


def _serve(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv)
    return out.getvalue(), err.getvalue()


def _common(ckpt):
    return [
        "gaussiannb", "--native-checkpoint", ckpt,
        "--source", "synthetic", "--synthetic-flows", "16",
        "--capacity", "64", "--print-every", "2", "--max-ticks", "10",
        "--idle-timeout", "0", "--table-rows", "8",
    ]


ACT = ["--actuation", "dry-run", "--actuation-k-install", "2",
       "--policy", "ping=queue:1,voice=queue:2"]


@pytest.mark.parametrize("incremental", ["off", "auto"])
@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_actuation_dry_run_stdout_equals_jax_serial_serve(
        checkpoints, pipeline, incremental):
    """``--actuation dry-run`` and ``off`` through the port print JAX's
    serial (``--pipeline off``) stdout: byte for byte serially, by the
    subsequence rule pipelined (renders coalesce by timing). The
    intended-mods table is on stderr only, and is JAX's."""
    jdir, tdir = checkpoints
    want, want_err = _serve(jcli.main, _common(jdir) + [
        "--pipeline", "off", "--incremental", incremental, *ACT])
    assert "Flow ID" in want
    port = _common(tdir) + ["--device", "cpu", "--pipeline", pipeline,
                            "--incremental", incremental]
    off, _ = _serve(tcli.main, port)
    dry, dry_err = _serve(tcli.main, port + ACT)
    assert "actuation[dry-run] intended mods:" in dry_err
    assert "actuation" not in dry
    for got in (off, dry):
        if pipeline == "off":
            assert got == want
        else:
            assert chip_smoke.subsequence(got, want)
    if pipeline == "off":
        table = [ln for ln in dry_err.splitlines()
                 if ln.startswith(("actuation[", "  + ", "  - "))]
        assert table == [ln for ln in want_err.splitlines()
                         if ln.startswith(("actuation[", "  + ", "  - "))]


def test_cli_actuation_validation_equals_jax(checkpoints):
    jdir, tdir = checkpoints
    cases = [
        ["--actuation", "dry-run"],
        ["--policy", "ping=drop"],
        ["--actuation", "push", "--policy", "ping=drop"],
    ]
    for extra in cases:
        with pytest.raises(SystemExit) as want:
            jcli.main(["gaussiannb", *extra])
        with pytest.raises(SystemExit) as got:
            tcli.main(["gaussiannb", "--native-checkpoint", tdir, *extra])
        assert str(got.value) == str(want.value)
    serving = [
        ["--actuation", "dry-run", "--policy", "nosuch=drop"],
        ["--actuation", "push", "--policy", "ping=drop",
         "--actuation-switch", "nohost"],
        ["--actuation", "dry-run", "--policy", "ping=drop",
         "--actuation-span", "a,b"],
    ]
    for extra in serving:
        with pytest.raises(SystemExit) as want:
            _serve(jcli.main, _common(jdir) + extra)
        with pytest.raises(SystemExit) as got:
            _serve(tcli.main, _common(tdir) + ["--device", "cpu", *extra])
        assert str(got.value) == str(want.value)


def test_cli_summary_carries_the_plane_and_quarantine_retracts(tmp_path):
    """A fan-in serve whose source 1 dies: its namespace's rules retract
    with its slots (``retract_source`` before the engine releases them),
    and the summary carries the plane's final status."""
    rng = np.random.RandomState(0)
    d = {"theta": rng.gamma(2.0, 100.0, (2, 12)),
         "var": rng.gamma(2.0, 50.0, (2, 12)) + 1.0,
         "class_prior": np.full(2, 0.5)}
    ckpt = str(tmp_path / "gnb")
    tck.save_model(ckpt, "gnb", interop.gnb_params_from_numpy(d, device="cpu"),
                   classes=("ping", "voice"))
    argv = ["gaussiannb", "--native-checkpoint", ckpt, "--device", "cpu",
            "--source", "synthetic", "--sources", "2", "--synthetic-flows",
            "8", "--source-lockstep", "--source-quarantine", "0",
            "--capacity", "64", "--print-every", "1", "--max-ticks", "8",
            "--table-rows", "0", "--pipeline", "off",
            "--actuation", "dry-run", "--actuation-k-install", "1",
            "--policy", "ping=queue:1,voice=drop"]
    err = io.StringIO()
    with chip_smoke.kill_after(4, 1), contextlib.redirect_stdout(
            io.StringIO()), contextlib.redirect_stderr(err):
        summary = tcli.main(argv)
    assert summary.source_evictions and summary.source_evictions[0][1] == 1
    assert "reason=quarantine sid=1" in err.getvalue()
    st = summary.actuation
    assert st["mode"] == "dry-run" and st["ledger"]["exact"]
    assert st["ledger"]["retracted"] >= 1
