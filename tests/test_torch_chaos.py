"""Crash, restore and continue: the ``serving_ckpt.write``, ``.rename`` and
``.restore`` subset of ``tests/test_chaos.py``, on the port.

A seeded ``FaultPlan`` (utils/faults.py) kills a save mid-write or at the
rename, or a restore at its entry, and the recovery guarantee is proved
end to end: the previous member stays valid, the rotation rolls back to
it, and a replayed record stream converges bit for bit with a
never-killed engine; through the CLI, the fault propagates out of
``cli.main`` and the flight-recorder dump names the failing ``snapshot``
span. The probability schedules must hold for any seed
(``TCSDN_CHAOS_SEED`` and three more).
"""

import json
import os

import numpy as np
import pytest

from test_torch_incremental import N_FLOWS, _capture_and_sample, _checkpoints
from traffic_classifier_sdn_tpu.ingest.batcher import FlowStateEngine as JEngine
from traffic_classifier_sdn_tpu.ingest.protocol import TelemetryRecord as JRecord
from traffic_classifier_sdn_tpu.io import serving_checkpoint as jsc
from traffic_classifier_sdn_tpu.utils import faults as jfaults
from traffic_classifier_sdn_tpu_torch import cli
from traffic_classifier_sdn_tpu_torch.ingest.batcher import FlowStateEngine
from traffic_classifier_sdn_tpu_torch.ingest.protocol import TelemetryRecord
from traffic_classifier_sdn_tpu_torch.io import serving_checkpoint as sc
from traffic_classifier_sdn_tpu_torch.utils import faults
from torch_witnesses import _torch_locktrace_witness  # noqa: F401 — the lock witness rides this suite

SEED = int(os.environ.get("TCSDN_CHAOS_SEED", "0"))


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    assert faults.active() is None
    yield
    assert faults.active() is None, "test leaked an installed FaultPlan"
    faults.clear()


def _tick_records(R, t, n, prefix="f"):
    return [
        R(time=t, datapath="1", in_port=1, eth_src=f"{prefix}{i:03d}",
          eth_dst="gw", out_port=2, packets=7 * t + i,
          bytes=1000 * t + 13 * i)
        for i in range(n)
    ]


def _drive(eng, t, n):
    eng.mark_tick()
    eng.ingest(_tick_records(
        JRecord if isinstance(eng, JEngine) else TelemetryRecord, t, n))
    eng.step()


def _engine(capacity):
    return FlowStateEngine(capacity, device="cpu")


def _table(eng) -> dict:
    return {n: sc._fetch_leaf(eng.table, n) for n in sc._TABLE_LEAVES}


def _assert_same_table(a, b) -> None:
    ta, tb = _table(a), _table(b)
    for name in ta:
        np.testing.assert_array_equal(ta[name], tb[name], err_msg=name)


def test_kill_mid_write_rolls_back_and_replay_converges(tmp_path):
    """A kill during the checkpoint write leaves the previous member
    restorable, no temp under any checkpoint name, and replaying the
    stream reproduces the never-killed table bit for bit."""
    d = str(tmp_path / "rot")
    clean, crash = _engine(64), _engine(64)
    for t in (1, 2):
        _drive(clean, t, 20)
        _drive(crash, t, 20)
    sc.save_rotating(crash, d, tick=2, keep=3)
    for t in (3, 4):
        _drive(clean, t, 24)
        _drive(crash, t, 24)
    with faults.installed(faults.FaultPlan(
            [faults.FaultRule("serving_ckpt.write")], SEED)):
        with pytest.raises(faults.FaultInjected):
            sc.save_rotating(crash, d, tick=4, keep=3)
    del crash
    assert sc.resolve_latest(d) == sc.checkpoint_path(d, 2)
    assert all(n.startswith("ckpt-") for n in os.listdir(d))
    restored = sc.restore(d, device="cpu")
    assert restored.num_flows() == 20
    for t in (3, 4, 5):
        _drive(restored, t, 24)
        if t == 5:
            _drive(clean, t, 24)
    _assert_same_table(restored, clean)
    assert restored.num_flows() == clean.num_flows() == 24


def test_rename_fault_also_preserves_previous(tmp_path):
    d = str(tmp_path / "rot")
    eng = _engine(32)
    _drive(eng, 1, 8)
    sc.save_rotating(eng, d, tick=1, keep=3)
    _drive(eng, 2, 8)
    with faults.installed(faults.FaultPlan(
            [faults.FaultRule("serving_ckpt.rename")], SEED)):
        with pytest.raises(faults.FaultInjected):
            sc.save_rotating(eng, d, tick=2, keep=3)
    assert sc.resolve_latest(d) == sc.checkpoint_path(d, 1)
    assert os.listdir(d) == ["ckpt-000000001.npz"]
    assert sc.restore(d, device="cpu").num_flows() == 8


@pytest.mark.parametrize("seed", sorted({SEED, 1, 2, 3}))
def test_probabilistic_save_crashes_any_seed_converges(tmp_path, seed):
    """Whatever subset of saves a seeded p=0.5 schedule kills, the newest
    surviving member + replay converge to the clean run."""
    d = str(tmp_path / "rot")
    clean, crash = _engine(64), _engine(64)
    saved = []
    plan = faults.FaultPlan(
        [faults.FaultRule("serving_ckpt.write", times=None, p=0.5)], seed)
    with faults.installed(plan):
        for t in range(1, 9):
            _drive(clean, t, 16)
            _drive(crash, t, 16)
            try:
                sc.save_rotating(crash, d, tick=t, keep=3)
                saved.append(t)
            except faults.FaultInjected:
                pass
    assert plan.fires and saved, "this seed must both kill and keep saves"
    latest = sc.resolve_latest(d)
    assert latest == sc.checkpoint_path(d, saved[-1])
    restored = sc.restore(latest, device="cpu")
    for t in range(saved[-1] + 1, 9):
        _drive(restored, t, 16)
    _assert_same_table(restored, clean)


def test_restore_fault_surfaces_not_hangs(tmp_path):
    path = str(tmp_path / "s.npz")
    eng = _engine(8)
    _drive(eng, 1, 3)
    sc.save(eng, path)
    with faults.installed(faults.FaultPlan(
            [faults.FaultRule("serving_ckpt.restore")], SEED)):
        with pytest.raises(faults.FaultInjected):
            sc.restore(path, device="cpu")
    assert sc.restore(path, device="cpu").num_flows() == 3


def test_port_restores_what_a_killed_jax_rotation_left(tmp_path):
    """A JAX save killed mid-write leaves its previous member; the port
    restores that member and, replaying, converges to the never-killed
    JAX engine."""
    d = str(tmp_path / "rot")
    clean, crash = JEngine(64), JEngine(64)
    for t in (1, 2):
        _drive(clean, t, 20)
        _drive(crash, t, 20)
    jsc.save_rotating(crash, d, tick=2, keep=3)
    _drive(crash, 3, 24)
    with jfaults.installed(jfaults.FaultPlan(
            [jfaults.FaultRule("serving_ckpt.write")], SEED)):
        with pytest.raises(jfaults.FaultInjected):
            jsc.save_rotating(crash, d, tick=3, keep=3)
    restored = sc.restore(d, device="cpu")
    for t in (3, 4):
        _drive(restored, t, 24)
        _drive(clean, t, 24)
    clean_leaves = {n: np.asarray(jsc._get_leaf(clean.table, n))
                    for n in jsc._TABLE_LEAVES}
    for name, leaf in _table(restored).items():
        np.testing.assert_array_equal(leaf, clean_leaves[name], err_msg=name)


# ---------------------------------------------------------------- CLI


def _serve(tmp_path, capsys, argv):
    capture, X = _capture_and_sample(tmp_path)
    _, tdir = _checkpoints(tmp_path, "Randomforest", X)
    common = ["Randomforest", "--capacity", str(N_FLOWS), "--print-every",
              "1", "--table-rows", "16", "--native-checkpoint", tdir,
              "--device", "cpu", "--source", "replay", "--capture", capture]
    summary = cli.main(common + argv)
    capsys.readouterr()
    return summary


def test_cli_snapshot_fault_propagates_and_the_dump_names_the_span(
        tmp_path, capsys):
    """A ``serving_ckpt.write`` fire inside the serve loop propagates out
    of ``cli.main``; the post-mortem holds the fire, the ``snapshot`` and
    ``tick`` spans marked with the error, and the terminal record."""
    obs_dir = tmp_path / "dumps"
    plan = faults.FaultPlan([faults.FaultRule("serving_ckpt.write")], SEED)
    with faults.installed(plan), pytest.raises(faults.FaultInjected):
        _serve(tmp_path, capsys, ["--serve-checkpoint-every", "2",
                                  "--serve-checkpoint-dir",
                                  str(tmp_path / "rot"),
                                  "--obs-dir", str(obs_dir)])
    capsys.readouterr()
    # beside the flight-recorder post-mortem: the device plane's bundle
    # and its perf ring
    (dump,) = [n for n in os.listdir(obs_dir) if n.startswith("flightrec-")]
    assert "serve-exception" in dump
    (device,) = [n for n in os.listdir(obs_dir) if n.startswith("device-")]
    assert device.endswith("-serve-exception.json")
    assert os.path.isdir(obs_dir / "perf")
    lines = [json.loads(ln) for ln in open(obs_dir / dump)]
    assert lines[0]["kind"] == "meta"
    assert lines[0]["reason"] == "serve-exception"
    fires = [e for e in lines if e["kind"] == "fault.fire"]
    assert fires and fires[0]["site"] == "serving_ckpt.write"
    failing = {e["name"] for e in lines
               if e["kind"] == "span" and e.get("error") == "FaultInjected"}
    assert failing >= {"snapshot", "tick"}
    (terminal,) = [e for e in lines if e["kind"] == "serve.exception"]
    assert terminal["error"] == "FaultInjected"
    assert not os.listdir(tmp_path / "rot")  # the torn temp is gone


def test_cli_replay_after_a_killed_save_converges(tmp_path, capsys):
    """A serve snapshotting every tick is killed in its third save; the
    restart from the rotation resumes at tick 2 and, replaying ticks 3-6,
    ends on the never-killed serve's table and slots."""
    clean = _serve(tmp_path, capsys, ["--pipeline", "off"])
    rot = str(tmp_path / "rot")
    every = ["--serve-checkpoint-every", "1", "--serve-checkpoint-dir", rot,
             "--serve-checkpoint-budget", "0", "--pipeline", "off"]
    plan = faults.FaultPlan(
        [faults.FaultRule("serving_ckpt.write", after=2)], SEED)
    with faults.installed(plan), pytest.raises(faults.FaultInjected):
        _serve(tmp_path, capsys, every)
    assert [t for t, _ in sc.list_checkpoints(rot)] == [2, 1]
    capture = str(tmp_path / "churn.capture")
    tail = tmp_path / "tail.capture"
    tail.write_bytes(b"".join(
        ln for ln in open(capture, "rb").read().splitlines(True)
        if int(ln.split(b"\t")[1]) > 2))
    resumed = _serve(tmp_path, capsys, every + [
        "--restore-serve-state", rot, "--capture", str(tail)])
    clean.engine.step()
    _assert_same_table(resumed.engine, clean.engine)
    assert resumed.engine.slot_metadata() == clean.engine.slot_metadata()


def test_cli_restore_fault_propagates(tmp_path, capsys):
    state = str(tmp_path / "state.npz")
    _serve(tmp_path, capsys, ["--save-serve-state", state,
                              "--max-ticks", "2"])
    with faults.installed(faults.FaultPlan(
            [faults.FaultRule("serving_ckpt.restore")], SEED)), \
            pytest.raises(faults.FaultInjected):
        _serve(tmp_path, capsys, ["--restore-serve-state", state])
    summary = _serve(tmp_path, capsys, ["--restore-serve-state", state,
                                        "--max-ticks", "1"])
    assert summary.engine.num_flows() == N_FLOWS


# ---------------------------------------------------------------------------
# the drift loop and the open-set gate: seven more sites, all absorbed
# ---------------------------------------------------------------------------


def _drift_until(gate, ctl, states, limit=200):
    """Drive the drift harness (a shift after tick 12) until the
    controller reaches one of ``states``; returns every tick's labels."""
    from test_torch_drift import _drive, _wait
    from traffic_classifier_sdn_tpu_torch.serving import drift

    served = []
    i = 0
    while ctl.state not in states and i < limit:
        i += 1
        served.append(_drive("port", gate, ctl, i, shifted=i > 12))
        if ctl.state == drift.RETRAINING:
            _wait("port", ctl)
    return served


def _teacher_served(served) -> None:
    """Every tick's labels are the boot model's (the teacher's)."""
    from test_torch_drift import _batch, _teacher

    for i, labels in enumerate(served, start=1):
        lo, hi = (100.0, 10000.0) if i > 12 else (10.0, 1000.0)
        np.testing.assert_array_equal(labels, _teacher(None, _batch(
            lo, hi, seed=i)))


def test_drift_window_fault_drops_the_sample_not_the_serve(tmp_path):
    from test_torch_drift import _controller, _teacher
    from traffic_classifier_sdn_tpu_torch.serving import drift

    gate = drift.DriftGate(_teacher)
    ctl = _controller("port", tmp_path, gate, None)
    plan = faults.FaultPlan([faults.FaultRule("drift.window", times=None)],
                            SEED)
    try:
        with faults.installed(plan):
            served = _drift_until(gate, ctl, (), limit=30)
        _teacher_served(served)
        st = ctl.status()
        assert st["window_errors"] == 30 and st["windows"] == 0
        assert ctl.state == drift.STEADY and not st["calibrated"]
    finally:
        ctl.close()


@pytest.mark.parametrize("site", ["retrain.fit", "train_ckpt.write"])
def test_killed_fit_or_candidate_save_keeps_the_old_model(tmp_path, site):
    """A refit killed mid-fit (``retrain.fit``) or at its candidate's
    manifest commit (``train_ckpt.write``): the retrain fails, nothing
    half-written enters the rotation, the boot model serves every tick,
    and the still-drifting stream trips again."""
    from test_torch_drift import _controller, _teacher
    from traffic_classifier_sdn_tpu_torch.serving import drift, retrain

    gate = drift.DriftGate(_teacher)
    ctl = _controller("port", tmp_path, gate, None)
    plan = faults.FaultPlan([faults.FaultRule(site, times=None)], SEED)
    try:
        with faults.installed(plan):
            served = _drift_until(gate, ctl, (), limit=60)
        assert plan.fires
        _teacher_served(served)
        st = ctl.status()
        assert st["retrain_runs"] >= 2
        # every run failed (the last one may still await its poll)
        assert st["retrain_runs"] - st["retrain_failures"] in (0, 1)
        assert st["promotions"] == 0 and not gate.swapped
        d = str(tmp_path / "port" / "drift")
        # a save killed at its commit leaves its member directory empty
        # (the staged arrays removed, no manifest), as the JAX save does:
        # it never loads, so the boot seed stays the restore target
        for seq, path in retrain.list_candidates(d):
            assert seq == 0 or os.listdir(path) == [], path
        assert retrain.resolve_latest(d, device="cpu") == \
            retrain.candidate_path(d, 0)
    finally:
        ctl.close()


def test_promote_swap_fault_rolls_back_with_the_boot_model_serving(tmp_path):
    from test_torch_drift import _controller, _teacher
    from traffic_classifier_sdn_tpu_torch.serving import drift, retrain

    gate = drift.DriftGate(_teacher)
    ctl = _controller("port", tmp_path, gate, None)
    plan = faults.FaultPlan([faults.FaultRule("promote.swap", times=None)],
                            SEED)
    try:
        with faults.installed(plan):
            served = _drift_until(gate, ctl, (drift.ROLLED_BACK,))
        assert ctl.state == drift.ROLLED_BACK and plan.fires
        _teacher_served(served)
        d = str(tmp_path / "port" / "drift")
        assert [s for s, _ in retrain.list_candidates(d)] == [0]
        assert ctl.status()["rollbacks"] == 1 and not gate.swapped
    finally:
        ctl.close()


def test_promote_rollback_fault_keeps_the_live_pair(tmp_path):
    """The swap fails AND its rollback reload fails: the gate keeps the
    pair it holds — the boot model still serves every tick."""
    from test_torch_drift import _controller, _teacher
    from traffic_classifier_sdn_tpu_torch.obs import FlightRecorder
    from traffic_classifier_sdn_tpu_torch.serving import drift

    gate = drift.DriftGate(_teacher)
    rec = FlightRecorder()
    ctl = _controller("port", tmp_path, gate, None, recorder=rec)
    plan = faults.FaultPlan([
        faults.FaultRule("promote.swap", times=None),
        faults.FaultRule("promote.rollback", times=None),
    ], SEED)
    try:
        with faults.installed(plan):
            served = _drift_until(gate, ctl, (drift.ROLLED_BACK,))
        assert ctl.state == drift.ROLLED_BACK
        _teacher_served(served)
        assert not gate.swapped
        reasons = [e["reason"] for e in rec.tail()
                   if e["kind"] == "drift.transition"
                   and e["to"] == drift.ROLLED_BACK]
        assert reasons and "rollback-failed:FaultInjected" in reasons[-1]
        assert rec.count("drift.rollback_error") == 1
    finally:
        ctl.close()


def _openset_serve(tmp_path, extra, plan=None):
    """A gnb serve of 40 known and (from tick 6) 8 novel conversations;
    stdout under ``plan``."""
    import contextlib
    import io

    import chip_smoke
    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
    from traffic_classifier_sdn_tpu_torch.io import checkpoint as tck

    capture = str(tmp_path / "novel.capture")
    if not os.path.exists(capture):
        chip_smoke.drift_capture(capture, 40, 10, shift_at=99, novel_at=5,
                                 novel_flows=8)
        X = ft.features12(chip_smoke.synthetic_table(300, 3, "cpu")).numpy()
        tck.save_model(str(tmp_path / "gnb"), "gnb",
                       interop.gnb_params_from_numpy(
                           chip_smoke.random_gnb(0, X), "cpu"),
                       classes=chip_smoke.CLASSES)
    out = io.StringIO()
    ctx = faults.installed(plan) if plan else contextlib.nullcontext()
    with ctx, contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        summary = cli.main([
            "gaussiannb", "--native-checkpoint", str(tmp_path / "gnb"),
            "--source", "replay", "--capture", capture, "--capacity", "64",
            "--print-every", "1", "--idle-timeout", "0", "--table-rows",
            "0", "--pipeline", "off", "--device", "cpu", *extra])
    return out.getvalue(), summary


@pytest.mark.parametrize("site", ["openset.score", "openset.calibrate"])
def test_openset_faults_serve_the_inner_labels_fresh(tmp_path, site):
    """Armed on every tick: ``openset.score`` serves the closed-world
    labels fresh once armed, ``openset.calibrate`` keeps the gate
    calibrating — either way stdout is the ``--openset off`` serve's,
    never a fabricated ``unknown``, and the serve never sees a failure."""
    off, _ = _openset_serve(tmp_path, [])
    flags = ["--openset", "auto", "--openset-calibration-rows", "64"]
    on, _ = _openset_serve(tmp_path, flags)
    assert "unknown" in on and "unknown" not in off
    plan = faults.FaultPlan([faults.FaultRule(site, times=None)], SEED)
    got, summary = _openset_serve(tmp_path, flags, plan)
    assert plan.fires and got == off
    st = summary.openset
    if site == "openset.score":
        assert st["state"] == "ARMED" and st["score_faults"] > 0
    else:
        assert st["state"] == "CALIBRATING" and st["calibrate_faults"] > 0


# ----------------------------------------- obs.perf_ring / obs.profiler


def test_perf_ring_fault_drops_segment_counts_and_continues(tmp_path):
    """obs.perf_ring fires at the segment commit: that segment's samples
    drop and count (perf_ring_dropped_segments), the next segment starts
    clean, the survivors replay strictly — in both packages alike."""
    from traffic_classifier_sdn_tpu.obs import perf_recorder as jperf
    from traffic_classifier_sdn_tpu_torch.obs import perf_recorder
    from traffic_classifier_sdn_tpu_torch.utils.metrics import Metrics

    m = Metrics()
    rec = perf_recorder.PerfRecorder(str(tmp_path / "port"),
                                     ticks_per_segment=2, keep_segments=16,
                                     metrics=m, clock=lambda: 5.0)
    plan = faults.FaultPlan(
        [faults.FaultRule("obs.perf_ring", after=1, times=2)], SEED)
    with faults.installed(plan):
        for tick in range(8):
            rec.record({"tick": tick})
    assert plan.fires == [("obs.perf_ring", 2), ("obs.perf_ring", 3)]
    st = rec.status()
    assert st["segments_committed"] == 2 and st["segments_dropped"] == 2
    assert int(m.counters["perf_ring_dropped_segments"]) == 2
    assert [s["tick"] for s in perf_recorder.replay(str(tmp_path / "port"))
            ] == [0, 1, 6, 7]
    jrec = jperf.PerfRecorder(str(tmp_path / "jax"), ticks_per_segment=2,
                              keep_segments=16, clock=lambda: 5.0)
    with jfaults.installed(jfaults.FaultPlan(
            [jfaults.FaultRule("obs.perf_ring", after=1, times=2)], SEED)):
        for tick in range(8):
            jrec.record({"tick": tick})
    assert perf_recorder.replay(str(tmp_path / "jax")) == \
        perf_recorder.replay(str(tmp_path / "port")) == \
        jperf.replay(str(tmp_path / "port"))


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_perf_ring_probabilistic_accounting_any_seed(tmp_path, seed):
    from traffic_classifier_sdn_tpu_torch.obs import perf_recorder
    from traffic_classifier_sdn_tpu_torch.utils.metrics import Metrics

    m = Metrics()
    rec = perf_recorder.PerfRecorder(str(tmp_path), ticks_per_segment=2,
                                     keep_segments=32, metrics=m)
    with faults.installed(faults.FaultPlan(
            [faults.FaultRule("obs.perf_ring", times=None, p=0.4)],
            seed)) as plan:
        for tick in range(20):
            rec.record({"tick": tick})
    st = rec.status()
    assert st["segments_dropped"] == len(plan.fires)
    assert st["segments_committed"] + st["segments_dropped"] == 10
    replayed = perf_recorder.replay(str(tmp_path))
    assert len(replayed) == 2 * st["segments_committed"]
    ticks = [s["tick"] for s in replayed]
    assert ticks == sorted(ticks)


def test_profiler_fault_500s_counts_and_next_capture_succeeds(tmp_path):
    import urllib.error
    import urllib.request

    from traffic_classifier_sdn_tpu_torch.obs import (
        ExpositionServer,
        ProfilerCapture,
    )
    from traffic_classifier_sdn_tpu_torch.utils.metrics import Metrics

    m = Metrics()
    prof = ProfilerCapture(str(tmp_path / "profile"), metrics=m,
                           device="cpu")
    srv = ExpositionServer(m, port=0, host="127.0.0.1", profiler=prof)
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    plan = faults.FaultPlan([faults.FaultRule("obs.profiler", times=1)],
                            SEED)
    try:
        with faults.installed(plan):
            with pytest.raises(urllib.error.HTTPError) as e500:
                urllib.request.urlopen(base + "/profile?seconds=0.05",
                                       timeout=60)
            assert e500.value.code == 500
            assert plan.fires == [("obs.profiler", 1)]
            assert int(m.counters["profiler_capture_failures"]) == 1
            out = json.loads(urllib.request.urlopen(
                base + "/profile?seconds=0.05", timeout=60).read())
            assert out["seconds"] == 0.05
            assert int(m.counters["profiler_captures"]) == 1
    finally:
        srv.stop()
    st = prof.status()
    assert st["failures"] == 1 and st["captures"] == 1
    assert st["active"] is False


# ---------------------------------------------------------------------------
# actuation.send / actuation.barrier / actuation.retract: the three wire
# seams of the actuation plane, ABSORBED. A fire degrades the plane to
# dry-run with backoff re-probe, the ops of the flush resolve refused, and
# the re-probe's reconcile converges the switch on the plane's census;
# each case ends with the JAX plane's status on the JAX switch.
# ---------------------------------------------------------------------------

_ACT_ROWS = [
    (0, "aa:00:00:00:00:01", "aa:00:00:00:00:02", "video"),
    (1, "aa:00:00:00:00:03", "aa:00:00:00:00:04", "video"),
    (2, "aa:00:00:00:00:05", "aa:00:00:00:00:06", "attack"),
]


def _act_pkgs():
    import importlib
    import sys

    from traffic_classifier_sdn_tpu.controller import policy as jpolicy
    from traffic_classifier_sdn_tpu.serving import actuation as jact
    from traffic_classifier_sdn_tpu_torch.controller import policy
    from traffic_classifier_sdn_tpu_torch.scenarios.runner import (
        _accounting_switch_cls,
    )
    from traffic_classifier_sdn_tpu_torch.serving import actuation

    tools = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    jswitch = importlib.import_module("fake_switch").AccountingSwitch
    return {"port": (actuation, policy, faults, _accounting_switch_cls()),
            "jax": (jact, jpolicy, jfaults, jswitch)}


def _act_plane(act, pol, switch, vclock):
    import io as _io

    return act.ActuationPlane(
        pol.parse_policy("video=queue:1,attack=drop",
                         ("video", "attack", "bulk")),
        mode="push", k_install=2, k_retract=2, clock=lambda: vclock["t"],
        link_factory=lambda: act.SwitchLink(switch.host, switch.port),
        backoff_base_s=1.0, out=_io.StringIO(),
    )


def _settles(sw, n, accessor="installs"):
    import time

    deadline = time.monotonic() + 5.0
    while len(getattr(sw, accessor)()) < n and time.monotonic() < deadline:
        time.sleep(0.01)


def _actuation_drill(pkg, site, drive):
    act, pol, fmod, sw_cls = _act_pkgs()[pkg]
    vclock = {"t": 0.0}
    with sw_cls() as sw:
        plane = _act_plane(act, pol, sw, vclock)
        try:
            return drive(plane, sw, vclock, fmod)
        finally:
            plane.close()


def _send_drill(plane, sw, vclock, fmod):
    with fmod.installed(fmod.FaultPlan(
            [fmod.FaultRule("actuation.send", times=1)], SEED)) as plan:
        plane.observe(_ACT_ROWS)
        plane.observe(_ACT_ROWS)
        fires = list(plan.fires)
    degraded = plane.status()
    installs_while_down = len(sw.installs())
    plane.observe(_ACT_ROWS)
    plane.observe(_ACT_ROWS)
    vclock["t"] += 5.0
    plane.observe(_ACT_ROWS)
    _settles(sw, 3)
    return fires, degraded, installs_while_down, plane.status(), \
        len(sw.live_cookies())


def test_actuation_send_fault_degrades_to_dry_run_exact_ledger():
    got = _actuation_drill("port", "actuation.send", _send_drill)
    assert got == _actuation_drill("jax", "actuation.send", _send_drill)
    fires, degraded, installs_while_down, final, live = got
    assert fires == [("actuation.send", 1)]
    assert degraded["state"] == "degraded"
    assert degraded["ledger"] == {"intended": 3, "installed": 0,
                                  "refused": 3, "retracted": 0, "exact": True}
    assert installs_while_down == 0
    assert final["state"] == "push" and final["ledger"]["exact"]
    assert live == 3


def _barrier_drill(plane, sw, vclock, fmod):
    with fmod.installed(fmod.FaultPlan(
            [fmod.FaultRule("actuation.barrier", times=1)], SEED)) as plan:
        plane.observe(_ACT_ROWS)
        plane.observe(_ACT_ROWS)
        fires = list(plan.fires)
    degraded = plane.status()
    _settles(sw, 3)
    landed = len(sw.installs())
    plane.observe(_ACT_ROWS)
    plane.observe(_ACT_ROWS)
    vclock["t"] += 5.0
    plane.observe(_ACT_ROWS)
    import time

    deadline = time.monotonic() + 5.0
    while (sw.live_cookies() & {1, 2, 3}) and time.monotonic() < deadline:
        time.sleep(0.01)
    return fires, degraded, landed, plane.status(), sorted(sw.live_cookies())


def test_actuation_barrier_fault_orphan_mods_wiped_on_reconcile():
    got = _actuation_drill("port", "actuation.barrier", _barrier_drill)
    assert got == _actuation_drill("jax", "actuation.barrier", _barrier_drill)
    fires, degraded, landed, final, live = got
    assert fires == [("actuation.barrier", 1)]
    assert degraded["state"] == "degraded"
    assert degraded["ledger"]["refused"] == 3
    assert degraded["orphan_pairs"] == 3
    assert landed == 3  # the mods landed, unconfirmed
    assert final["state"] == "push" and final["installed_rules"] == 3
    assert final["orphan_pairs"] == 0 and final["ledger"]["exact"]
    assert len(live) == 3 and set(live).isdisjoint({1, 2, 3})


def _retract_drill(plane, sw, vclock, fmod):
    plane.observe(_ACT_ROWS)
    plane.observe(_ACT_ROWS)
    _settles(sw, 3)
    flipped = [(0, _ACT_ROWS[0][1], _ACT_ROWS[0][2], "attack")] + _ACT_ROWS[1:]
    with fmod.installed(fmod.FaultPlan(
            [fmod.FaultRule("actuation.retract", times=1)], SEED)) as plan:
        plane.observe(flipped)
        plane.observe(flipped)
        fires = list(plan.fires)
    degraded = plane.status()
    still_live = len(sw.live_cookies())
    plane.observe(flipped)
    plane.observe(flipped)
    vclock["t"] += 5.0
    plane.observe(flipped)
    import time

    deadline = time.monotonic() + 5.0
    while len(sw.live_cookies()) != 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    pair = (_ACT_ROWS[0][1], _ACT_ROWS[0][2])
    rules = [r for r in sw.rules.values()
             if (r["match"]["eth_src"], r["match"]["eth_dst"]) == pair]
    return fires, degraded, still_live, plane.status(), len(
        sw.live_cookies()), [r["instructions"] for r in rules]


def test_actuation_retract_fault_absorbed_and_pair_reconverges():
    got = _actuation_drill("port", "actuation.retract", _retract_drill)
    assert got == _actuation_drill("jax", "actuation.retract", _retract_drill)
    fires, degraded, still_live, final, live, pair_rules = got
    assert fires == [("actuation.retract", 1)]
    assert degraded["state"] == "degraded"
    assert degraded["ledger"]["refused"] == 1 and degraded["ledger"]["exact"]
    assert still_live == 3
    assert final["state"] == "push" and final["ledger"]["exact"]
    assert live == 3
    assert pair_rules == [[]]  # one rule for the pair: its new verdict, drop
