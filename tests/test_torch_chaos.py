"""The port's chaos suite: crash, restore and continue at the port's fault
sites, the counterpart of ``tests/test_chaos.py``.

A seeded ``FaultPlan`` (utils/faults.py) kills a save mid-write or at the
rename, or a restore at its entry, and the recovery guarantee is proved
end to end: the previous member stays valid, the rotation rolls back to
it, and a replayed record stream converges bit for bit with a
never-killed engine; through the CLI, the fault propagates out of
``cli.main`` and the flight-recorder dump names the failing ``snapshot``
span. The drift loop, the open-set gate, the perf ring, the profiler and
the actuation plane absorb their sites as JAX's do; the sharded spine
absorbs a dead source, a dirty-mask fault and a dropped burst.

The probability schedules must hold for any seed: ``TCSDN_CHAOS_SEED``
and the seeds after it (``tools/torch_chaos_matrix.sh`` sweeps it). Where
the port drives a plan's sites in one order, JAX's ``FaultPlan`` fed the
same hits under the same seed and rules must fire the same hits. Every
test here carries the ``chaos`` marker (``-m chaos``), as do the fault
tests in the port's other test files.
"""

import json
import os
import threading

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

pytestmark = pytest.mark.chaos


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


# ---------------------------------------------------------------------------
# the seed-dependent twins: probability schedules that must hold at any
# seed. Each asserts JAX's invariant on the port and, where the serve
# drives the sites in one order, that JAX's FaultPlan fed the port's hits
# under the same seed and rules fires the same hits.
# ---------------------------------------------------------------------------

SEEDS = [SEED, SEED + 1, SEED + 2]


class _Recorded(faults.FaultPlan):
    """A FaultPlan that keeps its hits in the order they were drawn."""

    def __init__(self, rules, seed):
        super().__init__([faults.FaultRule(**r) for r in rules], seed)
        self.rule_args = rules
        self.sequence = []
        self._order = threading.Lock()

    def check(self, site):
        with self._order:
            self.sequence.append(site)
            return super().check(site)


def _fires_equal_jax(plan) -> None:
    """JAX's FaultPlan under the same seed and rules, fed the port's hits
    in the port's order, fires exactly the port's hits."""
    jplan = jfaults.FaultPlan(
        [jfaults.FaultRule(**r) for r in plan.rule_args], plan.seed)
    for site in plan.sequence:
        jplan.check(site)
    assert jplan.fires == plan.fires and jplan.hits == plan.hits


@pytest.mark.parametrize("seed", SEEDS)
def test_degrade_dispatch_error_probabilistic_any_seed_always_renders(
        tmp_path, seed):
    """Probability-scheduled dispatch errors: whatever subset of device
    calls fail, the serve never crashes and every render tick prints a
    frame."""
    import contextlib
    import io

    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.io import checkpoint as tck

    rng = np.random.RandomState(0)
    ckpt = str(tmp_path / "gnb_ckpt")
    tck.save_model(ckpt, "gnb", interop.gnb_params_from_numpy({
        "theta": rng.gamma(2.0, 100.0, (2, 12)),
        "var": rng.gamma(2.0, 50.0, (2, 12)) + 1.0,
        "class_prior": np.full(2, 0.5),
    }, "cpu"), classes=("ping", "voice"))
    plan = _Recorded([dict(site="degrade.dispatch_error", p=0.5,
                           times=None)], seed)
    out = io.StringIO()
    with faults.installed(plan), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        cli.main([
            "gaussiannb", "--native-checkpoint", ckpt,
            "--source", "synthetic", "--synthetic-flows", "16",
            "--capacity", "64", "--print-every", "2", "--max-ticks", "40",
            "--idle-timeout", "0", "--table-rows", "8", "--pipeline", "off",
            "--degrade", "auto", "--probe-every", "0.001",
            "--probe-successes", "1", "--device", "cpu",
        ])
    assert out.getvalue().count("Flow ID") == 20
    _fires_equal_jax(plan)


@pytest.mark.parametrize("seed", SEEDS)
def test_drift_loop_probabilistic_any_seed_always_serves(tmp_path, seed):
    """Probability-scheduled failures at all four drift seams: the loop
    never raises into the serve path, every tick serves labels, and the
    state machine stays on its documented states."""
    from test_torch_drift import _controller, _drive, _teacher, _wait
    from traffic_classifier_sdn_tpu_torch.serving import drift

    gate = drift.DriftGate(_teacher)
    ctl = _controller("port", tmp_path, gate, None)
    valid = {drift.STEADY, drift.DRIFTING, drift.RETRAINING,
             drift.CANDIDATE, drift.PROMOTED, drift.ROLLED_BACK}
    plan = faults.FaultPlan([
        faults.FaultRule("drift.window", p=0.2, times=None),
        faults.FaultRule("retrain.fit", p=0.5, times=None),
        faults.FaultRule("promote.swap", p=0.5, times=None),
        faults.FaultRule("promote.rollback", p=0.5, times=None),
    ], seed)
    try:
        with faults.installed(plan):
            for i in range(1, 121):
                labels = _drive("port", gate, ctl, i, shifted=i > 12)
                assert labels.shape == (16,)
                assert ctl.state in valid
                if ctl.state == drift.RETRAINING:
                    _wait("port", ctl)
    finally:
        ctl.close()
    assert all(s in ("drift.window", "retrain.fit", "promote.swap",
                     "promote.rollback") for s, _ in plan.fires)


@pytest.mark.parametrize("seed", SEEDS)
def test_pipeline_handoff_probabilistic_any_seed_serve_survivable(seed):
    """Probability-scheduled handoff failures: every fire surfaces as
    FaultInjected at submit — never a hang, never a silent drop — and the
    pipeline drains between fires."""
    from traffic_classifier_sdn_tpu_torch.serving.pipeline import (
        ServePipeline,
    )

    done = []
    pipe = ServePipeline(done.append).start()
    attempted = queued = 0
    plan = _Recorded([dict(site="pipeline.handoff", p=0.3, times=None)],
                     seed)
    try:
        with faults.installed(plan):
            for i in range(20):
                attempted += 1
                try:
                    if pipe.submit(i):
                        queued += 1
                except faults.FaultInjected:
                    pass
            assert pipe.drain(timeout=5)
            coalesced = pipe.stats()["ticks_coalesced"]
            assert queued + coalesced + len(plan.fires) == attempted
    finally:
        pipe.shutdown(drain=False)
    assert len(done) == queued
    _fires_equal_jax(plan)


@pytest.mark.parametrize("seed", SEEDS)
def test_serve_dirty_mask_and_label_cache_probabilistic_any_seed(seed):
    """Probability-scheduled fires at both incremental seams: every
    tick's served labels equal a fresh full-table re-predict."""
    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.models import module_predict
    from traffic_classifier_sdn_tpu_torch.serving.incremental import (
        IncrementalLabels,
    )

    rng = np.random.RandomState(0)
    params = interop.gnb_params_from_numpy({
        "theta": rng.gamma(2.0, 100.0, (3, 12)),
        "var": rng.gamma(2.0, 50.0, (3, 12)) + 1.0,
        "class_prior": np.full(3, 1 / 3),
    }, "cpu")
    full = _engine(64)
    inc_eng = FlowStateEngine(64, device="cpu", track_dirty=True)
    inc = IncrementalLabels(inc_eng, module_predict, params)
    plan = _Recorded([dict(site="serve.dirty_mask", p=0.3, times=None),
                      dict(site="serve.label_cache", p=0.3, times=None)],
                     seed)
    with faults.installed(plan):
        for t in range(1, 13):
            n = (5 * t) % 30
            _drive(full, t, n)
            _drive(inc_eng, t, n)
            want = module_predict(params, full.features()).numpy()
            got = np.asarray(inc.labels())
            in_use = full.table.in_use.numpy()[:-1]
            np.testing.assert_array_equal(want[in_use], got[in_use])
    assert all(s in ("serve.dirty_mask", "serve.label_cache")
               for s, _ in plan.fires)
    _fires_equal_jax(plan)


@pytest.mark.parametrize("seed", SEEDS)
def test_fanin_put_probabilistic_accounting_any_seed(seed):
    """Probability-scheduled enqueue failures: put never raises and every
    record is accounted once — accepted + dropped == emitted, per
    source."""
    from traffic_classifier_sdn_tpu_torch.ingest import fanin

    q = fanin.FanInQueue(max_records=1 << 20)
    r = TelemetryRecord(time=1, datapath="1", in_port="1", eth_src="aa",
                        eth_dst="bb", out_port="2", packets=1, bytes=10)
    emitted = {0: 0, 1: 0, 2: 0}
    plan = _Recorded([dict(site="ingest.fanin_put", times=None, p=0.3)],
                     seed)
    with faults.installed(plan):
        for i in range(60):
            sid = i % 3
            q.put(sid, [r] * (1 + i % 4))
            emitted[sid] += 1 + i % 4
    drops, acc = q.drops(), q.accepted()
    for sid in emitted:
        assert acc.get(sid, 0) + drops.get(sid, 0) == emitted[sid]
    assert sum(drops.values()) == sum(
        1 + (hit - 1) % 4 for _, hit in plan.fires)
    _fires_equal_jax(plan)


@pytest.mark.parametrize("seed", SEEDS)
def test_native_parse_probabilistic_accounting_any_seed(seed):
    """Probability-scheduled parse-seam fires: feeds never raise, and
    parsed + skipped == emitted lines for every source, with an untouched
    source reading zero errors."""
    from traffic_classifier_sdn_tpu_torch.ingest.protocol import format_line
    from traffic_classifier_sdn_tpu_torch.native import engine as native_engine

    if not native_engine.available():
        pytest.skip("C++ engine unavailable (no g++)")
    nat = FlowStateEngine(256, device="cpu", native=True)
    r = TelemetryRecord(time=1, datapath="1", in_port="1", eth_src="aa",
                        eth_dst="bb", out_port="2", packets=1, bytes=10)
    emitted = {1: 0, 2: 0}
    plan = _Recorded([dict(site="ingest.native_parse", times=None,
                           p=0.35)], seed)
    with faults.installed(plan):
        for i in range(40):
            sid = 1 + i % 2
            n_lines = 1 + i % 3
            nat.ingest_bytes(format_line(r) * n_lines, source=sid)
            emitted[sid] += n_lines
    for sid in emitted:
        parsed = nat.batcher.source_parsed(sid)
        skipped = nat.parse_errors(sid)
        assert parsed + skipped == emitted[sid], (sid, parsed, skipped)
    assert nat.parse_errors(7) == 0
    nat.step()
    _fires_equal_jax(plan)


@pytest.mark.parametrize("seed", SEEDS)
def test_fanin_source_dead_probabilistic_survival_any_seed(seed):
    """Probability-scheduled source deaths: whatever subset of the three
    pumps dies, the serve side never sees an exception, every evicted
    namespace belongs to a dead source, and live namespaces keep their
    flows."""
    import time

    from test_torch_fanin import _drive as _fanin_drive
    from test_torch_fanin import _synthetic_specs
    from traffic_classifier_sdn_tpu_torch.ingest import fanin

    tier = fanin.FanInIngest(_synthetic_specs(3, 3), quarantine_s=0.05)
    eng = _engine(64)
    gen = tier.ticks(tick_timeout=2.0)
    evicted = {}
    try:
        with faults.installed(faults.FaultPlan(
                [faults.FaultRule("ingest.source_dead", after=3,
                                  times=None, p=0.15)], seed)):
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                evicted.update(_fanin_drive(tier, eng, gen, 1))
                if not tier.running:
                    break
            for sid in tier.take_evictions():
                evicted[sid] = eng.evict_source(sid)
    finally:
        gen.close()
    states = {r["id"]: r["state"] for r in tier.roster()}
    clean = {r["id"]: r["clean"] for r in tier.roster()}
    for sid in evicted:
        assert states[sid] == "DEAD" and not clean[sid]
        assert eng.index.slots_for_source(sid) == []
    for sid, state in states.items():
        if state != "DEAD" and eng.num_flows():
            assert len(eng.index.slots_for_source(sid)) in (0, 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_obs_stamp_probabilistic_accounting_any_seed(seed):
    """Probability-scheduled stamp failures: every batch is accounted once
    — folded-stamped + counted-unstamped == batches delivered — and no
    record is lost to the observability plane."""
    from test_torch_fanin import _synthetic_specs
    from traffic_classifier_sdn_tpu_torch.ingest import fanin
    from traffic_classifier_sdn_tpu_torch.obs.latency import LatencyProvenance
    from traffic_classifier_sdn_tpu_torch.utils.metrics import Metrics

    tier = fanin.FanInIngest(_synthetic_specs(3, 2), quarantine_s=5.0,
                             stamp=True)
    eng = _engine(64)
    m = Metrics()
    lat = LatencyProvenance(metrics=m)
    gen = tier.ticks(tick_timeout=5.0)
    batches = records = 0
    try:
        with faults.installed(faults.FaultPlan(
                [faults.FaultRule("obs.stamp", times=None, p=0.4)], seed)):
            for _ in range(5):
                batch = next(gen, None)
                assert batch is not None
                entries = tier.pop_provenance()
                batches += len(entries)
                lat.begin_tick(entries)
                eng.mark_tick()
                records += eng.ingest(batch)
                lat.mark_parse()
                eng.step()
                lat.mark_scatter()
                s = lat.seal()
                lat.mark_device(s)
                lat.render_visible(s)
    finally:
        gen.close()
    assert records == 3 * 5 * 2 * 2
    folded = m.histograms.get("e2e_emit_to_render_s")
    folded_n = folded.count if folded is not None else 0
    unstamped = int(m.counters.get("latency_unstamped_batches", 0))
    assert folded_n + unstamped == batches == 15


def _region_engine(incremental=True, capacity=64, table_rows=16):
    """The port's sharded spine over eight shards of the CPU, serving a
    three-class GNB."""
    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.models import module_predict
    from traffic_classifier_sdn_tpu_torch.parallel import mesh as meshlib
    from traffic_classifier_sdn_tpu_torch.parallel import table_sharded

    rng = np.random.RandomState(0)
    params = interop.gnb_params_from_numpy({
        "theta": rng.gamma(2.0, 100.0, (3, 12)),
        "var": rng.gamma(2.0, 50.0, (3, 12)) + 1.0,
        "class_prior": np.full(3, 1 / 3),
    }, "cpu")
    return table_sharded.ShardedFlowEngine(
        meshlib.make_mesh(devices=["cpu"] * 8), capacity,
        predict_fn=module_predict, params=params, table_rows=table_rows,
        incremental=incremental,
    )


def _region_tier(n_sources, n_flows, quarantine_s):
    from test_torch_fanin import _synthetic_specs
    from traffic_classifier_sdn_tpu_torch.ingest import fanin

    return fanin.FanInIngest(_synthetic_specs(n_sources, n_flows),
                             quarantine_s=quarantine_s)


def test_region_source_dead_sharded_blast_radius_one_namespace():
    """``ingest.source_dead`` in one of three pumps feeding the sharded
    spine: the dead namespace evicts from every shard it spans, the
    survivors keep their slots across shards, and the ranked read serves
    exactly them."""
    import time

    from test_torch_fanin import _drive as _fanin_drive

    tier = _region_tier(3, 4, 0.1)
    eng = _region_engine()
    gen = tier.ticks(tick_timeout=5.0)
    plan = faults.FaultPlan(
        [faults.FaultRule("ingest.source_dead", after=7)], SEED)
    try:
        with faults.installed(plan):
            _fanin_drive(tier, eng, gen, 2)
            assert eng.num_flows() == 12
            evicted = {}
            deadline = time.monotonic() + 30.0
            while not evicted and time.monotonic() < deadline:
                evicted.update(_fanin_drive(tier, eng, gen, 1))
        assert plan.fires, "the death rule never fired"
        states = {r["id"]: r["state"] for r in tier.roster()}
        dead = [sid for sid, s in states.items() if s == "DEAD"]
        assert len(dead) == 1
        assert evicted == {dead[0]: 4}
        assert eng.index.slots_for_source(dead[0]) == []
        survivor_slots = set()
        for sid in set(states) - set(dead):
            slots = eng.index.slots_for_source(sid)
            assert len(slots) == 4
            survivor_slots.update(slots)
        assert len({g % eng.n_shards for g in survivor_slots}) > 1
        rows, _ = eng.tick_render(now=eng.last_time, idle_seconds=None)
        assert {s for s, *_ in rows} == survivor_slots
    finally:
        gen.close()


def test_region_dirty_mask_fault_composed_spine_absorbed():
    """``serve.dirty_mask`` on the composed spine (fan-in batches into the
    sharded incremental table): that render degrades to the full
    per-shard re-predict and equals a full-predict twin fed the same
    lockstep traffic, then and after."""
    from test_torch_fanin import _drive as _fanin_drive

    tier_full, tier_inc = _region_tier(2, 6, 5.0), _region_tier(2, 6, 5.0)
    full = _region_engine(incremental=False)
    inc = _region_engine(incremental=True)
    gen_full = tier_full.ticks(tick_timeout=5.0)
    gen_inc = tier_inc.ticks(tick_timeout=5.0)
    try:
        _fanin_drive(tier_full, full, gen_full, 3)
        _fanin_drive(tier_inc, inc, gen_inc, 3)
        assert full.num_flows() == inc.num_flows() == 12
        with faults.installed(faults.FaultPlan(
                [faults.FaultRule("serve.dirty_mask")], SEED)) as plan:
            rf, _ = full.tick_render(now=full.last_time, idle_seconds=3600)
            ri, _ = inc.tick_render(now=inc.last_time, idle_seconds=3600)
        assert rf == ri
        assert plan.fires == [("serve.dirty_mask", 1)]
        _fanin_drive(tier_full, full, gen_full, 2)
        _fanin_drive(tier_inc, inc, gen_inc, 2)
        rf, _ = full.tick_render(now=full.last_time, idle_seconds=3600)
        ri, _ = inc.tick_render(now=inc.last_time, idle_seconds=3600)
        assert rf == ri
    finally:
        gen_full.close()
        gen_inc.close()


def test_region_fanin_put_drop_never_tears_sharded_scatter():
    """``ingest.fanin_put`` while pumps feed the sharded spine: a dropped
    burst costs only its own source's telemetry, and every namespace
    holds its whole population or none of it."""
    from test_torch_fanin import _drive as _fanin_drive

    tier = _region_tier(3, 4, 5.0)
    eng = _region_engine()
    gen = tier.ticks(tick_timeout=5.0)
    try:
        with faults.installed(faults.FaultPlan(
                [faults.FaultRule("ingest.fanin_put", after=2, times=2)],
                SEED)) as plan:
            _fanin_drive(tier, eng, gen, 4)
        assert plan.fires, "the drop rule never fired"
        assert tier.queue.drops()
        for r in tier.roster():
            assert len(eng.index.slots_for_source(r["id"])) in (0, 4)
        rows, _ = eng.tick_render(now=eng.last_time, idle_seconds=None)
        assert {s for s, *_ in rows} <= {
            g for r in tier.roster()
            for g in eng.index.slots_for_source(r["id"])
        }
    finally:
        gen.close()


def _openset_rows(lo, hi, n=32, seed=0):
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 12), np.float32)
    X[: n // 2, 0] = lo * (1 + 0.01 * rng.rand(n // 2))
    X[n // 2:, 0] = hi * (1 + 0.01 * rng.rand(n - n // 2))
    X[:, 1] = 1.0
    return X


@pytest.mark.parametrize("seed", SEEDS)
def test_openset_probabilistic_any_seed_never_fabricates_unknown(seed):
    """Probability-scheduled fires at both open-set seams: the gate never
    raises, and a tick whose scoring faulted equals the closed-world
    predict — the inner labels served fresh, never a fabricated
    ``unknown``."""
    from traffic_classifier_sdn_tpu_torch.serving import openset

    def teacher(params, X):
        return (np.asarray(X)[:, 0] > 500.0).astype(np.int32)

    gate = openset.OpenSetGate(teacher, n_classes=2, calibration_rows=64)
    i = 0
    while gate.state == openset.CALIBRATING:
        i += 1
        assert i < 64
        gate(None, _openset_rows(10.0, 1000.0, seed=i))
    rng = np.random.RandomState(77)
    novel = np.zeros((16, 12), np.float32)
    novel[:, 0] = 5e4 * (1 + 0.1 * rng.rand(16))
    novel[:, 1] = 1.0
    X = np.concatenate([_openset_rows(10.0, 1000.0, seed=77), novel])
    closed = teacher(None, X)
    plan = _Recorded([dict(site="openset.score", p=0.4, times=None),
                      dict(site="openset.calibrate", p=0.4, times=None)],
                     seed)
    with faults.installed(plan):
        for _ in range(20):
            before = sum(s == "openset.score" for s, _ in plan.fires)
            out = np.asarray(gate(None, X))
            if sum(s == "openset.score" for s, _ in plan.fires) > before:
                np.testing.assert_array_equal(out, closed)
            else:
                np.testing.assert_array_equal(out[:32], closed[:32])
                assert (out[32:] == gate.unknown_index).all()
    _fires_equal_jax(plan)


@pytest.mark.parametrize("seed", SEEDS)
def test_actuation_probabilistic_any_seed_ledger_exact_never_raises(seed):
    """Probability-scheduled fires at all three actuation wire seams:
    observe() never raises, the rule ledger is exact at every tick, and
    once the wire is quiet the re-probe reconverges the switch to exactly
    the plane's installed census.

    The plane's clock is virtual but its socket waits are real time: the
    link here waits up to 5 s (JAX's test: 0.25 s, a barrier 4 x 0.25 s)
    and the switch's census is awaited up to 30 s, so a loaded host only
    slows the test. A fault fires before the socket call it stands for,
    so the longer waits change no schedule."""
    import io as _io
    import time

    act, pol, _fmod, sw_cls = _act_pkgs()["port"]
    vclock = {"t": 0.0}
    rng = np.random.RandomState(seed)
    plan = _Recorded([dict(site=s, p=0.3, times=None) for s in (
        "actuation.send", "actuation.barrier", "actuation.retract")], seed)
    with sw_cls() as sw:
        plane = act.ActuationPlane(
            pol.parse_policy("video=queue:1,attack=drop",
                             ("video", "attack", "bulk")),
            mode="push", k_install=2, k_retract=2,
            clock=lambda: vclock["t"],
            link_factory=lambda: act.SwitchLink(sw.host, sw.port,
                                                timeout=5.0),
            backoff_base_s=1.0, out=_io.StringIO(),
        )
        try:
            with faults.installed(plan):
                for t in range(40):
                    rows = [
                        (0, _ACT_ROWS[0][1], _ACT_ROWS[0][2],
                         "video" if (t // 3) % 2 else "attack"),
                        _ACT_ROWS[1],
                        (2, _ACT_ROWS[2][1], _ACT_ROWS[2][2],
                         ["attack", "video", "bulk"][rng.randint(3)]),
                    ]
                    plane.observe(rows)
                    assert plane.status()["ledger"]["exact"]
                    vclock["t"] += 1.0
            for _ in range(6):
                vclock["t"] += 60.0
                plane.observe([_ACT_ROWS[1]])
            st = plane.status()
            assert st["state"] == "push"
            assert st["ledger"]["exact"]
            assert st["orphan_pairs"] == 0
            deadline = time.monotonic() + 30.0
            while (len(sw.live_cookies()) != st["installed_rules"]
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            assert len(sw.live_cookies()) == st["installed_rules"]
        finally:
            plane.close()
    _fires_equal_jax(plan)
