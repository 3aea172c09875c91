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
    (dump,) = os.listdir(obs_dir)
    assert "serve-exception" in dump
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
