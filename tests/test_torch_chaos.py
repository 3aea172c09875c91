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
