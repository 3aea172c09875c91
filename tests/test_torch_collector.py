"""The port's ``--source ryu`` path: ``ingest/collector.py`` (the monitor
subprocess and its pipe), ``ingest/supervisor.py`` (restart of a dead
monitor with exponential backoff) and the CLI that reads them, with a
``python -c`` emitter as the monitor command.

- The collector yields the monitor's bytes (``raw=True``) or its parsed
  records (``raw=False``) exactly as the JAX package's collector does on
  the same emitter, also under an injected torn read.
- The supervisor walks the JAX package's backoff and budget ladder on a
  scripted clock, and restarts a real monitor that died mid-line, with
  the ``\\x00\\n`` seam between the two incarnations.
- The CLI (``--source ryu --monitor-cmd``) ends in the same table and
  slot metadata as a replay serve of the same lines, with native ingest on
  (raw pipe bytes) and off (records), with and without a dead-monitor
  restart. End state, not stdout, is compared: how a tick's lines split
  across polls depends on timing, and the end state does not.
"""

import shlex
import sys
import time

import numpy as np
import pytest

import chip_smoke
from traffic_classifier_sdn_tpu.ingest import collector as jcollector
from traffic_classifier_sdn_tpu.ingest import supervisor as jsupervisor
from traffic_classifier_sdn_tpu.utils import faults as jfaults
from traffic_classifier_sdn_tpu_torch import cli, interop
from traffic_classifier_sdn_tpu_torch.ingest import collector, supervisor
from traffic_classifier_sdn_tpu_torch.ingest.protocol import (
    TelemetryRecord,
    format_line,
    parse_line,
    stamp_records,
)
from traffic_classifier_sdn_tpu_torch.io import checkpoint
from traffic_classifier_sdn_tpu_torch.utils import faults
from traffic_classifier_sdn_tpu_torch.utils.metrics import global_metrics

N_FLOWS = 24

# A monitor: prints a capture's ticks (lines grouped by their time field)
# to stdout, PAUSE s apart. With a marker path, the first incarnation
# creates it and dies with status 1 in the middle of tick DIE's first
# line; a later one prints the ticks from DIE on.
EMITTER = """
import os, sys, time
cap, pause, marker, die = sys.argv[1], float(sys.argv[2]), sys.argv[3], int(sys.argv[4])
ticks = {}
for line in open(cap, "rb"):
    ticks.setdefault(line.split(b"\\t", 2)[1], []).append(line)
ticks = list(ticks.values())
first = marker == "-" or not os.path.exists(marker)
if marker != "-" and first:
    open(marker, "w").close()
out = sys.stdout.buffer
out.write(b"loading app simple_monitor_13.py\\n")
for i, lines in enumerate(ticks):
    if die >= 0 and i < die and not first:
        continue
    if die >= 0 and i == die and first:
        out.write(lines[0][:12])
        out.flush()
        sys.exit(1)
    out.write(b"".join(lines))
    out.flush()
    time.sleep(pause)
"""


def _emitter_cmd(capture, pause=0.0, marker="-", die=-1) -> str:
    return (f"{shlex.quote(sys.executable)} -c {shlex.quote(EMITTER)} "
            f"{shlex.quote(str(capture))} {pause} {shlex.quote(str(marker))} "
            f"{die}")


@pytest.fixture
def capture(tmp_path):
    path = tmp_path / "churn.capture"
    chip_smoke.churn_capture(str(path), N_FLOWS)
    return path


def _drain(coll, timeout: float = 30.0) -> list:
    """Everything a collector yields until its monitor is done."""
    got = []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        item = coll.wait_record(timeout=0.2)
        if item is not None:
            got.append(item)
            got.extend(coll.poll_records())
        elif not coll.running:
            break
    coll.stop()
    return got


@pytest.mark.parametrize("raw", [True, False])
def test_collector_yields_what_the_jax_collector_yields(capture, raw):
    cmd = _emitter_cmd(capture)
    port = _drain_started(collector.SubprocessCollector(cmd, raw=raw))
    ref = _drain_started(jcollector.SubprocessCollector(cmd, raw=raw))
    if raw:
        assert b"".join(port) == b"".join(ref) == (
            b"loading app simple_monitor_13.py\n" + capture.read_bytes())
    else:
        assert [format_line(r) for r in port] == [format_line(r) for r in ref]
        assert b"".join(format_line(r) for r in port) == capture.read_bytes()
    assert collector.DEFAULT_MONITOR_CMD == jcollector.DEFAULT_MONITOR_CMD


def _drain_started(coll) -> list:
    coll.start()
    return _drain(coll)


def test_stamped_records_carry_the_read_time(capture):
    t0 = time.perf_counter()
    recs = _drain_started(collector.SubprocessCollector(
        _emitter_cmd(capture), stamp=True))
    assert recs and all(t0 <= r.emit_ts <= time.perf_counter() for r in recs)
    r = TelemetryRecord(1, "1", "1", "aa", "bb", "2", 5, 100)
    assert stamp_records([r], 3.0) and r.emit_ts == 3.0
    assert stamp_records([r], 4.0) and r.emit_ts == 3.0  # stamped once
    assert r == TelemetryRecord(1, "1", "1", "aa", "bb", "2", 5, 100)
    plan = faults.FaultPlan([faults.FaultRule("obs.stamp")])
    fresh = TelemetryRecord(1, "1", "1", "aa", "bb", "2", 5, 100)
    with faults.installed(plan):
        assert stamp_records([fresh]) is False
    assert fresh.emit_ts is None


@pytest.mark.chaos
def test_torn_read_costs_lines_never_corrupts_them(tmp_path, capture):
    """``collector.read`` truncating the first chunk: both packages'
    collectors count the lost lines and poison the seam, so every line
    that still parses is one the monitor printed."""
    prog = (
        "import sys, time\n"
        f"data = open({str(capture)!r}, 'rb').read()\n"
        "step = len(data) // 3 + 1\n"
        "for i in range(3):\n"
        "    sys.stdout.buffer.write(data[i * step:(i + 1) * step])\n"
        "    sys.stdout.buffer.flush()\n"
        "    time.sleep(0.2)\n"
    )
    cmd = f"{shlex.quote(sys.executable)} -c {shlex.quote(prog)}"
    emitted = set(capture.read_bytes().splitlines())
    results = []
    for mod, fmod in ((collector, faults), (jcollector, jfaults)):
        plan = fmod.FaultPlan([fmod.FaultRule("collector.read",
                                              kind="truncate")], 7)
        with fmod.installed(plan):
            coll = mod.SubprocessCollector(cmd, raw=True)
            chunks = _drain_started(coll)
        assert plan.fires == [("collector.read", 1)]
        assert coll.lines_dropped > 0
        data = b"".join(chunks)
        assert b"\x00\n" in data
        lines = data.split(b"\n")[:-1]
        parsed = [format_line(r).rstrip(b"\n")
                  for r in map(parse_line, (ln + b"\n" for ln in lines)) if r]
        assert parsed and set(parsed) <= emitted
        results.append((coll.lines_dropped, parsed))
    assert results[0] == results[1]


class _Scripted:
    """A fake monitor incarnation: dead with ``returncode``, or alive."""

    def __init__(self, returncode):
        self.returncode = returncode
        self.finished = returncode is not None
        self.running = returncode is None
        self.lines_dropped = 0

    def start(self):
        pass

    def stop(self):
        self.running = False

    def drain(self):
        return []

    def wait_record(self, timeout):
        return None

    def poll_records(self, max_records=1 << 20):
        return []


def _ladder(mod, fmod, deaths: int, fail_spawn: bool):
    """The backoff schedule, restarts and end of a supervisor whose
    monitors die ``deaths`` times, on a scripted clock."""
    now = [100.0]
    script = iter([_Scripted(1) for _ in range(deaths)] + [_Scripted(None)])
    sup = mod.SupervisedCollector("unused", clock=lambda: now[0],
                                  max_restarts=3, backoff_base=0.5,
                                  backoff_cap=1.5)
    sup._spawn = lambda: next(script)
    sup.start()
    rules = [fmod.FaultRule("supervisor.restart")] if fail_spawn else []
    log = []
    with fmod.installed(fmod.FaultPlan(rules, 3)):
        for _ in range(12):
            sup._check()
            log.append((sup.restarts, sup._next_restart_at, sup.phase,
                        sup.running))
            now[0] += 0.5
    return log, sup.terminal_reason


@pytest.mark.chaos
@pytest.mark.parametrize("deaths, fail_spawn", [(1, False), (2, True),
                                                (4, False)])
def test_backoff_ladder_matches_jax(deaths, fail_spawn):
    port = _ladder(supervisor, faults, deaths, fail_spawn)
    assert port == _ladder(jsupervisor, jfaults, deaths, fail_spawn)
    restarts = [r for r, *_ in port[0]]
    assert restarts[-1] == min(deaths + fail_spawn, 3)
    if deaths + fail_spawn > 3:
        assert port[1] == "restart-budget"


@pytest.mark.chaos
def test_supervisor_restarts_a_monitor_that_died_mid_line(tmp_path, capture):
    """The first incarnation dies halfway into a line; the supervisor
    drains it, adds the ``\\x00\\n`` seam, restarts after the backoff, and
    the second incarnation's lines follow. Parsed with the engine's
    framing, the stream is the capture's lines and one malformed line."""
    sup = supervisor.SupervisedCollector(
        _emitter_cmd(capture, marker=tmp_path / "died", die=2), raw=True,
        max_restarts=2, backoff_base=0.05)
    sup.start()
    data = b"".join(_drain(sup))
    assert sup.restarts == 1 and sup.terminal_reason == "clean-exit"
    assert b"\x00\n" in data
    lines = [ln + b"\n" for ln in data.split(b"\n")[:-1]]
    parsed = [format_line(r) for r in map(parse_line, lines) if r]
    assert b"".join(parsed) == capture.read_bytes()
    assert sum(ln.startswith(b"data") for ln in lines) == len(parsed) + 1


def _checkpoint(tmp_path) -> str:
    X = np.random.RandomState(0).gamma(1.0, 100.0, (400, 12)).astype(np.float32)
    path = str(tmp_path / "ckpt")
    checkpoint.save_model(path, "forest", interop.forest_params_from_numpy(
        chip_smoke.random_forest(0, X, n_trees=8), device="cpu"),
        classes=chip_smoke.CLASSES)
    return path


def _end_state(summary) -> dict:
    eng = summary.engine
    eng.step()
    t = eng.table
    out = {"in_use": t.in_use.numpy(), "time_start": t.time_start.numpy(),
           "features": eng.features().numpy()}
    for d in ("fwd", "rev"):
        for f in ("pkts_lo", "bytes_lo", "last_time", "active"):
            out[f"{d}.{f}"] = getattr(getattr(t, d), f).numpy()
    return {"table": out, "meta": eng.slot_metadata(),
            "flows": eng.num_flows(), "dropped": eng.dropped}


def _assert_same_end(a: dict, b: dict) -> None:
    for k, v in a["table"].items():
        np.testing.assert_array_equal(v, b["table"][k], err_msg=k)
    assert (a["meta"], a["flows"], a["dropped"]) == (
        b["meta"], b["flows"], b["dropped"])


@pytest.mark.parametrize("native", ["on", "off"])
@pytest.mark.parametrize("restart", [False, True])
def test_ryu_serve_ends_where_the_replay_serve_ends(tmp_path, capture,
                                                    capsys, native, restart):
    """``--source ryu``, with native ingest on (raw pipe bytes) and off
    (parsed records), and with one dead-monitor restart under the default
    ``--monitor-restarts 5``: the table and slot metadata after the stream
    equal a replay serve's of the same lines."""
    ckpt = _checkpoint(tmp_path)
    common = ["Randomforest", "--native-checkpoint", ckpt, "--device", "cpu",
              "--capacity", str(N_FLOWS), "--print-every", "1",
              "--idle-timeout", "0", "--native-ingest", native,
              "--pipeline", "off", "--degrade", "off"]
    ref = cli.main(common + ["--source", "replay", "--capture", str(capture)])
    capsys.readouterr()
    cmd = _emitter_cmd(capture, pause=0.05, marker=tmp_path / "died",
                       die=2 if restart else -1)
    got = cli.main(common + ["--source", "ryu", "--monitor-cmd", cmd])
    out = capsys.readouterr()
    assert got.engine.native == (native == "on")
    assert got.ticks >= 1 and out.out.count("Flow ID") == len(got.render_ticks)
    _assert_same_end(_end_state(got), _end_state(ref))
    assert got.engine.num_flows() == N_FLOWS
    if restart and native == "on":
        # the dead monitor's half line, ended by the restart seam: counted
        # in the native_parse_errors gauge, as the JAX serve counts it,
        # with no stderr line (the JAX serve prints none)
        assert got.engine.parse_errors() == 1
        assert global_metrics.gauges["native_parse_errors"] == 1
        assert "malformed" not in out.err


def test_ryu_serve_without_supervision_ends_with_the_monitor(tmp_path,
                                                             capture, capsys):
    """``--monitor-restarts 0``: the monitor's death ends the serve, after
    what it printed."""
    ckpt = _checkpoint(tmp_path)
    common = ["Randomforest", "--native-checkpoint", ckpt, "--device", "cpu",
              "--capacity", str(N_FLOWS), "--print-every", "1",
              "--idle-timeout", "0", "--pipeline", "off", "--degrade", "off"]
    head = tmp_path / "head.capture"
    lines = capture.read_bytes().splitlines(True)
    head.write_bytes(b"".join(ln for ln in lines if ln.split(b"\t")[1] in
                              (b"1", b"2")))
    ref = cli.main(common + ["--source", "replay", "--capture", str(head)])
    got = cli.main(common + [
        "--source", "ryu", "--monitor-restarts", "0", "--monitor-cmd",
        _emitter_cmd(capture, marker=tmp_path / "died", die=2)])
    capsys.readouterr()
    _assert_same_end(_end_state(got), _end_state(ref))
