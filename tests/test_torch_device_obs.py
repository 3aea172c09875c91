"""The port's device-runtime plane (``obs/device.py``,
``obs/perf_recorder.py``, ``utils/profiling.py``) against the JAX
package's.

- The perf ring's on-disk format is JAX's: the same sample committed by
  each package gives the same bytes, and each package's ``replay()``
  reads the other's segments.
- The ring survives kill -9 mid-rotation (JAX's case, through the port's
  recorder), and a CLI serve's ring reconciles with its latency plane
  (the ring's stage_tick_s p50 within 10 % of the histogram's: JAX's
  bound, both are fed by the same spans).
- ``DeviceTelemetry`` on the CPU: JAX's ``status()`` and ``sample()``
  keys, memory readings None (as JAX's CPU backend), the absent compile
  telemetry stated, the donation ledger.
- ``ProfilerCapture``: a Chrome trace, 409 while busy, 500 and
  ``profiler_capture_failures`` on ``obs.profiler``; ``--profile-dir``
  writes a trace of a whole serve; the CLI's ``/profile`` and the
  ``device`` block of ``/healthz``.
- ``--device-obs auto`` is byte-transparent: stdout equals ``off``'s, and
  the serial one equals the JAX serial serve's.

Tolerances: the 10 % ring-vs-plane bound above; everything else exact.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from traffic_classifier_sdn_tpu import cli as jcli
from traffic_classifier_sdn_tpu.io import checkpoint as jck
from traffic_classifier_sdn_tpu.models import gnb as jgnb
from traffic_classifier_sdn_tpu.obs import DeviceTelemetry as JDeviceTelemetry
from traffic_classifier_sdn_tpu.obs import perf_recorder as jperf
from traffic_classifier_sdn_tpu_torch import cli as tcli
from traffic_classifier_sdn_tpu_torch import interop
from traffic_classifier_sdn_tpu_torch.ingest.protocol import format_line
from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows
from traffic_classifier_sdn_tpu_torch.io import checkpoint as tck
from traffic_classifier_sdn_tpu_torch.obs import (
    DeviceTelemetry,
    ExpositionServer,
    FlightRecorder,
    ProfilerBusy,
    ProfilerCapture,
)
from traffic_classifier_sdn_tpu_torch.obs import perf_recorder as tperf
from traffic_classifier_sdn_tpu_torch.utils import faults, profiling
from traffic_classifier_sdn_tpu_torch.utils.metrics import Metrics, global_metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# the perf ring's shared format
# ---------------------------------------------------------------------------


def _samples():
    """Per-tick samples as each package's serve builds them: Python floats
    from torch readings, numpy scalars, ints, strings, None and nested
    values."""
    import torch

    return [
        {"tick": 1, "stage_tick_s": float(torch.tensor(0.1234567).item()),
         "queue_depth": 2.0, "degrade_state": "HEALTHY", "hbm_bytes": 123456},
        {"tick": 2, "stage_tick_s": np.float64(0.25), "dirty_rows": 7.0,
         "drift_state": None, "nested": {"a": [1, 2.5, "x"]}},
        {"tick": 3, "odd": np.float32(0.5), "big": 2**40,
         "flag": True, "pair": (1, 2)},
    ]


@pytest.mark.parametrize("per_segment", [1, 2, 4])
def test_perf_ring_bytes_equal_jax_and_replay_crosses(tmp_path, per_segment):
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    t = tperf.PerfRecorder(str(tdir), ticks_per_segment=per_segment,
                           clock=lambda: 1700000000.5)
    j = jperf.PerfRecorder(str(jdir), ticks_per_segment=per_segment,
                           clock=lambda: 1700000000.5)
    for s in _samples():
        t.record(dict(s))
        j.record(dict(s))
    t.flush()
    j.flush()
    tsegs, jsegs = tperf.segment_files(str(tdir)), jperf.segment_files(str(jdir))
    assert [q for q, _ in tsegs] == [q for q, _ in jsegs]
    for (_, a), (_, b) in zip(tsegs, jsegs):
        assert open(a, "rb").read() == open(b, "rb").read()
    assert jperf.replay(str(tdir)) == tperf.replay(str(tdir))
    assert tperf.replay(str(jdir)) == jperf.replay(str(jdir))
    assert [s["tick"] for s in tperf.replay(str(jdir))] == [1, 2, 3]
    assert t.status() == dict(j.status(), directory=t.directory)
    assert t.tail(2) == j.tail(2)


def test_perf_ring_survives_kill_nine_mid_rotation(tmp_path):
    """SIGKILL mid-rotation loses at most the uncommitted buffer: every
    committed segment replays under both packages' strict readers, seqs
    stay monotonic, and a restarted recorder sweeps stale tmps and resumes
    numbering above the survivors."""
    ring = tmp_path / "perf"
    child = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from traffic_classifier_sdn_tpu_torch.obs.perf_recorder import "
        "PerfRecorder\n"
        f"rec = PerfRecorder({str(ring)!r}, ticks_per_segment=4, "
        "keep_segments=64)\n"
        "i = 0\n"
        "while True:\n"
        "    rec.record({'tick': i})\n"
        "    i += 1\n"
    )
    proc = subprocess.Popen([sys.executable, "-c", child],
                            stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 60.0
        while time.time() < deadline:
            if proc.poll() is not None:
                raise AssertionError("child died on its own: "
                                     + proc.stderr.read().decode())
            if len(tperf.segment_files(str(ring))) >= 3:
                break
            time.sleep(0.02)
        else:
            raise AssertionError("child never committed 3 segments")
    finally:
        proc.kill()
        proc.wait()
    seqs = [seq for seq, _ in tperf.segment_files(str(ring))]
    assert len(seqs) >= 3 and seqs == sorted(seqs)
    samples = tperf.replay(str(ring))
    assert samples == jperf.replay(str(ring))
    ticks = [s["tick"] for s in samples]
    assert ticks == sorted(ticks) and len(ticks) == 4 * len(seqs)
    stale = ring / ".perf-99999999.jsonl.tmp.123"
    stale.write_bytes(b"torn garbage")
    rec2 = tperf.PerfRecorder(str(ring), ticks_per_segment=4,
                              keep_segments=64)
    assert not stale.exists()
    for i in range(4):
        rec2.record({"tick": 10_000 + i})
    assert tperf.segment_files(str(ring))[-1][0] > seqs[-1]
    assert jperf.replay(str(ring))[-1]["tick"] == 10_003


# ---------------------------------------------------------------------------
# CLI harness
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def capture_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("dev_cap") / "capture.tsv"
    syn = SyntheticFlows(n_flows=12, seed=11)
    with open(path, "wb") as f:
        for _ in range(12):
            for r in syn.tick():
                f.write(format_line(r))
    return str(path)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    rng = np.random.RandomState(0)
    d = {"theta": rng.gamma(2.0, 100.0, (4, 12)),
         "var": rng.gamma(2.0, 50.0, (4, 12)) + 1.0,
         "class_prior": np.full(4, 0.25)}
    root = tmp_path_factory.mktemp("dev_model")
    names = ["dns", "ping", "telnet", "voice"]
    jck.save_model(str(root / "jax"), "gnb", jgnb.from_numpy(d), names)
    tck.save_model(str(root / "port"), "gnb",
                   interop.gnb_params_from_numpy(d, device="cpu"),
                   classes=tuple(names))
    return str(root / "jax"), str(root / "port")


def _serve(main, capture_file, ckpt, *extra):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        summary = main([
            "gaussiannb", "--source", "replay", "--capture", capture_file,
            "--native-checkpoint", ckpt, "--capacity", "64",
            "--print-every", "3", "--max-ticks", "12", *extra,
        ])
    return out.getvalue(), err.getvalue(), summary


def test_perf_ring_last_segment_reconciles_with_latency_plane(
        capture_file, checkpoints, tmp_path):
    obs = tmp_path / "obs"
    _serve(tcli.main, capture_file, checkpoints[1], "--device", "cpu",
           "--warmup", "--obs-dir", str(obs), "--perf-ring-ticks", "4")
    samples = [s for s in tperf.replay(str(obs / "perf"))
               if "stage_tick_s" in s]
    assert len(samples) == 12  # one per tick, every segment committed
    assert samples == [s for s in jperf.replay(str(obs / "perf"))
                       if "stage_tick_s" in s]
    # the plane's p50 is the nearest rank of its samples (utils/metrics),
    # the ring's samples are the same ticks rounded to the microsecond: the
    # same rank of the ring equals it. (np.median averages the 6th and 7th
    # of 12 ticks, which a loaded host pulls more than 10 % apart.)
    ticks = sorted(s["stage_tick_s"] for s in samples)
    ring_p50 = ticks[int(round(0.5 * (len(ticks) - 1)))]
    plane_p50 = global_metrics.snapshot()["stage_tick_s_p50"]
    assert ring_p50 > 0 and plane_p50 > 0
    assert ring_p50 == round(plane_p50, 6)
    # the keys JAX's serve writes, the compile counters at 0
    assert samples[-1]["jit_compiles"] == 0
    assert samples[-1]["retraces_after_warmup"] == 0
    assert "hbm_bytes" not in samples[-1]  # None on the CPU: left out
    assert int(global_metrics.counters["perf_ring_segments"]) == 3


@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_render_byte_identical_device_obs_on_vs_off(
        capture_file, checkpoints, tmp_path, pipeline):
    """The device plane observes, never perturbs: stdout with
    ``--device-obs auto`` equals ``off``'s, and the serial one is the JAX
    serial serve's."""
    on, _, _ = _serve(tcli.main, capture_file, checkpoints[1], "--device",
                      "cpu", "--pipeline", pipeline, "--obs-dir",
                      str(tmp_path / "on"), "--device-obs", "auto")
    off, _, _ = _serve(tcli.main, capture_file, checkpoints[1], "--device",
                       "cpu", "--pipeline", pipeline, "--obs-dir",
                       str(tmp_path / "off"), "--device-obs", "off")
    assert on == off
    assert on.count("+") > 0
    assert os.path.isdir(tmp_path / "on" / "perf")
    assert not os.path.exists(tmp_path / "off" / "perf")
    if pipeline == "off":
        want, _, _ = _serve(jcli.main, capture_file, checkpoints[0],
                            "--pipeline", "off", "--obs-dir",
                            str(tmp_path / "jax"))
        assert on == want


def test_dump_on_exit_freezes_the_device_block_and_the_ring_tail(
        capture_file, checkpoints, tmp_path):
    obs = tmp_path / "obs"
    _, err, _ = _serve(tcli.main, capture_file, checkpoints[1], "--device",
                       "cpu", "--obs-dir", str(obs), "--obs-dump-on-exit",
                       "--perf-ring-ticks", "5")
    assert "device telemetry dumped to" in err
    [name] = [n for n in os.listdir(obs) if n.startswith("device-")]
    bundle = json.load(open(obs / name))
    assert bundle["reason"] == "on-demand"
    assert bundle["device"]["platform"] == "cpu"
    assert bundle["device"]["compile_telemetry"] == "absent (eager torch)"
    assert [s["tick"] for s in bundle["perf_tail"]] == list(range(1, 13))
    assert bundle["perf"]["segments_committed"] == 3


# ---------------------------------------------------------------------------
# DeviceTelemetry
# ---------------------------------------------------------------------------


def test_device_telemetry_keeps_jax_keys_on_the_cpu():
    m, rec = Metrics(), FlightRecorder()
    with DeviceTelemetry(metrics=m, recorder=rec, device="cpu") as dev:
        jdev = JDeviceTelemetry()
        st, jst = dev.status(), jdev.status()
        assert set(jst) <= set(st)
        sample = dev.sample()
        assert set(sample) == {"jit_compiles", "retraces_after_warmup",
                               "hbm_bytes"}
        assert sample == {"jit_compiles": 0, "retraces_after_warmup": 0,
                          "hbm_bytes": None}
        dev.mark_warmup_complete()
        dev.mark_dispatch()
        dev.note_donation("wire", True)
        dev.note_donation("wire", False)
        st = dev.status()
        assert st["armed"] and st["warmup_complete"]
        assert st["backend"] == "cpu" and st["platform"] == "cpu"
        assert st["compile_telemetry"] == "absent (eager torch)"
        assert st["device_memory_bytes"] is None and st["hbm_bytes"] is None
        assert st["jit_compiles"] == 0 and st["retraces_after_warmup"] == 0
        assert st["donation"] == {"wire": {"expected": 2, "reused": 1}}
        assert "donate no buffers" in st["donation_note"]
        assert st["last_dispatch_age_s"] >= 0
        json.dumps(st)
    assert not dev.status()["armed"]
    assert "device_memory_bytes" not in m.gauges  # no reading on the CPU
    assert m.counters["donation_expected_wire"] == 2
    assert [e["kind"] for e in rec.tail(10)] == ["device.warmup_complete"]


# ---------------------------------------------------------------------------
# ProfilerCapture and --profile-dir
# ---------------------------------------------------------------------------


def _get(url, timeout=30.0):
    return urllib.request.urlopen(url, timeout=timeout)


def test_profiler_capture_writes_a_trace_and_guards_concurrency(tmp_path):
    m = Metrics()
    prof = ProfilerCapture(str(tmp_path / "profile"), metrics=m, device="cpu")
    with pytest.raises(ValueError):
        prof.capture(0)
    with pytest.raises(ValueError):
        prof.capture(ProfilerCapture.MAX_SECONDS + 1)
    srv = ExpositionServer(m, port=0, host="127.0.0.1", profiler=prof)
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        result = {}

        def first():
            result["out"] = json.loads(_get(base + "/profile?seconds=1").read())

        t = threading.Thread(target=first)
        t.start()
        deadline = time.monotonic() + 10.0
        while not prof.status()["active"] and time.monotonic() < deadline:
            time.sleep(0.005)
        with pytest.raises(urllib.error.HTTPError) as busy:
            _get(base + "/profile?seconds=1")
        assert busy.value.code == 409
        with pytest.raises(ProfilerBusy):
            prof.capture(0.1)
        t.join(timeout=60.0)
        assert not t.is_alive()
        out = result["out"]
        assert out["seconds"] == 1.0
        trace = json.load(open(out["trace"]))
        assert "traceEvents" in trace
        with pytest.raises(urllib.error.HTTPError) as bad:
            _get(base + "/profile?seconds=x")
        assert bad.value.code == 400
    finally:
        srv.stop()
    st = prof.status()
    assert st == {"directory": prof.directory, "active": False,
                  "tracing": False, "captures": 1, "failures": 0}
    assert int(m.counters["profiler_captures"]) == 1


@pytest.mark.chaos
def test_profiler_fault_500s_counts_and_next_capture_succeeds(tmp_path):
    m = Metrics()
    prof = ProfilerCapture(str(tmp_path / "profile"), metrics=m, device="cpu")
    srv = ExpositionServer(m, port=0, host="127.0.0.1", profiler=prof)
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    plan = faults.FaultPlan([faults.FaultRule("obs.profiler", times=1)], 0)
    try:
        with faults.installed(plan):
            with pytest.raises(urllib.error.HTTPError) as e500:
                _get(base + "/profile?seconds=0.05")
            assert e500.value.code == 500
            assert plan.fires == [("obs.profiler", 1)]
            assert int(m.counters["profiler_capture_failures"]) == 1
            out = json.loads(_get(base + "/profile?seconds=0.05").read())
            assert out["seconds"] == 0.05 and os.path.exists(out["trace"])
    finally:
        srv.stop()
    st = prof.status()
    assert st["failures"] == 1 and st["captures"] == 1 and not st["active"]


def test_a_failing_capture_tears_the_profiler_down(tmp_path, monkeypatch):
    """An error inside the capture window (here the sleep) leaves no
    profiler running: the next capture starts one and succeeds."""
    prof = ProfilerCapture(str(tmp_path / "profile"), device="cpu")
    real_sleep = time.sleep
    calls = []

    def boom(s):
        calls.append(s)
        if len(calls) == 1:
            raise OSError("interrupted")
        real_sleep(s)

    monkeypatch.setattr(time, "sleep", boom)
    with pytest.raises(OSError):
        prof.capture(0.05)
    out = prof.capture(0.05)
    assert os.path.exists(out["trace"])
    assert prof.status()["failures"] == 1


def _annotations(path: str) -> set:
    """The ``record_function`` labels a Chrome trace holds."""
    events = json.load(open(path))["traceEvents"]
    return {e.get("name") for e in events if e.get("cat") == "user_annotation"}


def test_captures_repeat_each_with_its_own_window(tmp_path, monkeypatch):
    """Three captures in a row on one ``ProfilerCapture``: each trace names
    the label run inside its own window and none of the others', and no
    profiler is left enabled after any of them."""
    import torch

    prof = ProfilerCapture(str(tmp_path / "profile"), device="cpu")
    real_sleep = time.sleep
    labels = [f"capture-window-{i}" for i in range(3)]
    window = []

    def labelled(s):
        # the capture's window (its thread is the one the CPU profiler
        # records)
        if s == 0.05:
            with torch.profiler.record_function(labels[len(window)]):
                torch.ones(4).add_(1)
            window.append(s)
        real_sleep(s)

    monkeypatch.setattr(time, "sleep", labelled)
    traces = []
    for _ in labels:
        traces.append(prof.capture(0.05)["trace"])
        assert not torch.autograd.profiler._is_profiler_enabled
    assert len(set(traces)) == 3
    for label, path in zip(labels, traces):
        assert _annotations(path) & set(labels) == {label}
    assert prof.status()["captures"] == 3 and prof.status()["failures"] == 0


def test_trace_twice_in_one_process_keeps_each_block(tmp_path):
    """``utils.profiling.trace`` used twice in one process: each trace holds
    its own block's label only and the profiler is off after each."""
    import torch

    paths = []
    for i in range(2):
        with profiling.trace(str(tmp_path), "cpu") as info:
            with torch.profiler.record_function(f"trace-block-{i}"):
                torch.ones(4).add_(1)
        assert not torch.autograd.profiler._is_profiler_enabled
        paths.append(info["path"])
    assert paths[0] != paths[1]
    assert [_annotations(p) & {"trace-block-0", "trace-block-1"}
            for p in paths] == [{"trace-block-0"}, {"trace-block-1"}]


def test_profile_dir_traces_a_whole_serve(capture_file, checkpoints, tmp_path):
    pdir = tmp_path / "prof"
    out, _, _ = _serve(tcli.main, capture_file, checkpoints[1], "--device",
                       "cpu", "--pipeline", "off", "--profile-dir", str(pdir))
    plain, _, _ = _serve(tcli.main, capture_file, checkpoints[1], "--device",
                         "cpu", "--pipeline", "off")
    assert out == plain
    [name] = os.listdir(pdir)
    events = json.load(open(pdir / name))["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_trace_writes_even_when_the_block_raises(tmp_path):
    with pytest.raises(RuntimeError):
        with profiling.trace(str(tmp_path), "cpu") as info:
            raise RuntimeError("serve died")
    assert os.path.exists(info["path"])
    with profiling.trace(None) as info:
        pass
    assert info == {}


def test_device_seconds_per_call_on_the_cpu():
    import torch

    x = torch.ones(64, 64)
    t = profiling.device_seconds_per_call(lambda a: a @ a, (x,), iters=4,
                                          repeats=3)
    assert 0 < t < 1.0


def test_cli_profile_endpoint_and_device_block(capture_file, checkpoints,
                                               tmp_path):
    """A CPU serve with ``--obs-port 0 --obs-dir``: the startup line names
    /profile, ``/profile?seconds=0.2`` answers 200 with a trace, and
    /healthz carries the ``device`` block."""
    from traffic_classifier_sdn_tpu_torch.ingest import replay

    got = {}
    ticks = replay.iter_capture

    def slow(path):
        for i, batch in enumerate(ticks(path)):
            if i == 3:
                port = int(global_metrics.gauges["obs_port"])
                base = f"http://127.0.0.1:{port}"
                got["profile"] = json.loads(
                    _get(base + "/profile?seconds=0.2").read())
                got["healthz"] = json.loads(_get(base + "/healthz").read())
            yield batch

    replay.iter_capture = slow
    try:
        _, err, _ = _serve(tcli.main, capture_file, checkpoints[1],
                           "--device", "cpu", "--pipeline", "off",
                           "--obs-port", "0", "--obs-dir",
                           str(tmp_path / "obs"))
    finally:
        replay.iter_capture = ticks
    assert "(/metrics /healthz /events /profile)" in err
    assert os.path.exists(got["profile"]["trace"])
    dev = got["healthz"]["device"]
    assert dev["platform"] == "cpu" and dev["armed"]
    assert dev["compile_telemetry"] == "absent (eager torch)"
    assert dev["last_dispatch_age_s"] is not None
