"""The port CLI's metrics and observability plane against the JAX CLI's.

- Over one capture with ``--pipeline off``, the ``--metrics-every``
  report of the port names what the JAX report names — counters, gauges
  and histograms — but for the JAX device-runtime telemetry
  (``DEVICE_TELEMETRY``: XLA's compile counters have no eager torch
  counterpart, and a CPU serve reads no device memory), and the
  deterministic counters
  (``ticks``, ``records``, ``flows_dropped``, ``evicted``,
  ``predict_rows_saved``, ``degrade_transitions``, ``checkpoint_saves``,
  ``source_*``, ``knn_candidates_*``) are equal value for value; the
  report keeps JAX's layout, line for line.
- The obs plane is byte-transparent: stdout is identical with every obs
  surface on and with all of them off, serial and pipelined.
- The live surfaces of a serve: ``/metrics`` with the per-stage series,
  ``/healthz`` with the ladder, label-cache and latency blocks (and the
  rung during a drill) and the ``device`` block, ``/events``; the
  flight-recorder and device-plane dumps on SIGTERM, SIGUSR1 and a clean
  exit; the flag rules and when the device plane arms.
"""

import json
import os
import re
import signal
import threading
import time
import urllib.error
import urllib.request

import pytest

from test_torch_incremental import N_FLOWS, _capture_and_sample, _checkpoints
from traffic_classifier_sdn_tpu import cli as jcli
from traffic_classifier_sdn_tpu.utils import faults as jfaults
from traffic_classifier_sdn_tpu.utils import metrics as jmetrics
from traffic_classifier_sdn_tpu_torch import cli as tcli
from traffic_classifier_sdn_tpu_torch.native import knn as native_knn
from traffic_classifier_sdn_tpu_torch.utils import faults as tfaults
from traffic_classifier_sdn_tpu_torch.utils import metrics as tmetrics

# The JAX device-runtime plane's series (obs/device.py, obs/perf_recorder.py).
# Both CLIs arm it with any obs surface on; the port's CPU serve reports
# none of them within the run (no compile bus, no device memory, the ring
# commits its one partial segment at exit).
DEVICE_TELEMETRY = {
    "jit_compiles", "jit_compile_s", "retraces_after_warmup",
    "compilation_cache_hits", "compilation_cache_misses",
    "device_memory_bytes", "device_memory_peak_bytes",
    "perf_ring_segments", "perf_ring_dropped_segments",
    "profiler_captures", "profiler_capture_failures",
}
DEVICE_PREFIXES = ("donation_expected_", "donation_reused_")
DETERMINISTIC = ("ticks", "records", "flows_dropped", "evicted",
                 "predict_rows_saved", "degrade_transitions",
                 "checkpoint_saves", "source_evictions", "source_deaths",
                 "knn_candidates_screened", "knn_candidates_abandoned",
                 "fanin_sources", "native_parse_errors", "dirty_rows",
                 "label_cache_invalidations", "probe_failures",
                 "degrade_state")


@pytest.fixture(autouse=True, scope="module")
def _default_serving_menus():
    with pytest.MonkeyPatch.context() as mp:
        for var in ("TCSDN_KNN_TOPK", "TCSDN_SVC_KERNEL",
                    "TCSDN_FOREST_KERNEL"):
            mp.delenv(var, raising=False)
        yield


@pytest.fixture
def served(tmp_path):
    capture, X = _capture_and_sample(tmp_path)
    return tmp_path, capture, X


def _run(capsys, main, argv, faults_mod=None, site=None):
    """(stdout, stderr, the registry's counters and gauges) of one serve,
    optionally under a ``degrade.dispatch_error`` plan in ``faults_mod``."""
    if site is None:
        main(argv)
    else:
        plan = faults_mod.FaultPlan([faults_mod.FaultRule(site, after=1)])
        with faults_mod.installed(plan):
            main(argv)
    out = capsys.readouterr()
    reg = (jmetrics if main is jcli.main else tmetrics).global_metrics
    return out.out, out.err, dict(reg.counters), dict(reg.gauges)


def _reports(err: str) -> list[list[tuple[str, str]]]:
    return [[tuple(kv.split("=", 1)) for kv in line.split()[1:]]
            for line in err.splitlines() if line.startswith("metrics ")]


def _names(report) -> set:
    """Metric names behind one report line (a histogram's four keys fold
    into its name)."""
    keys = {k for k, _ in report}
    names = set()
    for k in keys:
        base = re.sub(r"_(count|mean|p50|p99)$", "", k)
        if base != k and all(f"{base}_{s}" in keys
                             for s in ("count", "mean", "p50", "p99")):
            names.add(base)
        else:
            names.add(k)
    return names


def _device(name: str) -> bool:
    return name in DEVICE_TELEMETRY or name.startswith(DEVICE_PREFIXES)


SCENARIOS = {
    # eviction at --idle-timeout 2, snapshots every 2 ticks
    "plain": ("Randomforest", [], None),
    # an armed dispatch error: demotion, probes, re-promotion. No
    # real-time deadline: a device call or probe past it (a JAX compile
    # on a loaded host) demotes again, 3 more transitions on that side
    # only; the armed error alone drives the ladder, on both sides
    "drill": ("Randomforest", ["--probe-every", "0", "--probe-successes",
                               "2", "--device-deadline", "0"],
              "degrade.dispatch_error"),
    # every obs surface on: the JAX CLI arms its device plane too
    "obs": ("Randomforest", ["--obs-port", "0", "--obs-dir", "{tmp}/obs",
                             "--latency-slo", "0.000001"], None),
    # two lockstep synthetic sources through the fan-in tier
    "fanin": ("Randomforest", ["--sources", "2", "--source", "synthetic",
                               "--synthetic-flows", "24",
                               "--source-lockstep"], None),
    # the native KNN host search and its screening counters
    "knn-native": ("knearest", ["--knn-topk", "native"], None),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_metric_names_and_counters_equal_jax(served, capsys, monkeypatch,
                                             scenario):
    sub, extra, site = SCENARIOS[scenario]
    if scenario == "knn-native" and not native_knn.available():
        pytest.skip("g++ cannot build the native KNN")
    tmp, capture, X = served
    jdir, tdir = _checkpoints(tmp, sub, X)
    extra = [a.replace("{tmp}", str(tmp)) for a in extra]
    source = ([] if "--source" in extra
              else ["--source", "replay", "--capture", capture])
    common = [sub, *source, "--capacity", str(N_FLOWS), "--print-every",
              "1", "--idle-timeout", "2", "--table-rows", "16",
              "--pipeline", "off", "--metrics-every", "1", "--max-ticks",
              "6", "--serve-checkpoint-every", "2",
              "--serve-checkpoint-budget", "0", *extra]
    runs = {}
    for name, main, ckpt, fm, more in (
            ("jax", jcli.main, jdir, jfaults, []),
            ("port", tcli.main, tdir, tfaults, ["--device", "cpu"])):
        argv = common + ["--native-checkpoint", ckpt,
                         "--serve-checkpoint-dir", str(tmp / f"rot-{name}"),
                         *more]
        if scenario == "knn-native":
            monkeypatch.delenv("TCSDN_KNN_TOPK", raising=False)
        runs[name] = _run(capsys, main, argv, fm, site)
    (jout, jerr, jc, jg), (tout, terr, tc, tg) = runs["jax"], runs["port"]
    assert tout == jout
    jrep, trep = _reports(jerr), _reports(terr)
    assert len(trep) == len(jrep) == 6
    jnames, tnames = _names(jrep[-1]), _names(trep[-1])
    assert tnames == {n for n in jnames if not _device(n)}
    assert not {n for n in tnames if _device(n)}
    if scenario == "obs":
        assert {n for n in jnames if _device(n)}  # the listed ones appear
    for key in DETERMINISTIC:
        want = jc.get(key, jg.get(key))
        assert tc.get(key, tg.get(key)) == want, key
    assert tc["checkpoint_saves"] == 3 and tc["ticks"] == 6
    if scenario == "drill":
        assert tc["degrade_transitions"] >= 3
    if scenario == "fanin":
        assert tg["source_1_state"] == 0 and tg["fanin_sources"] == 2
    if scenario == "knn-native":
        assert tc["knn_candidates_screened"] > 0


def test_metrics_every_report_keeps_jax_layout(served, capsys):
    """Each ``--metrics-every`` line: ``metrics`` and then ``key=value``
    tokens in sorted key order, one line every N ticks, the key lists
    equal to JAX's line for line (timings differ in value only)."""
    tmp, capture, X = served
    jdir, tdir = _checkpoints(tmp, "Randomforest", X)
    common = ["Randomforest", "--source", "replay", "--capture", capture,
              "--capacity", str(N_FLOWS), "--print-every", "2",
              "--pipeline", "off", "--metrics-every", "3"]
    _, jerr, _, _ = _run(capsys, jcli.main,
                         common + ["--native-checkpoint", jdir])
    _, terr, _, _ = _run(capsys, tcli.main,
                         common + ["--native-checkpoint", tdir,
                                   "--device", "cpu"])
    jrep, trep = _reports(jerr), _reports(terr)
    assert len(trep) == len(jrep) == 2
    for j, t in zip(jrep, trep):
        assert [k for k, _ in t] == [k for k, _ in j]
        assert [k for k, _ in t] == sorted(k for k, _ in t)
    int_keys = [k for k, v in trep[-1] if k.endswith("_count")]
    assert int_keys and all(re.fullmatch(r"\d+", dict(trep[-1])[k])
                            for k in int_keys)


@pytest.mark.parametrize("pipeline", ["off", "auto"])
def test_stdout_identical_with_the_obs_plane_on_and_off(served, capsys,
                                                        monkeypatch,
                                                        pipeline):
    """Every obs surface and snapshots on, against latency provenance off
    and no surface: the same bytes on stdout (pipelined with a handoff
    deeper than the renders, so nothing coalesces)."""
    monkeypatch.setattr(tcli, "PIPELINE_DEPTH", 64)
    tmp, capture, X = served
    _, tdir = _checkpoints(tmp, "Randomforest", X)
    common = ["Randomforest", "--source", "replay", "--capture", capture,
              "--capacity", str(N_FLOWS), "--print-every", "1",
              "--idle-timeout", "2", "--table-rows", "16",
              "--native-checkpoint", tdir, "--device", "cpu",
              "--pipeline", pipeline]
    on, err_on, _, _ = _run(capsys, tcli.main, common + [
        "--metrics-every", "1", "--obs-port", "0", "--obs-dir",
        str(tmp / "obs"), "--obs-dump-on-exit", "--latency-provenance", "on",
        "--latency-slo", "0.000001", "--serve-checkpoint-every", "1",
        "--serve-checkpoint-dir", str(tmp / "rot")])
    off, err_off, _, gauges = _run(capsys, tcli.main, common + [
        "--latency-provenance", "off"])
    assert on == off and on.count("Flow ID") == 6
    assert "metrics " in err_on and "flight recorder dumped" in err_on
    assert "metrics " not in err_off and "obs_port" not in gauges


def _obs_port() -> int:
    return int(tmetrics.global_metrics.gauges.get("obs_port", 0))


def _scraper(got: dict, until, stop: threading.Event):
    """Scrape /metrics, /healthz and /events once ``until(got)`` is True
    of the registry; re-read the port on every try (a prior run's gauge
    lives until cli.main resets the registry)."""
    def run():
        deadline = time.time() + 60
        while time.time() < deadline and not stop.is_set():
            port = _obs_port()
            if not port or not until():
                time.sleep(0.005)
                continue
            base = f"http://127.0.0.1:{port}"
            try:
                got["metrics"] = urllib.request.urlopen(
                    base + "/metrics", timeout=5).read().decode()
                got["healthz"] = json.loads(urllib.request.urlopen(
                    base + "/healthz", timeout=5).read())
                got["events"] = json.loads(urllib.request.urlopen(
                    base + "/events?n=50", timeout=5).read())
                got["port"] = port
                return
            except (urllib.error.URLError, OSError):
                time.sleep(0.005)
    return threading.Thread(target=run)


def test_cli_serve_exposes_obs_plane_during_replay(served, capsys):
    """``--obs-port 0 --metrics-every`` on the no-flag serve: /metrics
    carries the per-stage series of both pipeline stages, /healthz the
    ladder, label-cache and latency blocks and its own port, /events the
    ring; ``--obs-dump-on-exit`` leaves the on-demand post-mortem."""
    tmp, capture, X = served
    _, tdir = _checkpoints(tmp, "Randomforest", X)
    got, stop = {}, threading.Event()
    m = tmetrics.global_metrics
    t = _scraper(got, lambda: "stage_render_s" in m.histograms
                 and m.counters.get("ticks", 0) >= 3, stop)
    m.reset()  # no earlier serve's port or series
    t.start()
    try:
        tcli.main(["Randomforest", "--source", "synthetic",
                   "--synthetic-flows", "48", "--capacity", "48",
                   "--print-every", "1", "--max-ticks", "400",
                   "--metrics-every", "100", "--native-checkpoint", tdir,
                   "--device", "cpu", "--obs-port", "0", "--obs-dir",
                   str(tmp / "obs"), "--obs-dump-on-exit"])
    finally:
        stop.set()
        t.join(timeout=30)
    err = capsys.readouterr().err
    assert "observability plane on port" in err
    assert "(/metrics /healthz /events /profile)" in err
    assert "device telemetry dumped to" in err
    text = got["metrics"]
    for stage in ("poll", "parse", "scatter", "tick", "host", "dispatch",
                  "device", "predict", "render", "compact"):
        assert f"# TYPE tcsdn_stage_{stage}_s summary" in text, stage
    for name in ("ticks", "records"):  # every conversation reports
        assert f"# TYPE tcsdn_{name} counter" in text, name
    for name in ("flows_dropped", "native_parse_errors", "degrade_state",
                 "dirty_rows", "obs_port", "queue_depth"):
        assert f"# TYPE tcsdn_{name} gauge" in text, name
    assert "tcsdn_e2e_emit_to_render_s_count" in text
    health = got["healthz"]
    assert health["healthy"] is True and health["obs_port"] == got["port"]
    assert health["degrade"]["state"] == "HEALTHY"
    assert health["label_cache"]["mode"] == "host"
    assert health["latency"]["observed"] is True
    assert {e["kind"] for e in got["events"]} >= {"span"}
    assert health["device"]["platform"] == "cpu"
    assert health["device"]["armed"] is True
    dumps = sorted(os.listdir(tmp / "obs"))
    flight = [n for n in dumps if n.startswith("flightrec-")]
    device = [n for n in dumps if n.startswith("device-")]
    assert len(flight) == len(device) == 1
    assert "on-demand" in flight[0] and "on-demand" in device[0]
    assert set(dumps) == {*flight, *device, "perf"}


@pytest.mark.chaos
def test_sigterm_and_sigusr1_dump_the_flight_recorder(served, capsys):
    """SIGUSR1 mid-serve dumps the ring and a metrics snapshot and the
    serve goes on; SIGTERM then ends it with exit status 143, a dump whose
    last event is ``signal.sigterm``, and ``--save-serve-state`` written
    on the way out."""
    tmp, capture, X = served
    _, tdir = _checkpoints(tmp, "Randomforest", X)
    obs_dir = tmp / "obs"
    state = tmp / "state.npz"
    m = tmetrics.global_metrics

    def kick():
        deadline = time.time() + 60
        while m.counters.get("ticks", 0) < 3 and time.time() < deadline:
            time.sleep(0.005)
        signal.raise_signal(signal.SIGUSR1)
        while time.time() < deadline and not (
                obs_dir.exists() and any(f.startswith("metrics-")
                                         for f in os.listdir(obs_dir))):
            time.sleep(0.005)
        signal.raise_signal(signal.SIGTERM)

    kicker = threading.Thread(target=kick)
    handler = signal.getsignal(signal.SIGTERM)
    m.reset()
    kicker.start()
    try:
        with pytest.raises(SystemExit) as ended:
            tcli.main(["Randomforest", "--source", "synthetic",
                       "--synthetic-flows", "48", "--capacity", "48",
                       "--print-every", "1", "--native-checkpoint", tdir,
                       "--device", "cpu", "--obs-dir", str(obs_dir),
                       "--save-serve-state", str(state)])
    finally:
        kicker.join(timeout=60)
    err = capsys.readouterr().err
    assert ended.value.code == 143
    names = sorted(os.listdir(obs_dir))
    usr1 = [n for n in names if n.startswith("flightrec") and "sigusr1" in n]
    snap = [n for n in names if n.startswith("metrics-") and "sigusr1" in n]
    term = [n for n in names if n.startswith("flightrec") and "sigterm" in n]
    assert len(usr1) == len(snap) == len(term) == 1, names
    lines = [json.loads(ln) for ln in open(obs_dir / term[0])]
    assert lines[0] == {**lines[0], "kind": "meta", "reason": "sigterm"}
    assert lines[-1]["kind"] == "signal.sigterm"
    assert any(e["kind"] == "signal.sigusr1" for e in lines)
    assert json.load(open(obs_dir / snap[0]))["snapshot"]["ticks"] >= 3
    assert "saved serving state (48 tracked flows)" in err
    assert state.exists()
    # the handler is back as it was
    assert signal.getsignal(signal.SIGTERM) is handler


def test_healthz_shows_the_rung_and_the_dump_holds_the_transitions(
        served, capsys):
    """A dispatch-error drill that stays demoted (every device call fails
    from the second on, no probe due): /healthz answers 200 with the
    DEGRADED rung and its host fallback, and the on-exit dump holds the
    ladder's transition."""
    tmp, capture, X = served
    _, tdir = _checkpoints(tmp, "Randomforest", X)
    got, stop = {}, threading.Event()
    m = tmetrics.global_metrics
    t = _scraper(got, lambda: m.gauges.get("degrade_state", 0) != 0
                 and m.counters.get("ticks", 0) >= 4, stop)
    plan = tfaults.FaultPlan([tfaults.FaultRule(
        "degrade.dispatch_error", after=1, times=None)])
    m.reset()  # no earlier serve's port or series
    t.start()
    try:
        with tfaults.installed(plan):
            summary = tcli.main([
                "Randomforest", "--source", "synthetic",
                "--synthetic-flows", "48", "--capacity", "48",
                "--print-every", "1", "--max-ticks", "300",
                "--probe-every", "600", "--native-checkpoint", tdir,
                "--device", "cpu", "--obs-port", "0",
                "--obs-dir", str(tmp / "obs"), "--obs-dump-on-exit"])
    finally:
        stop.set()
        t.join(timeout=30)
    capsys.readouterr()
    health = got["healthz"]
    assert health["healthy"] is True and health["degraded"] is True
    assert health["degrade"]["state"] == "DEGRADED"
    assert health["degrade"]["rung"] == "DEGRADED"
    assert health["degrade"]["fallback"] == summary.degrade["fallback"]
    assert "tcsdn_degrade_transitions 1" in got["metrics"]
    (dump,) = [n for n in os.listdir(tmp / "obs") if n.startswith("flightrec-")]
    lines = [json.loads(ln) for ln in open(tmp / "obs" / dump)]
    edges = [(e["frm"], e["to"]) for e in lines
             if e["kind"] == "degrade.transition"]
    assert edges == [("HEALTHY", "DEGRADED")]
    assert any(e["kind"] == "fault.fire" for e in lines)


def test_flag_rules_and_the_device_obs_note(served, capsys):
    tmp, capture, X = served
    _, tdir = _checkpoints(tmp, "Randomforest", X)
    common = ["Randomforest", "--source", "replay", "--capture", capture,
              "--capacity", str(N_FLOWS), "--native-checkpoint", tdir,
              "--device", "cpu", "--max-ticks", "2"]
    with pytest.raises(SystemExit, match="needs --serve-checkpoint-dir"):
        tcli.main(common + ["--serve-checkpoint-every", "2"])
    with pytest.raises(SystemExit, match="needs --obs-dir"):
        tcli.main(common + ["--obs-dump-on-exit"])
    # no obs surface: the device plane stays off, the ring unwritten
    tcli.main(common + ["--perf-ring-ticks", "8"])
    assert "device-runtime" not in capsys.readouterr().err
    assert not (tmp / "obs").exists()
    # --obs-dir arms it (no note any more): the ring commits its two ticks
    tcli.main(common + ["--obs-dir", str(tmp / "obs")])
    assert "device-runtime" not in capsys.readouterr().err
    assert len(os.listdir(tmp / "obs" / "perf")) == 1
    tcli.main(common + ["--obs-dir", str(tmp / "off"), "--device-obs",
                        "off"])
    assert "device-runtime" not in capsys.readouterr().err
    assert not (tmp / "off").exists()
