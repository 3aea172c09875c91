"""The port's observability plane (obs/, utils/metrics.py,
utils/atomicio.py, the fault observers) held against the JAX package's.

Each scripted scenario runs through both packages with an injected clock
and the results are compared whole:

- ``prometheus_text`` is byte-equal for the same ``Metrics`` content
  (counters, gauges, histograms past their window, odd names), and
  ``snapshot()``/``report()`` agree but for the uptime;
- ``HealthState.check`` returns equal dicts at every step of a beat,
  probe, checkpoint and status-block script;
- ``FlightRecorder`` tails and dumps are equal, fault fires included;
- the ``Tracer`` gives the same span names, nesting, durations and
  error marks, and never swallows an exception;
- ``LatencyProvenance`` gives equal histograms, ``stage_increments()``,
  ``status()`` and recorder events through a fold, a coalesced render, a
  dropped source and an SLO breach.

Then the port alone, mirroring ``tests/test_obs.py``,
``tests/test_observability.py`` and ``tests/test_latency.py`` where they
do not need the device plane: thread-local span stacks, the bounded
thread-safe ring, the exposition endpoints on an ephemeral port (with
``/profile`` answering as the JAX server does with no profiler), and
``/metrics`` scraped again and again while a pipelined serve writes from
both of its stages.
"""

import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from traffic_classifier_sdn_tpu import obs as jobs
from traffic_classifier_sdn_tpu.cli import (
    _begin_tick_provenance as jbegin_tick_provenance,
)
from traffic_classifier_sdn_tpu.ingest.protocol import TelemetryRecord as JRecord
from traffic_classifier_sdn_tpu.obs import latency as jlatency
from traffic_classifier_sdn_tpu.utils import atomicio as jatomicio
from traffic_classifier_sdn_tpu.utils import faults as jfaults
from traffic_classifier_sdn_tpu.utils import metrics as jmetrics
from traffic_classifier_sdn_tpu_torch import cli as tcli
from traffic_classifier_sdn_tpu_torch import obs as tobs
from traffic_classifier_sdn_tpu_torch.ingest.batcher import batch_emit_ts
from traffic_classifier_sdn_tpu_torch.ingest.protocol import (
    TelemetryRecord,
    stamp_records,
)
from traffic_classifier_sdn_tpu_torch.obs import latency as tlatency
from traffic_classifier_sdn_tpu_torch.utils import atomicio as tatomicio
from traffic_classifier_sdn_tpu_torch.utils import faults as tfaults
from traffic_classifier_sdn_tpu_torch.utils import metrics as tmetrics
from traffic_classifier_sdn_tpu_torch.utils.metrics import global_metrics


class _Impl:
    def __init__(self, obs, latency, metrics, faults, atomicio):
        self.obs, self.latency, self.metrics = obs, latency, metrics
        self.faults, self.atomicio = faults, atomicio


IMPLS = {
    "jax": _Impl(jobs, jlatency, jmetrics, jfaults, jatomicio),
    "port": _Impl(tobs, tlatency, tmetrics, tfaults, tatomicio),
}


def _both(fn):
    """``fn(impl)`` through both packages; asserts the results are equal
    and returns the port's."""
    got = {name: fn(impl) for name, impl in IMPLS.items()}
    assert got["port"] == got["jax"]
    return got["port"]


# ---------------------------------------------------------------- metrics


def _fill(m):
    m.inc("records", 3)
    m.inc("records", 2.5)
    m.inc("weird.name-with chars")
    m.set("flows_dropped", 2)
    m.set("obs_port", 40123)
    m.set("negative", -0.125)
    for v in (0.25, 0.5, 1.0, 1e-7, 3.0):
        m.observe("stage_predict_s", v)
    for i in range(1500):  # past the 1024-sample window: the ring wraps
        m.observe("stage_tick_s", (i * 7919 % 1500) / 997.0)
    m.observe("empty_after_one", 0.0)


def test_prometheus_text_byte_equal_to_jax():
    def render(impl):
        m = impl.metrics.Metrics()
        _fill(m)
        return impl.obs.prometheus_text(m, now=m.started_at + 5.5)

    text = _both(render)
    assert "tcsdn_weird_name_with_chars 1" in text
    assert 'tcsdn_stage_tick_s{quantile="0.99"}' in text
    assert "tcsdn_stage_tick_s_count 1500" in text


def test_prometheus_exposition_golden_text():
    m = tmetrics.Metrics()
    m.inc("records", 3)
    m.set("flows_dropped", 2)
    for v in (0.25, 0.5, 1.0):
        m.observe("stage_predict_s", v)
    assert tobs.prometheus_text(m, now=m.started_at + 5.0) == (
        "# HELP tcsdn_uptime_seconds Seconds since the metrics "
        "registry reset.\n"
        "# TYPE tcsdn_uptime_seconds gauge\n"
        "tcsdn_uptime_seconds 5\n"
        "# TYPE tcsdn_records counter\n"
        "tcsdn_records 3\n"
        "# TYPE tcsdn_flows_dropped gauge\n"
        "tcsdn_flows_dropped 2\n"
        "# HELP tcsdn_stage_predict_s Window quantiles are exact "
        "nearest-rank over the newest 1024 samples; sum/count are "
        "lifetime.\n"
        "# TYPE tcsdn_stage_predict_s summary\n"
        'tcsdn_stage_predict_s{quantile="0.5"} 0.5\n'
        'tcsdn_stage_predict_s{quantile="0.9"} 1\n'
        'tcsdn_stage_predict_s{quantile="0.99"} 1\n'
        "tcsdn_stage_predict_s_sum 1.75\n"
        "tcsdn_stage_predict_s_count 3\n"
    )


def test_snapshot_and_report_equal_jax_but_uptime():
    def read(impl):
        m = impl.metrics.Metrics()
        _fill(m)
        snap = m.snapshot()
        snap.pop("uptime_s")
        report = re.sub(r"uptime_s=\S+", "uptime_s=U", m.report())
        h = m.histograms["stage_tick_s"]
        return snap, report, h.quantiles((0, 50, 99, 100)), h.mean

    snap, report, *_ = _both(read)
    assert snap["records"] == 5.5 and report.startswith("metrics ")


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_histogram_window_percentiles(impl):
    H = IMPLS[impl].metrics.Histogram
    h = H(window=100)
    assert h.percentile(50) == 0.0
    for v in range(1, 101):
        h.observe(float(v))
    assert h.percentile(0) == 1.0 and h.percentile(100) == 100.0
    assert h.percentile(50) == 51.0 and h.mean == pytest.approx(50.5)
    h4 = H(window=4)
    for v in (10, 20, 30, 40, 50, 60):
        h4.observe(v)
    assert (h4.percentile(0), h4.percentile(100), h4.count) == (30, 60, 6)


def test_timer_and_reset():
    m = tmetrics.Metrics()
    with m.time("op_s"):
        time.sleep(0.01)
    m.inc("a")
    snap = m.snapshot()
    assert snap["op_s_count"] == 1 and 0.005 < snap["op_s_p50"] < 1.0
    assert "op_s_p50=" in m.report()
    m.reset()
    assert not (m.counters or m.gauges or m.histograms)


# ---------------------------------------------------------------- health


def _health_script(impl):
    clk = [1000.0]
    h = impl.obs.HealthState(clock=lambda: clk[0], max_tick_age_s=30.0,
                             max_checkpoint_age_s=60.0)
    alive = [True]
    reports = [h.check()]
    h.model_loaded()
    h.tick()
    h.set_collector_probe(lambda: alive[0])
    reports.append(h.check())
    clk[0] += 29.0
    reports.append(h.check())
    clk[0] += 2.0  # 31 s since the tick: stale
    reports.append(h.check())
    h.tick()
    alive[0] = False
    reports.append(h.check())
    alive[0] = True
    clk[0] += 40.0  # past the checkpoint bound with none ever
    h.tick()
    reports.append(h.check())
    h.checkpoint()
    h.set_degrade(lambda: {"state": "DEGRADED", "rung": "DEGRADED"})
    h.set_label_cache(lambda: {"mode": "host", "coverage": 0.75})
    h.set_latency(lambda: {"observed": False})
    h.set_source_roster(lambda: [{"id": 0, "state": "HEALTHY"}])
    h.set_obs_port(43210)
    reports.append(h.check())
    # crashing status functions and probes degrade the report, never it
    h.set_degrade(lambda: 1 / 0)
    h.set_label_cache(lambda: {}["x"])
    h.set_latency(lambda: 1 / 0)
    h.set_source_roster(lambda: 1 / 0)
    h.set_collector_probe(lambda: 1 / 0)
    clk[0] += 0.5
    reports.append(h.check())
    return reports


def test_healthz_check_equal_to_jax_under_injected_clock():
    reports = _both(_health_script)
    healthy = [ok for ok, _ in reports]
    assert healthy == [True, True, True, False, False, False, True, False]
    _, last = reports[-2]
    assert last["degraded"] is True and last["obs_port"] == 43210
    assert last["label_cache"] == {"mode": "host", "coverage": 0.75}
    _, broken = reports[-1]
    assert broken["collector_alive"] is False
    assert broken["degrade"]["state"] == "unknown"
    assert "error" in broken["latency"]


# ---------------------------------------------------------------- recorder


def _recorder_script(impl, tmp_path):
    ticks = iter(range(1000))
    rec = impl.obs.FlightRecorder(capacity=8, clock=lambda: next(ticks))
    for i in range(10):  # overflow: the two oldest are displaced
        rec.record("span", name=f"s{i}", payload=np.int64(i),
                   obj=object.__new__(type("Opaque", (), {
                       "__repr__": lambda self: "<opaque>"})),
                   nested={"a": [1, (2, 3)], 4: None})
    plan = impl.faults.FaultPlan([impl.faults.FaultRule(
        "serving_ckpt.write")])
    with rec.observing_faults(), impl.faults.installed(plan):
        with pytest.raises(impl.faults.FaultInjected):
            impl.faults.fault_point("serving_ckpt.write")
    assert impl.faults._observers == []
    d = tmp_path / impl.obs.__name__
    path = rec.dump(str(d), "unit test/reason")
    lines = [json.loads(line) for line in open(path)]
    lines[0].pop("pid")
    return (rec.tail(), rec.tail(3), rec.tail(0), rec.count(),
            rec.count("fault.fire"), rec.events_seen,
            os.path.basename(path).split("-", 2)[2], lines)


def test_flight_recorder_tail_and_dump_equal_to_jax(tmp_path):
    tail, tail3, tail0, count, fires, seen, name, lines = _both(
        lambda impl: _recorder_script(impl, tmp_path))
    assert tail0 == [] and len(tail3) == 3 and count == 8 and fires == 1
    assert seen == 11 and name == "00000011-unit-test-reason.jsonl"
    assert lines[0]["kind"] == "meta" and lines[0]["displaced"] == 3
    assert lines[-1]["kind"] == "fault.fire"
    assert lines[-1]["site"] == "serving_ckpt.write"
    assert lines[1]["obj"] == "<opaque>"


def test_dump_metrics_snapshot(tmp_path):
    m = tmetrics.Metrics()
    m.inc("ticks", 4)
    path = tobs.dump_metrics_snapshot(m, str(tmp_path), "sig/usr1")
    assert os.path.basename(path).endswith("-sig-usr1.json")
    payload = json.load(open(path))
    assert payload["kind"] == "metrics" and payload["reason"] == "sig/usr1"
    assert payload["snapshot"]["ticks"] == 4


def test_ring_is_bounded_and_thread_safe_under_concurrent_spans():
    rec = tobs.FlightRecorder(capacity=256)
    tr = tobs.Tracer(recorder=rec)

    def worker():
        for _ in range(200):
            with tr.span("outer"):
                with tr.span("inner"):
                    pass

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert rec.events_seen == 8 * 200 * 2
    events = rec.tail()
    seqs = [e["seq"] for e in events]
    assert len(events) == 256 and seqs == sorted(seqs)
    assert len(set(seqs)) == 256


def test_atomic_write_fault_sites_keep_the_previous_file(tmp_path):
    """Both hazard points of ``atomic_write_bytes`` leave the committed
    file as it was and no temp behind; ``sweep_stale_tmp`` collects the
    orphan a real kill leaves."""
    path = str(tmp_path / "f.bin")
    tatomicio.atomic_write_bytes(path, b"first")
    for site in ("mid", "rename"):
        plan = tfaults.FaultPlan([tfaults.FaultRule(site)])
        with tfaults.installed(plan), pytest.raises(tfaults.FaultInjected):
            tatomicio.atomic_write_bytes(
                path, b"second" * 100, mid_write_site="mid",
                pre_rename_site="rename")
        assert open(path, "rb").read() == b"first"
        assert os.listdir(tmp_path) == ["f.bin"]
    (tmp_path / ".f.bin.tmp.4242").write_bytes(b"torn")
    (tmp_path / "keep.tmp").write_bytes(b"not ours")
    assert tatomicio.sweep_stale_tmp(str(tmp_path)) == 1
    assert sorted(os.listdir(tmp_path)) == ["f.bin", "keep.tmp"]
    assert tatomicio.sweep_stale_tmp(str(tmp_path / "missing")) == 0


# ---------------------------------------------------------------- tracer


def _tracer_script(impl):
    clk = [100.0]
    m = impl.metrics.Metrics()
    rec = impl.obs.FlightRecorder(clock=lambda: 0.0)
    tr = impl.obs.Tracer(metrics=m, recorder=rec, clock=lambda: clk[0])
    currents = []
    with tr.span("tick"):
        clk[0] += 0.25
        with tr.span("predict", rows=64):
            currents.append(tr.current().name)
            clk[0] += 1.5
        with tr.span("stage.device"):
            clk[0] += 0.125
    currents.append(tr.current())
    with pytest.raises(ValueError, match="boom"):
        with tr.span("tick"):
            with tr.span("snapshot"):
                clk[0] += 2.0
                raise ValueError("boom")
    currents.append(tr.current())
    snap = m.snapshot()
    snap.pop("uptime_s")
    return currents, snap, rec.tail()


def test_tracer_spans_equal_to_jax():
    currents, snap, events = _both(_tracer_script)
    assert currents == ["predict", None, None]
    assert snap["stage_predict_s_p50"] == 1.5
    assert snap["stage_device_s_p50"] == 0.125  # "stage." prefix stripped
    assert snap["stage_snapshot_s_p50"] == 2.0
    assert [(e["name"], e["depth"], e["parent"], e["error"])
            for e in events] == [
        ("predict", 1, "tick", None), ("stage.device", 1, "tick", None),
        ("tick", 0, None, None), ("snapshot", 1, "tick", "ValueError"),
        ("tick", 0, None, "ValueError")]
    assert events[0]["rows"] == 64


def test_span_stacks_are_thread_local():
    tr = tobs.Tracer()
    seen = {}
    gate = threading.Barrier(2)

    def worker(name):
        with tr.span(name):
            gate.wait(timeout=10)
            seen[name] = tr.current().name
            gate.wait(timeout=10)

    threads = [threading.Thread(target=worker, args=(n,)) for n in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert seen == {"a": "a", "b": "b"}


# ---------------------------------------------------------------- latency


def _latency_script(impl):
    clk = [100.0]
    m = impl.metrics.Metrics()
    rec = impl.obs.FlightRecorder(clock=lambda: 0.0)
    lat = impl.latency.LatencyProvenance(metrics=m, recorder=rec,
                                         clock=lambda: clk[0], slo_s=2.5)
    statuses = [lat.status(), lat.stage_increments()]
    # a fan-in batch: emitted 100, enqueued 100.5, dequeued 101
    lat.begin_tick([(3, 100.0, 100.5, 101.0, 8), (1, 100.2, None, None, 4)])
    clk[0] = 101.25
    lat.mark_parse()
    clk[0] = 101.75
    lat.mark_scatter()
    s1 = lat.seal()
    # the host keeps ingesting while the render is in flight; an
    # unstamped batch flows but never folds
    lat.begin_tick([(3, 101.5, 101.6, 101.8, 2), (0, None, None, None, 3)])
    lat.mark_parse()
    clk[0] = 102.0
    lat.mark_scatter()
    clk[0] = 102.5
    lat.mark_device(s1)
    clk[0] = 103.0
    lat.render_visible(s1)
    statuses += [lat.status(), lat.stage_increments()]
    # a coalesced render: two seals, only the second prints
    s2 = lat.seal()
    lat.begin_tick([(1, 102.9, None, None, 1)])
    lat.mark_parse()
    lat.mark_scatter()
    s3 = lat.seal()
    assert s3 > s2
    discarded = lat.drop_source(1)
    clk[0] = 106.0  # e2e 4.5 s: the p99 crosses the 2.5 s SLO
    lat.mark_device(s3)
    lat.render_visible(s3)
    statuses += [lat.status(), lat.stage_increments()]
    hist = {k: (h.count, sorted(h._samples)) for k, h in m.histograms.items()}
    return statuses, discarded, hist, dict(m.counters), dict(m.gauges), \
        rec.tail()


def test_latency_provenance_equal_to_jax():
    statuses, discarded, hist, counters, gauges, events = _both(
        _latency_script)
    assert statuses[0] == {"observed": False} and statuses[1] == {}
    assert statuses[2]["observed"] and statuses[2]["dominant_stage"]
    assert discarded == 1  # source 1's third-tick entry, never rendered
    assert hist["queue_wait_s"] == (2, [101.8 - 101.6, 0.5])
    assert counters == {"latency_unstamped_batches": 1,
                        "latency_entries_discarded": 1,
                        "latency_slo_breaches": 1}
    assert gauges["latency_slo_breached"] == 1.0
    (breach,) = [e for e in events if e["kind"] == "latency.slo_breach"]
    assert breach["slo_s"] == 2.5


def test_drop_source_discards_pending_entries():
    m = tmetrics.Metrics()
    lat = tlatency.LatencyProvenance(metrics=m, clock=lambda: 1.0)
    lat.begin_tick([(1, 0.5, None, None, 4), (2, 0.5, None, None, 4)])
    lat.mark_parse()
    lat.mark_scatter()
    assert lat.drop_source(1) == 1
    lat.render_visible(lat.seal())
    assert "source_1_e2e_s" not in m.histograms
    assert m.histograms["source_2_e2e_s"].count == 1
    assert m.counters["latency_entries_discarded"] == 1


def test_begin_tick_provenance_equal_to_jax():
    """The CLI's direct-source entry builder: an unstamped record batch is
    counted and never folded, a raw byte batch takes its arrival time, a
    stamped batch its lead record's stamp."""
    def script(impl):
        m = impl.metrics.Metrics()
        lat = impl.latency.LatencyProvenance(metrics=m, clock=lambda: 5.0)
        R = JRecord if impl is IMPLS["jax"] else TelemetryRecord
        begin = (jbegin_tick_provenance if impl is IMPLS["jax"]
                 else lambda lt, b, _probe: tcli._begin_tick_provenance(
                     lt, b, None))
        recs = [R(time=1, datapath="1", in_port="1", eth_src="aa",
                  eth_dst="bb", out_port="2", packets=1, bytes=10)]
        begin(lat, list(recs), {})
        begin(lat, b"data\t...", {})
        stamped = [R(time=1, datapath="1", in_port="1", eth_src="cc",
                     eth_dst="dd", out_port="2", packets=1, bytes=10)]
        object.__setattr__(stamped[0], "emit_ts", 4.0)
        begin(lat, stamped, {})
        lat.mark_parse()
        lat.mark_scatter()
        s = lat.seal()
        lat.mark_device(s)
        lat.render_visible(s)
        return dict(m.counters), sorted(
            m.histograms["e2e_emit_to_render_s"]._samples)

    counters, samples = _both(script)
    assert counters == {"latency_unstamped_batches": 1}
    assert samples == [0.0, 1.0]


def test_stamp_records_and_batch_emit_ts():
    recs = [TelemetryRecord(time=1, datapath="1", in_port="1",
                            eth_src=s, eth_dst="bb", out_port="2",
                            packets=1, bytes=10) for s in ("aa", "cc")]
    assert batch_emit_ts(recs) is None
    assert stamp_records(recs[:1], 7.0)
    stamp_records(recs[:1], 9.0)  # write-once
    assert batch_emit_ts(recs) == 7.0
    assert batch_emit_ts(b"data\t") is None and batch_emit_ts([]) is None


# ---------------------------------------------------------------- exposition


def _get(url, timeout=5):
    return urllib.request.urlopen(url, timeout=timeout)


def test_exposition_endpoints_and_clean_shutdown():
    m = tmetrics.Metrics()
    m.inc("ticks", 7)
    rec = tobs.FlightRecorder()
    for i in range(5):
        rec.record("span", name=f"s{i}")
    clk = [0.0]
    h = tobs.HealthState(clock=lambda: clk[0], max_tick_age_s=10.0)
    h.tick()
    srv = tobs.ExpositionServer(m, recorder=rec, health=h, port=0)
    srv.start()
    with pytest.raises(RuntimeError, match="already started"):
        srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        resp = _get(base + "/metrics")
        assert resp.headers["Content-Type"].startswith(
            "text/plain; version=0.0.4")
        assert "tcsdn_ticks 7" in resp.read().decode()
        assert json.loads(_get(base + "/healthz").read())["healthy"] is True
        events = json.loads(_get(base + "/events?n=2").read())
        assert [e["name"] for e in events] == ["s3", "s4"]
        assert json.loads(_get(base + "/events?n=0").read()) == []
        for path, code in (("/nope", 404), ("/events?n=x", 400),
                           ("/profile?seconds=1", 404)):
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(base + path)
            assert err.value.code == code
        clk[0] += 11.0  # stale: 503 with the report in the body
        with pytest.raises(urllib.error.HTTPError) as e503:
            _get(base + "/healthz")
        assert e503.value.code == 503
        assert json.loads(e503.value.read())["tick_stale"] is True
    finally:
        srv.stop()
    srv.stop()  # idempotent
    with pytest.raises(urllib.error.URLError):
        _get(base + "/metrics", timeout=0.5)


def test_profile_endpoint_answers_as_jax_without_a_profiler():
    """A server built without a profiler (a serve with no ``--obs-dir``):
    the ``/profile`` answer is the JAX server's with none, byte for byte."""
    bodies = {}
    for name, impl in IMPLS.items():
        srv = impl.obs.ExpositionServer(impl.metrics.Metrics(), port=0)
        srv.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(f"http://127.0.0.1:{srv.port}/profile")
            bodies[name] = (err.value.code, err.value.read())
        finally:
            srv.stop()
    assert bodies["port"] == bodies["jax"]
    assert bodies["port"][0] == 404 and b"not armed" in bodies["port"][1]
    assert issubclass(tobs.ProfilerBusy, RuntimeError)


_LINE = re.compile(
    r'^(# (HELP|TYPE) \S+ .+|tcsdn_[A-Za-z0-9_:]+(\{quantile="0\.\d+"\})? '
    r'-?[0-9.e+-]+|nan|inf)$')


def test_scrape_during_pipelined_serve(tmp_path, capsys):
    """``/metrics`` scraped as fast as it answers while the no-flag
    (pipelined) serve runs: the device-stage worker observes its stage
    histograms while the exposition thread renders them. Every scrape is
    a 200 of well-formed Prometheus lines, and the serve's own stage
    series appear."""
    from test_torch_incremental import _checkpoints
    import chip_smoke

    X = chip_smoke.synthetic_table(64, 2, "cpu")
    from traffic_classifier_sdn_tpu_torch.core import flow_table as ft

    _, tdir = _checkpoints(tmp_path, "Randomforest", ft.features12(X).numpy())
    scrapes, errors, done = [], [], threading.Event()

    def scraper():
        while not done.is_set():
            port = int(global_metrics.gauges.get("obs_port", 0))
            if not port:
                time.sleep(0.005)
                continue
            try:
                scrapes.append(_get(f"http://127.0.0.1:{port}/metrics",
                                    timeout=5).read().decode())
                time.sleep(0.002)  # as often as a busy scraper, not a spin
            except urllib.error.HTTPError as e:
                errors.append(e)  # the server answered, with an error
            except (urllib.error.URLError, OSError):
                pass  # not listening (yet, or any more)

    t = threading.Thread(target=scraper)
    global_metrics.reset()
    t.start()
    try:
        summary = tcli.main([
            "Randomforest", "--source", "synthetic", "--synthetic-flows",
            "64", "--capacity", "64", "--print-every", "1", "--max-ticks",
            "40", "--native-checkpoint", tdir, "--device", "cpu",
            "--obs-port", "0", "--table-rows", "8"])
    finally:
        done.set()
        t.join(timeout=30)
    capsys.readouterr()
    assert summary.pipeline is not None and len(summary.render_ticks) == 40
    live = [s for s in scrapes if "tcsdn_stage_render_s" in s]
    assert len(live) >= 2 and not errors
    for text in scrapes:
        bad = [ln for ln in text.splitlines() if not _LINE.match(ln)]
        assert not bad, bad[:3]
    last = live[-1]
    for name in ("stage_host_s", "stage_device_s", "stage_predict_s",
                 "stage_dispatch_s", "stage_overlap_s", "queue_depth"):
        assert f"tcsdn_{name}" in last
