"""The drift → retrain → promote loop of the port
(``serving/{drift,retrain}.py``) against the JAX package's
(``traffic_classifier_sdn_tpu/serving/{drift,retrain}.py``), on the same
seeded numpy inputs.

Tolerances:

- ``DriftMonitor``: bitwise. Both are the same float64 numpy arithmetic
  in the same order, so every window report (score, over/tripped flags,
  attribution), the reference, the reservoir and the re-based reference
  are equal value for value, on the JAX test harness's stream (a
  two-class teacher over 12 features, ``tests/test_drift.py``) with a
  mid-stream shift and open-set ``unknown`` labels, and on the replay
  scenario's capture through each package's own ingest spine;
- ``DriftController``: the state sequence, the status counters and the
  metric counters equal JAX's in the end-to-end, deadline-abandon and
  ``promote.swap`` rollback scenarios (the refits are each package's own
  gnb trainer: moments within 1e-6, so every probe agrees alike);
- CLI: stdout byte-equal to the JAX serial serve (``--pipeline off``) with
  ``--drift auto --openset auto`` on closed-world traffic (forest and
  gnb), and on a drifting capture whose refit (``retrain.fit_family``) is
  JAX's in both packages, carried across by ``interop`` (the fit runs
  inline, so the promotion lands on the same render in both); the DRIFT
  transitions on stderr equal; serving checkpoints with drift and
  open-set on equal to JAX's entry for entry, ``feature_reference/``
  included.
"""

import contextlib
import io
import os
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
from traffic_classifier_sdn_tpu import cli as jcli
from traffic_classifier_sdn_tpu.ingest.batcher import FlowStateEngine as JEngine
from traffic_classifier_sdn_tpu.ingest.protocol import TelemetryRecord as JRec
from traffic_classifier_sdn_tpu.ingest.protocol import format_line
from traffic_classifier_sdn_tpu.ingest.replay import iter_capture as jiter
from traffic_classifier_sdn_tpu.io import checkpoint as jck
from traffic_classifier_sdn_tpu.models import forest as jforest
from traffic_classifier_sdn_tpu.models import gnb as jgnb
from traffic_classifier_sdn_tpu.serving import drift as jdrift
from traffic_classifier_sdn_tpu.serving import retrain as jretrain
from traffic_classifier_sdn_tpu.utils import faults as jfaults
from traffic_classifier_sdn_tpu.utils.metrics import Metrics as JMetrics
from traffic_classifier_sdn_tpu_torch import cli as tcli
from traffic_classifier_sdn_tpu_torch import interop
from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
from traffic_classifier_sdn_tpu_torch.ingest.batcher import FlowStateEngine
from traffic_classifier_sdn_tpu_torch.ingest.replay import iter_capture
from traffic_classifier_sdn_tpu_torch.io import checkpoint as tck
from traffic_classifier_sdn_tpu_torch.serving import drift as tdrift
from traffic_classifier_sdn_tpu_torch.serving import retrain as tretrain
from traffic_classifier_sdn_tpu_torch.utils import faults as tfaults
from traffic_classifier_sdn_tpu_torch.utils.metrics import Metrics as TMetrics

CLASSES = chip_smoke.CLASSES


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU fits here issue many small torch ops; one intra-op
    thread each keeps them from contending with the suite's other
    workers for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _default_serving_menus():
    """The serves here run the default serving menus. A CLI given
    ``--knn-topk`` publishes it through TCSDN_KNN_TOPK for the rest of its
    process, so a serve of another module may have left it set."""
    with pytest.MonkeyPatch.context() as mp:
        for var in ("TCSDN_KNN_TOPK", "TCSDN_SVC_KERNEL",
                    "TCSDN_FOREST_KERNEL"):
            mp.delenv(var, raising=False)
        yield


# ---------------------------------------------------------------------------
# harness: the JAX test's 2-class teacher over a 12-feature stream
# ---------------------------------------------------------------------------


def _teacher(params, X):
    """The 'live model': class 0 below 500 in feature 0, class 1 above."""
    return (np.asarray(X)[:, 0] > 500.0).astype(np.int32)


def _batch(lo, hi, n=16, seed=0):
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 12), np.float32)
    X[: n // 2, 0] = lo * (1 + 0.01 * rng.rand(n // 2))
    X[n // 2:, 0] = hi * (1 + 0.01 * rng.rand(n - n // 2))
    X[:, 1] = 1.0  # a constant column keeps every row active
    return X


BOOT_GNB = {
    "theta": np.asarray([[10.0] * 12, [1000.0] * 12], np.float64),
    "var": np.ones((2, 12), np.float64),
    "class_prior": np.full(2, 0.5),
}


def _same(a, b, path="report") -> None:
    """Exact equality of nested reports: dicts, lists, tuples, floats
    (bitwise, NaN included), arrays (dtype, shape and bytes)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), (path, set(a) ^ set(b))
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    elif isinstance(a, float):
        assert np.float64(a).tobytes() == np.float64(b).tobytes(), (path, a, b)
    else:
        assert a == b and type(a) is type(b), (path, a, b)


# ---------------------------------------------------------------------------
# DriftMonitor: bitwise
# ---------------------------------------------------------------------------


def _labels_with_unknown(X, i):
    """The teacher's labels with every 5th row of odd ticks relabeled to
    the open-set unknown index (2 of 2 classes)."""
    y = _teacher(None, X)
    if i % 2:
        y[::5] = 2
    return y


def _monitor_stream(mon, n_ticks=40, shift_at=20):
    reports = []
    for i in range(1, n_ticks + 1):
        lo, hi = (100.0, 10000.0) if i > shift_at else (10.0, 1000.0)
        X = _batch(lo, hi, seed=i)
        reports.append(mon.observe(X, _labels_with_unknown(X, i)))
    return reports


@pytest.mark.parametrize("window,trips,cal", [(3, 2, 2), (2, 1, 1),
                                              (4, 3, 2)])
def test_monitor_reports_equal_jax_bitwise(window, trips, cal):
    kw = dict(n_classes=2, window=window, threshold=3.0, trips=trips,
              calibration_windows=cal, reservoir_rows=64)
    j, t = jdrift.DriftMonitor(**kw), tdrift.DriftMonitor(**kw)
    want, got = _monitor_stream(j), _monitor_stream(t)
    assert any(r and r["tripped"] for r in want)
    assert any(r and r.get("calibrating") for r in want)
    _same(want, got)
    _same(j.reference_arrays(), t.reference_arrays(), "reference")
    _same(j.reservoir_window(), t.reservoir_window(), "reservoir")
    _same(j.known_reservoir_window(), t.known_reservoir_window(), "known")
    assert j.over_streak == t.over_streak and j.windows == t.windows
    assert j.rebase_from_reservoir() == t.rebase_from_reservoir() is True
    _same(j.reference_arrays(), t.reference_arrays(), "rebased")
    # a monitor seeded with the persisted reference scores alike
    ref = j.reference_arrays()
    js = jdrift.DriftMonitor(reference=ref, **kw)
    ts = tdrift.DriftMonitor(reference=ref, **kw)
    _same(_monitor_stream(js, 12, 0), _monitor_stream(ts, 12, 0), "seeded")


def test_monitor_rejects_a_mismatched_reference_as_jax_does():
    ref = {"mean": np.zeros(11), "std": np.ones(11),
           "class_freq": np.full(2, 0.5)}
    for mod in (jdrift, tdrift):
        with pytest.raises(ValueError, match="mean shape"):
            mod.DriftMonitor(reference=ref)


def test_monitor_trip_window_from_replay_equals_jax(tmp_path):
    """The JAX replay scenario (rates ×50 at tick 21) through each
    package's own ingest spine and ``features()``: the same reports, the
    trip at the computed window."""
    n_flows, shift_tick, n_ticks = 8, 21, 40
    path = str(tmp_path / "shift.capture")
    with open(path, "wb") as f:
        cum = np.zeros(n_flows, np.int64)
        for t in range(1, n_ticks + 1):
            rate = 100 if t < shift_tick else 5000
            for i in range(n_flows):
                cum[i] += rate * (i + 1)
                f.write(format_line(JRec(
                    time=t, datapath="1", in_port="1",
                    eth_src=f"f{i:02d}", eth_dst="gw", out_port="2",
                    packets=int(cum[i] // 100), bytes=int(cum[i]),
                )))
    runs = []
    for mod, engine, batches in (
        (jdrift, JEngine(capacity=32), jiter(path)),
        (tdrift, FlowStateEngine(32, device="cpu"), iter_capture(path)),
    ):
        mon = mod.DriftMonitor(window=4, threshold=4.0, trips=2,
                               calibration_windows=2)
        reports = []
        for batch in batches:
            engine.mark_tick()
            engine.ingest(batch)
            engine.step()
            X = np.asarray(engine.features())
            mask = X.any(axis=1)
            reports.append(mon.observe(
                X[mask], np.zeros(int(mask.sum()), np.int32)))
        runs.append(reports)
    _same(runs[0], runs[1])
    trips = [r["window"] for r in runs[1] if r and r["tripped"]]
    assert trips and trips[0] == (shift_tick - 1) // 4 + 1 + 2 - 1


# ---------------------------------------------------------------------------
# DriftGate, rotation
# ---------------------------------------------------------------------------


def test_gate_is_a_passthrough_until_installed_then_swaps():
    calls = []

    def inner(params, X):
        calls.append(params)
        return X * 2

    gate = tdrift.DriftGate(inner)
    X = torch.arange(4)
    assert torch.equal(gate("p", X), X * 2) and calls == ["p"]
    assert gate.label_epoch == (0, 0) and not gate.swapped
    prev = gate.install(lambda p, X: X + p, 10)
    assert prev is inner and gate.swapped
    assert torch.equal(gate("ignored", X), X + 10)
    assert gate.label_epoch == (1, 0)
    cap = gate.take_capture()
    assert cap is not None and gate.take_capture() is None


def test_gate_ladder_view_follows_promotions():
    class Ladder:
        def __init__(self, stale):
            self.render_stale = stale
            self.closed = False

        def status(self):
            return {"rung": "HEALTHY" if not self.render_stale else "BROKEN"}

        def close(self):
            self.closed = True

        def __call__(self, params, X):
            return X

    boot, promoted = Ladder(False), Ladder(True)
    gate = tdrift.DriftGate(boot)
    view = tdrift.GateLadderView(gate, boot)
    assert not view.render_stale and view.status()["rung"] == "HEALTHY"
    gate.install(promoted, None)
    assert view.render_stale and view.status()["rung"] == "BROKEN"
    view.close()
    assert boot.closed and promoted.closed


def _gnb_params(pkg):
    return (jgnb.from_numpy(BOOT_GNB) if pkg == "jax"
            else interop.gnb_params_from_numpy(BOOT_GNB, device="cpu"))


def test_rotation_resolves_past_unloadable_members(tmp_path):
    d = str(tmp_path / "rot")
    params = _gnb_params("port")
    p0 = tretrain.save_candidate(d, 0, "gnb", params, ("ping", "voice"))
    p1 = tretrain.save_candidate(d, 1, "gnb", params, ("ping", "voice"))
    assert tretrain.resolve_latest(d, device="cpu") == p1
    assert tretrain.next_seq(d) == 2
    os.unlink(os.path.join(p1, "manifest.json"))
    assert tretrain.resolve_latest(d, device="cpu") == p0
    for s in range(2, 6):
        tretrain.save_candidate(d, s, "gnb", params, ("ping", "voice"))
    tretrain.prune_candidates(d, keep=3)
    assert [s for s, _ in tretrain.list_candidates(d)] == [5, 4, 3]
    tretrain.discard_candidate(tretrain.candidate_path(d, 5))
    assert tretrain.resolve_latest(d, device="cpu") == \
        tretrain.candidate_path(d, 4)


def test_background_retrainer_abandon_discards_the_late_result():
    r = tretrain.BackgroundRetrainer()
    release, seen = threading.Event(), {}

    def job(is_current):
        release.wait(10)
        seen["current"] = is_current()
        return "late"

    r.submit(job)
    assert r.poll() == tretrain.RUNNING
    with pytest.raises(RuntimeError):
        r.submit(job)
    r.abandon()
    release.set()
    deadline = time.monotonic() + 10
    while "current" not in seen and time.monotonic() < deadline:
        time.sleep(0.01)
    assert seen["current"] is False and r.poll() == tretrain.IDLE
    r.submit(lambda is_current: 42)
    while r.poll() == tretrain.RUNNING:
        time.sleep(0.01)
    assert r.take() == (tretrain.DONE, 42, None)


# ---------------------------------------------------------------------------
# DriftController: each scenario in both packages
# ---------------------------------------------------------------------------

PKGS = {
    "jax": (jdrift, jretrain, jfaults, JMetrics),
    "port": (tdrift, tretrain, tfaults, TMetrics),
}


def _controller(pkg, tmp_path, gate, metrics, **kw):
    drift = PKGS[pkg][0]
    kw.setdefault("window", 3)
    kw.setdefault("threshold", 3.0)
    kw.setdefault("trips", 2)
    kw.setdefault("calibration_windows", 2)
    kw.setdefault("probe_successes", 2)
    kw.setdefault("min_retrain_rows", 16)
    kw.setdefault("boot_params", _gnb_params(pkg))
    if pkg == "port":
        kw["device"] = "cpu"
    return drift.DriftController(
        gate, family="gnb", classes=("ping", "voice"),
        directory=str(tmp_path / pkg / "drift"), metrics=metrics, **kw)


def _drive(pkg, gate, ctl, i, shifted):
    lo, hi = (100.0, 10000.0) if shifted else (10.0, 1000.0)
    X = _batch(lo, hi, seed=i)
    labels = gate(None, X if pkg == "jax" else torch.from_numpy(X))
    ctl.poll()
    return np.asarray(labels)


def _wait(pkg, ctl):
    retrain = PKGS[pkg][1]
    deadline = time.monotonic() + 90
    while ctl._retrainer.poll() == retrain.RUNNING:
        assert time.monotonic() < deadline, "background retrain never ended"
        time.sleep(0.02)


def _run_e2e(pkg, tmp_path):
    drift, retrain, _, Metrics = PKGS[pkg]
    m = Metrics()
    gate = drift.DriftGate(_teacher)
    ctl = _controller(pkg, tmp_path, gate, m)
    states = []
    try:
        i = 0
        while ctl.state != drift.PROMOTED and i < 200:
            i += 1
            _drive(pkg, gate, ctl, i, shifted=i > 12)
            states.append(ctl.state)
            if ctl.state == drift.RETRAINING:
                _wait(pkg, ctl)
        promoted_at = i
        X = _batch(100.0, 10000.0, seed=9999)
        served = np.asarray(gate(None, X if pkg == "jax"
                                 else torch.from_numpy(X)))
        for j in range(12):
            _drive(pkg, gate, ctl, 1000 + j, shifted=True)
            states.append(ctl.state)
        members = [s for s, _ in retrain.list_candidates(
            str(tmp_path / pkg / "drift"))]
        return (states, promoted_at, served, ctl.status(),
                dict(m.counters), members)
    finally:
        ctl.close()


def test_e2e_shift_promotes_as_jax_does(tmp_path):
    """Shift → trip → background refit (each package's gnb trainer) →
    candidate in the rotation → two clean probes → promotion, re-based
    reference: the same states on the same ticks, the same counters."""
    want, got = _run_e2e("jax", tmp_path), _run_e2e("port", tmp_path)
    assert want[0] == got[0] and want[1] == got[1]
    assert tdrift.PROMOTED in got[0] and got[0][-1] == tdrift.STEADY
    np.testing.assert_array_equal(got[2], _teacher(None, _batch(
        100.0, 10000.0, seed=9999)))
    np.testing.assert_array_equal(want[2], got[2])
    _same(want[3], got[3], "status")
    assert want[4] == got[4]
    assert want[5] == got[5] and 0 in got[5]


def _run_deadline(pkg, tmp_path, monkeypatch):
    drift, retrain, _, Metrics = PKGS[pkg]
    release, started = threading.Event(), threading.Event()

    def wedged_fit(family, X, y, n_classes, **kw):
        started.set()
        release.wait(timeout=30)
        raise RuntimeError("never reached before abandon")

    monkeypatch.setattr(retrain, "fit_family", wedged_fit)
    clock = [1000.0]
    m = Metrics()
    gate = drift.DriftGate(_teacher)
    ctl = _controller(pkg, tmp_path, gate, m, retrain_deadline=50.0,
                      clock=lambda: clock[0])
    states = []
    try:
        i = 0
        while ctl.state != drift.RETRAINING and i < 40:
            i += 1
            _drive(pkg, gate, ctl, i, shifted=i > 6)
            states.append(ctl.state)
        assert started.wait(timeout=10)
        for step in (49.0, 2.0):
            clock[0] += step
            i += 1
            _drive(pkg, gate, ctl, i, shifted=True)
            states.append(ctl.state)
        return states, ctl.status(), dict(m.counters), gate.swapped
    finally:
        release.set()
        ctl.close()


def test_deadline_abandon_as_jax_does(tmp_path, monkeypatch):
    want = _run_deadline("jax", tmp_path, monkeypatch)
    got = _run_deadline("port", tmp_path, monkeypatch)
    assert want[0] == got[0]
    assert got[0][-2] == tdrift.RETRAINING and got[0][-1] != \
        tdrift.RETRAINING
    _same(want[1], got[1], "status")
    assert got[1]["retrain_failures"] == 1
    assert want[2] == got[2] and not got[3]


def _run_rollback(pkg, tmp_path):
    drift, retrain, faults, Metrics = PKGS[pkg]
    m = Metrics()
    gate = drift.DriftGate(_teacher)
    ctl = _controller(pkg, tmp_path, gate, m)
    plan = faults.FaultPlan([faults.FaultRule("promote.swap", times=None)],
                            0)
    states, served = [], []
    try:
        with faults.installed(plan):
            i = 0
            while ctl.state != drift.ROLLED_BACK and i < 200:
                i += 1
                served.append(_drive(pkg, gate, ctl, i, shifted=i > 12))
                states.append(ctl.state)
                if ctl.state == drift.RETRAINING:
                    _wait(pkg, ctl)
        d = str(tmp_path / pkg / "drift")
        latest = (retrain.resolve_latest(d) if pkg == "jax"
                  else retrain.resolve_latest(d, device="cpu"))
        return (states, served, ctl.status(), dict(m.counters),
                os.path.basename(latest), plan.fires, gate.swapped)
    finally:
        ctl.close()


def test_promote_swap_rollback_as_jax_does(tmp_path):
    """``promote.swap`` armed: the promotion rolls back to the boot seed
    and the old model (the teacher) serves every tick, in both."""
    want, got = _run_rollback("jax", tmp_path), _run_rollback("port",
                                                              tmp_path)
    assert want[0] == got[0] and got[0][-1] == tdrift.ROLLED_BACK
    for i, labels in enumerate(got[1], start=1):
        lo, hi = (100.0, 10000.0) if i > 12 else (10.0, 1000.0)
        np.testing.assert_array_equal(labels, _teacher(None, _batch(
            lo, hi, seed=i)))
    _same(want[2], got[2], "status")
    assert want[3] == got[3] and got[3]["rollbacks"] == 1
    assert want[4] == got[4] == "model-000000000"
    assert want[5] and got[5] and not got[6]


def test_mode_matched_parity_promotes_a_permuted_candidate(tmp_path):
    class Permuted:
        def __call__(self, params, X):
            return (1 - _teacher(None, X)).astype(np.int32)

    gate = tdrift.DriftGate(_teacher)
    ctl = _controller("port", tmp_path, gate, None,
                      build_serving=lambda params: (Permuted(), None),
                      parity_mode="mode-matched")
    try:
        i = 0
        while ctl.state != tdrift.PROMOTED and i < 200:
            i += 1
            _drive("port", gate, ctl, i, shifted=i > 12)
            if ctl.state == tdrift.RETRAINING:
                _wait("port", ctl)
        assert ctl.state == tdrift.PROMOTED and gate.swapped
    finally:
        ctl.close()


# ---------------------------------------------------------------------------
# CLI against the JAX CLI
# ---------------------------------------------------------------------------


def _serve(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        summary = main(argv)
    return out.getvalue(), err.getvalue(), summary


def _drift_lines(err: str) -> list:
    return [ln for ln in err.splitlines() if ln.startswith("DRIFT:")]


def _sample(n_flows: int = 300) -> np.ndarray:
    return ft.features12(chip_smoke.synthetic_table(n_flows, 3, "cpu")).numpy()


def _model_dirs(tmp_path, family: str):
    X = _sample()
    jdir, tdir = str(tmp_path / "jax_ckpt"), str(tmp_path / "port_ckpt")
    if family == "forest":
        d = chip_smoke.random_forest(0, X, n_trees=16)
        jck.save_model(jdir, "forest", jforest.from_numpy(d), classes=CLASSES)
        tck.save_model(tdir, "forest",
                       interop.forest_params_from_numpy(d, device="cpu"),
                       classes=CLASSES)
    else:
        d = chip_smoke.random_gnb(0, X)
        jck.save_model(jdir, "gnb", jgnb.from_numpy(d), classes=CLASSES)
        tck.save_model(tdir, "gnb",
                       interop.gnb_params_from_numpy(d, device="cpu"),
                       classes=CLASSES)
    return jdir, tdir


SUBCOMMAND = {"forest": "Randomforest", "gnb": "gaussiannb"}
DRIFT_FLAGS = ["--drift", "auto", "--drift-window", "2", "--drift-trips",
               "2", "--drift-probe-successes", "2", "--openset", "auto",
               "--openset-calibration-rows", "64"]


def _both(tmp_path, family, argv, port_extra=()):
    jdir, tdir = _model_dirs(tmp_path, family)
    sub = SUBCOMMAND[family]
    want = _serve(jcli.main, [sub, "--native-checkpoint", jdir, *argv,
                              "--drift-dir", str(tmp_path / "jd")])
    got = _serve(tcli.main, [sub, "--native-checkpoint", tdir, *argv,
                             "--drift-dir", str(tmp_path / "td"),
                             "--device", "cpu", *port_extra])
    return want, got


@pytest.mark.parametrize("family", ["forest", "gnb"])
def test_closed_world_drift_openset_stdout_equals_jax(tmp_path, family):
    """A stationary synthetic stream: the monitor calibrates and closes
    windows, the gate arms, nothing trips and nothing is rejected — and
    stdout is JAX's serial serve's byte for byte."""
    argv = [
        "--source", "synthetic", "--synthetic-flows", "40",
        "--capacity", "64", "--print-every", "1", "--max-ticks", "12",
        "--idle-timeout", "0", "--table-rows", "16", "--pipeline", "off",
        *DRIFT_FLAGS,
    ]
    (want, want_err, _), (got, got_err, summary) = _both(tmp_path, family,
                                                         argv)
    assert want.count("Flow ID") == 12
    assert got == want
    assert _drift_lines(got_err) == _drift_lines(want_err) == []
    assert summary.drift["state"] == "STEADY"
    assert summary.drift["windows"] >= 4 and summary.drift["calibrated"]
    assert summary.openset["state"] == "ARMED"
    assert summary.openset["rejections"] == 0


def _sync_retrainer(retrain):
    """``retrain.BackgroundRetrainer`` with the fit run inline in
    ``submit``: the promotion then lands on the same render whatever the
    threads' timing."""

    class Inline(retrain.BackgroundRetrainer):
        def submit(self, fn):
            with self._lock:
                self._gen += 1
                gen = self._gen
                self._state = retrain.RUNNING
                self._result = self._error = None
            self._run(gen, fn)

    return Inline


@pytest.mark.parametrize("pipeline", ["off", "auto"])
def test_promotion_serve_stdout_equals_jax(tmp_path, monkeypatch, pipeline):
    """A capture whose packet rates jump ×10 at tick 9: the monitor trips,
    both packages refit with JAX's gnb trainer on their (equal) retrain
    windows — the port's copy carried across by ``interop`` — and the
    candidate promotes after two probes at the stated parity floor. Every
    table, before and after the swap, is the JAX serial serve's byte for
    byte; pipelined too (``PIPELINE_DEPTH`` 64, so no render coalesces),
    where the swap lands on the device-stage worker between renders and
    the next render's labels come from the promoted model."""
    if pipeline == "auto":
        monkeypatch.setattr(tcli, "PIPELINE_DEPTH", 64)
    capture = str(tmp_path / "drift.capture")
    chip_smoke.drift_capture(capture, 40, 22, shift_at=8)
    windows = {}
    real_fit = jretrain.fit_family

    def jax_fit(family, X, y, n_classes, **kw):
        windows["jax"] = (np.array(X), np.array(y))
        return real_fit(family, X, y, n_classes, **kw)

    def port_fit(family, X, y, n_classes, *, device=None, **kw):
        windows["port"] = (np.array(X), np.array(y))
        return interop.gnb_params_from_numpy(
            real_fit(family, X, y, n_classes, **kw), device=device)

    monkeypatch.setattr(jretrain, "fit_family", jax_fit)
    monkeypatch.setattr(tretrain, "fit_family", port_fit)
    monkeypatch.setattr(jretrain, "BackgroundRetrainer",
                        _sync_retrainer(jretrain))
    monkeypatch.setattr(tretrain, "BackgroundRetrainer",
                        _sync_retrainer(tretrain))
    argv = [
        "--source", "replay", "--capture", capture, "--capacity", "64",
        "--print-every", "1", "--idle-timeout", "0", "--table-rows", "16",
        *DRIFT_FLAGS, "--drift-parity", "0.5",
    ]
    jdir, tdir = _model_dirs(tmp_path, "gnb")
    want, want_err, _ = _serve(jcli.main, [
        "gaussiannb", "--native-checkpoint", jdir, *argv, "--pipeline",
        "off", "--drift-dir", str(tmp_path / "jd")])
    got, got_err, summary = _serve(tcli.main, [
        "gaussiannb", "--native-checkpoint", tdir, *argv, "--pipeline",
        pipeline, "--drift-dir", str(tmp_path / "td"), "--device", "cpu"])
    assert want.count("Flow ID") == 22
    _same(windows["jax"], windows["port"], "retrain window")
    assert _drift_lines(got_err) == _drift_lines(want_err)
    assert any("-> PROMOTED" in ln for ln in _drift_lines(got_err))
    assert summary.drift["promotions"] == 1 and summary.drift["swapped"]
    assert got == want


def _archive(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_serving_checkpoint_with_drift_and_openset_equals_jax(tmp_path):
    """``--save-serve-state`` after a calibrated drift monitor and an
    armed gate: the archives are equal entry for entry, the
    ``feature_reference/`` block (the monitor's reference and the gate's
    stats and threshold) included; a port serve restored from the JAX
    archive boots the gate ARMED at that threshold."""
    argv = [
        "--source", "synthetic", "--synthetic-flows", "40",
        "--capacity", "64", "--print-every", "1", "--max-ticks", "10",
        "--idle-timeout", "0", "--table-rows", "16", "--pipeline", "off",
        *DRIFT_FLAGS,
    ]
    jstate, tstate = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    (want, _, _), (got, _, summary) = _both(
        tmp_path, "gnb", argv + ["--save-serve-state", jstate],
        port_extra=("--save-serve-state", tstate))
    a, b = _archive(jstate), _archive(tstate)
    ref_keys = [k for k in a if k.startswith("feature_reference/")]
    assert {k.split("/", 1)[1] for k in ref_keys} >= {
        "mean", "std", "class_freq", "count", "class_mean", "class_std",
        "class_count", "openset_mean", "openset_inv_std",
        "openset_threshold", "openset_calibrated_rows"}
    assert a.keys() == b.keys(), set(a) ^ set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k
    _, tdir = _model_dirs(tmp_path / "again", "gnb")
    _, _, restored = _serve(tcli.main, [
        "gaussiannb", "--native-checkpoint", tdir, "--source", "synthetic",
        "--synthetic-flows", "40", "--capacity", "64", "--max-ticks", "1",
        "--print-every", "1", "--pipeline", "off", "--device", "cpu",
        "--restore-serve-state", jstate, *DRIFT_FLAGS,
        "--drift-dir", str(tmp_path / "rd")])
    assert restored.openset["state"] == "ARMED"
    assert restored.openset["threshold"] == summary.openset["threshold"]
    assert restored.drift["calibrated"]


def test_drift_flags_usage_errors_and_defaults():
    p = tcli._build_parser()
    args = p.parse_args(["gaussiannb"])
    assert (args.drift, args.drift_dir, args.drift_follow, args.drift_window,
            args.drift_threshold, args.drift_trips,
            args.drift_class_tolerance, args.drift_probe_successes,
            args.drift_parity, args.retrain_deadline, args.openset,
            args.openset_margin, args.openset_calibration_rows) == (
        "off", None, False, 8, 4.0, 3, 0.2, 3, 1.0, 300.0, "off", 3.0, 4096)
    jargs = jcli._build_parser().parse_args(["gaussiannb"])
    for k in ("drift", "drift_dir", "drift_follow", "drift_window",
              "drift_threshold", "drift_trips", "drift_class_tolerance",
              "drift_probe_successes", "drift_parity", "retrain_deadline",
              "openset", "openset_margin", "openset_calibration_rows"):
        assert getattr(args, k) == getattr(jargs, k), k
    with pytest.raises(SystemExit, match="drift-dir"):
        tcli.main(["gaussiannb", "--native-checkpoint", "x", "--drift",
                   "auto", "--device", "cpu"])
    with pytest.raises(SystemExit, match="drift-follow needs"):
        tcli.main(["gaussiannb", "--native-checkpoint", "x",
                   "--drift-follow", "--device", "cpu"])
