"""The port's degradation ladder (``serving/degrade.py``) against the JAX
package's: the unit cases of the JAX ``tests/test_degrade.py``, each run
against both ladders (``impl``), the probe backoff schedule equal to
JAX's for the same seed, the port's torch specifics (the device call
includes the labels' copy to the host, on the caller's stream), the
host-mode label cache under the ladder, and the CLI with the ladder's
fault sites armed against the JAX CLI with the same plan.

Tolerances: none — labels, schedules and stdout are compared exactly.
"""

import contextlib
import io
import random
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke
from traffic_classifier_sdn_tpu import cli as jcli
from traffic_classifier_sdn_tpu import models as jmodels
from traffic_classifier_sdn_tpu.serving import degrade as jdegrade
from traffic_classifier_sdn_tpu.utils import faults as jfaults
from traffic_classifier_sdn_tpu.utils.metrics import Metrics
from traffic_classifier_sdn_tpu_torch import cli as tcli
from traffic_classifier_sdn_tpu_torch import models as tmodels
from traffic_classifier_sdn_tpu_torch.ingest.batcher import FlowStateEngine
from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows
from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk
from traffic_classifier_sdn_tpu_torch.serving import degrade as tdegrade
from traffic_classifier_sdn_tpu_torch.serving.incremental import (
    IncrementalLabels,
)
from traffic_classifier_sdn_tpu_torch.utils import faults as tfaults
from torch_witnesses import _torch_locktrace_witness, _torch_syncguard_witness  # noqa: F401 — the lock witness and the sync witness ride this suite

IMPLS = {"jax": jdegrade, "port": tdegrade}


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


class _Fallback:
    def __init__(self, fn, kind="test-fallback"):
        self._fn = fn
        self.kind = kind
        self.calls = 0
        self.scores = None

    def predict(self, X):
        self.calls += 1
        return self._fn(X)


def _labels(value, n=8):
    return np.full(n, value, np.int32)


def _ladder(impl, device, fallback=None, **kw):
    kw.setdefault("deadline", 0.2)
    kw.setdefault("first_deadline", 0.2)
    kw.setdefault("probe_every", 1.0)
    kw.setdefault("probe_successes", 2)
    kw.setdefault("rng", random.Random(0))
    if impl == "port":
        kw.pop("metrics", None)
    return IMPLS[impl].DegradeLadder(device, fallback, **kw)


def _probe_failures(lad, impl, metrics) -> int:
    if impl == "port":
        return lad.status()["probe_failures"]
    return metrics.counters.get("probe_failures", 0)


X8 = np.zeros((8, 12), np.float32)
both = pytest.mark.parametrize("impl", sorted(IMPLS))


# ---------------------------------------------------------------------------
# DeviceWatchdog
# ---------------------------------------------------------------------------


@both
def test_watchdog_runs_and_returns(impl):
    wd = IMPLS[impl].DeviceWatchdog()
    try:
        assert wd.call(lambda: 42, deadline=5.0) == 42
        assert wd.abandoned == 0
    finally:
        wd.close()


@both
def test_watchdog_propagates_exception(impl):
    wd = IMPLS[impl].DeviceWatchdog()
    try:
        boom = ValueError("device died")
        with pytest.raises(ValueError) as ei:
            wd.call(lambda: (_ for _ in ()).throw(boom), deadline=5.0)
        assert ei.value is boom
    finally:
        wd.close()


@both
def test_watchdog_abandons_wedged_call_within_budget(impl):
    wedge = threading.Event()
    mod = IMPLS[impl]
    wd = mod.DeviceWatchdog()
    try:
        t0 = time.monotonic()
        with pytest.raises(mod.DeadlineExceeded):
            wd.call(lambda: wedge.wait(timeout=30), deadline=0.2)
        assert time.monotonic() - t0 < 0.4  # 2x the deadline
        assert wd.abandoned == 1
        assert wd.call(lambda: "alive", deadline=5.0) == "alive"
    finally:
        wedge.set()
        wd.close()


@both
def test_watchdog_discards_late_result_from_abandoned_worker(impl):
    release = threading.Event()
    done = threading.Event()
    mod = IMPLS[impl]
    wd = mod.DeviceWatchdog()
    try:
        def slow():
            release.wait(timeout=30)
            done.set()
            return "late"

        with pytest.raises(mod.DeadlineExceeded):
            wd.call(slow, deadline=0.1)
        release.set()
        assert done.wait(timeout=5)
        assert wd.call(lambda: "fresh", deadline=5.0) == "fresh"
    finally:
        release.set()
        wd.close()


@both
def test_boot_wedged_device_pays_grace_once_not_per_probe(impl):
    wedge = threading.Event()

    def wedged(p, X):
        wedge.wait(timeout=30)
        return _labels(9)

    clock = [0.0]
    lad = _ladder(impl, wedged, _Fallback(lambda X: _labels(5)),
                  deadline=0.05, first_deadline=0.4, probe_every=1.0,
                  clock=lambda: clock[0])
    try:
        t0 = time.monotonic()
        lad(None, X8)
        assert time.monotonic() - t0 >= 0.35
        assert lad.state == IMPLS[impl].DEGRADED
        clock[0] = lad._next_probe_at + 0.01
        t0 = time.monotonic()
        lad(None, X8)
        assert time.monotonic() - t0 < 0.3
        assert lad.status()["probe_successes"] == 0
    finally:
        wedge.set()
        lad.close()


# ---------------------------------------------------------------------------
# Ladder: trip, fallback, stale
# ---------------------------------------------------------------------------


@both
def test_healthy_passthrough_is_the_device_labels(impl):
    lad = _ladder(impl, lambda p, X: _labels(3))
    try:
        np.testing.assert_array_equal(lad(None, X8), _labels(3))
        assert lad.state == "HEALTHY" and not lad.render_stale
    finally:
        lad.close()


@both
def test_real_stall_demotes_and_tick_stays_within_budget(impl):
    wedge = threading.Event()

    def wedged(p, X):
        wedge.wait(timeout=30)
        return _labels(9)

    lad = _ladder(impl, wedged, _Fallback(lambda X: _labels(5)))
    try:
        t0 = time.monotonic()
        out = lad(None, X8)
        assert time.monotonic() - t0 < 0.4
        np.testing.assert_array_equal(out, _labels(5))
        assert lad.state == "DEGRADED" and not lad.render_stale
    finally:
        wedge.set()
        lad.close()


@both
def test_error_trip_demotes(impl):
    def err(p, X):
        raise RuntimeError("device error")

    lad = _ladder(impl, err, _Fallback(lambda X: _labels(5)))
    try:
        np.testing.assert_array_equal(lad(None, X8), _labels(5))
        assert lad.state == "DEGRADED"
    finally:
        lad.close()


@both
def test_fallback_failure_goes_broken_serves_stale_then_recovers(impl):
    calls = {"n": 0}

    def flaky_fallback(X):
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError("fallback lib unloadable")
        return _labels(5)

    def err(p, X):
        raise RuntimeError("device down")

    clock = [100.0]
    lad = _ladder(impl, err, _Fallback(flaky_fallback),
                  clock=lambda: clock[0])
    try:
        np.testing.assert_array_equal(lad(None, X8), _labels(5))
        assert lad.state == "DEGRADED"
        np.testing.assert_array_equal(lad(None, X8), _labels(5))
        assert lad.state == "BROKEN" and lad.render_stale
        np.testing.assert_array_equal(lad(None, X8), _labels(5))
        assert lad.state == "DEGRADED" and not lad.render_stale
    finally:
        lad.close()


@both
def test_broken_with_no_fallback_serves_zeros_before_first_labels(impl):
    def err(p, X):
        raise RuntimeError("device down")

    lad = _ladder(impl, err, None)
    try:
        out = lad(None, X8)
        assert lad.state == "BROKEN" and lad.render_stale
        np.testing.assert_array_equal(out, np.zeros(8, np.int32))
    finally:
        lad.close()


@both
def test_fallback_breaking_mid_probe_chain_is_recorded(impl):
    clock = [0.0]
    calls = {"n": 0}

    def device(p, X):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("trip")
        return _labels(3, int(X.shape[0]))

    fb_calls = {"n": 0}

    def flaky_fb(X):
        fb_calls["n"] += 1
        if fb_calls["n"] >= 3:
            raise OSError("fallback died mid-chain")
        return _labels(3, int(X.shape[0]))

    kw = {}
    if impl == "jax":
        from traffic_classifier_sdn_tpu.obs import FlightRecorder

        kw["recorder"] = rec = FlightRecorder()
    lad = _ladder(impl, device, _Fallback(flaky_fb), probe_every=0.5,
                  probe_successes=3, clock=lambda: clock[0], **kw)
    try:
        lad(None, X8)
        clock[0] = lad._next_probe_at + 0.01
        lad(None, X8)
        assert lad.state == "PROBING"
        clock[0] = lad._next_probe_at + 0.01
        lad(None, X8)
        assert lad.status()["rung"] == "BROKEN" and lad.render_stale
        if impl == "jax":
            edges = [(e.get("frm"), e.get("to")) for e in rec.tail()
                     if e["kind"] == "degrade.transition"]
        else:
            edges = [(a, b) for a, b, _ in lad.transitions]
        assert ("DEGRADED", "BROKEN") in edges
    finally:
        lad.close()


@both
def test_wedged_feature_fetch_goes_broken_and_is_backoff_gated(impl):
    wedge = threading.Event()

    class WedgedX:
        shape = (8, 12)

        def __getitem__(self, item):
            return self

        def __array__(self, dtype=None, copy=None):
            wedge.wait(timeout=30)
            return np.zeros(self.shape, np.float32)

    def err(p, X):
        raise RuntimeError("device down")

    clock = [0.0]
    lad = _ladder(impl, err, _Fallback(lambda X: _labels(5, 8)),
                  deadline=0.1, first_deadline=0.1, probe_every=5.0,
                  clock=lambda: clock[0])
    try:
        X = WedgedX()
        t0 = time.monotonic()
        out = lad(None, X)
        assert time.monotonic() - t0 < 0.5
        assert lad.status()["rung"] == "BROKEN" and lad.render_stale
        np.testing.assert_array_equal(out, np.zeros(8, np.int32))
        t0 = time.monotonic()
        lad(None, X)
        assert time.monotonic() - t0 < 0.05
    finally:
        wedge.set()
        lad.close()


# ---------------------------------------------------------------------------
# Probing, backoff, promotion
# ---------------------------------------------------------------------------


class _ScriptedDevice:
    """'ok' returns labels, 'err' raises."""

    def __init__(self, script, labels_value=3):
        self.script = list(script)
        self.labels_value = labels_value
        self.calls = 0

    def __call__(self, p, X):
        self.calls += 1
        step = self.script.pop(0) if self.script else "ok"
        if step == "err":
            raise RuntimeError("still sick")
        return np.full(int(X.shape[0]), self.labels_value, np.int32)


def _schedule(impl, seed: int, script) -> list:
    """(state, probe successes, next probe time) after each tick of a
    scripted device, the clock stepped just past each probe."""
    clock = [1000.0]
    lad = _ladder(impl, _ScriptedDevice(script),
                  _Fallback(lambda X: _labels(3)), probe_every=0.5,
                  probe_successes=2, backoff_cap=64.0,
                  clock=lambda: clock[0], rng=random.Random(seed))
    out = []
    try:
        for _ in range(len(script) + 3):
            lad(None, X8)
            out.append((lad.state, lad.status()["probe_successes"],
                        lad.status()["backoff_level"], lad._next_probe_at))
            clock[0] = max(clock[0], lad._next_probe_at) + 0.01
    finally:
        lad.close()
    return out


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_probe_backoff_schedule_equals_jax(seed):
    """The port's jittered schedule is JAX's, draw for draw."""
    script = ["err", "err", "ok", "err", "err", "ok", "ok", "err"]
    assert _schedule("port", seed, script) == _schedule("jax", seed, script)


@both
def test_probe_backoff_schedule_exact_with_injected_clock_and_rng(impl):
    clock = [1000.0]
    seed = 7
    dev = _ScriptedDevice(["err", "err", "ok", "err"])
    lad = _ladder(impl, dev, _Fallback(lambda X: _labels(3)),
                  probe_every=0.5, probe_successes=2, backoff_cap=64.0,
                  clock=lambda: clock[0], rng=random.Random(seed))
    try:
        lad(None, X8)
        assert lad.state == "DEGRADED" and lad._next_probe_at == 1000.5
        expected_rng = random.Random(seed)
        clock[0] = 1000.6
        lad(None, X8)
        d1 = expected_rng.uniform(0.0, min(64.0, 0.5 * 2.0))
        assert lad._next_probe_at == pytest.approx(1000.6 + d1)
        assert lad.status()["probe_successes"] == 0
        clock[0] = lad._next_probe_at + 0.01
        t_probe2 = clock[0]
        lad(None, X8)
        assert lad.state == "PROBING"
        assert lad.status()["probe_successes"] == 1
        assert lad._next_probe_at == pytest.approx(t_probe2 + 0.5)
        clock[0] = lad._next_probe_at + 0.01
        lad(None, X8)
        assert lad.status()["probe_successes"] == 0
        d2 = expected_rng.uniform(0.0, min(64.0, 0.5 * 4.0))
        assert lad._next_probe_at == pytest.approx(clock[0] + d2)
        assert lad.state == "DEGRADED"
    finally:
        lad.close()


@both
def test_promotion_after_n_consecutive_clean_probes(impl):
    clock = [0.0]
    m = Metrics()
    lad = _ladder(impl, _ScriptedDevice(["err"]),
                  _Fallback(lambda X: _labels(3)), probe_every=0.5,
                  probe_successes=3, clock=lambda: clock[0], metrics=m)
    try:
        lad(None, X8)
        for _ in range(3):
            clock[0] = lad._next_probe_at + 0.01
            lad(None, X8)
        assert lad.state == "HEALTHY" and lad.status()["gauge"] == 0
        np.testing.assert_array_equal(lad(None, X8), _labels(3))
    finally:
        lad.close()


@both
def test_parity_mismatching_probe_counts_as_failed(impl):
    clock = [0.0]
    m = Metrics()
    lad = _ladder(impl, _ScriptedDevice(["err"], labels_value=9),
                  _Fallback(lambda X: _labels(3)), probe_every=0.5,
                  probe_successes=1, clock=lambda: clock[0], metrics=m)
    try:
        lad(None, X8)
        for _ in range(3):
            clock[0] = lad._next_probe_at + 0.01
            lad(None, X8)
        assert lad.state == "DEGRADED"
        assert _probe_failures(lad, impl, m) >= 3
    finally:
        lad.close()


@both
def test_probe_from_broken_needs_no_parity_reference(impl):
    clock = [0.0]
    lad = _ladder(impl, _ScriptedDevice(["err"]), None, probe_every=0.5,
                  probe_successes=1, clock=lambda: clock[0])
    try:
        lad(None, X8)
        assert lad.state == "BROKEN"
        clock[0] = lad._next_probe_at + 0.01
        lad(None, X8)
        assert lad.state == "HEALTHY"
    finally:
        lad.close()


@pytest.mark.chaos
@pytest.mark.parametrize("site", ["degrade.dispatch_error",
                                  "degrade.dispatch_stall"])
def test_fault_sites_demote_like_jax(site):
    """An armed device-path site is absorbed: both ladders demote with the
    same reason and serve the fallback's labels; ``degrade.probe`` fails
    the first probe."""
    got = {}
    for impl, faults in (("jax", jfaults), ("port", tfaults)):
        clock = [0.0]
        lad = _ladder(impl, lambda p, X: _labels(3),
                      _Fallback(lambda X: _labels(3)), probe_every=0.5,
                      probe_successes=1, clock=lambda: clock[0])
        plan = faults.FaultPlan([faults.FaultRule(site, times=1),
                                 faults.FaultRule("degrade.probe", times=1)])
        try:
            with faults.installed(plan):
                steps = [lad(None, X8).tolist()]
                states = [lad.state]
                for _ in range(2):
                    clock[0] = lad._next_probe_at + 0.01
                    steps.append(lad(None, X8).tolist())
                    states.append(lad.state)
            got[impl] = (steps, states, lad.status()["backoff_level"])
        finally:
            lad.close()
    assert got["port"] == got["jax"]
    assert got["port"][1] == ["DEGRADED", "DEGRADED", "HEALTHY"]


# ---------------------------------------------------------------------------
# Port specifics
# ---------------------------------------------------------------------------


def test_device_call_returns_host_labels_and_counts():
    """A tensor from the device predict comes back as host numpy labels
    (the copy waits for the kernel, inside the deadline); the ladder
    counts device and fallback calls and records its transitions."""
    calls = []

    def device(p, X):
        calls.append(X)
        return torch.full((X.shape[0],), 4, dtype=torch.int32)

    lad = tdegrade.DegradeLadder(device, _Fallback(lambda X: _labels(4, 5)))
    try:
        X = torch.zeros((5, 12))
        out = lad(None, X)
        assert isinstance(out, np.ndarray) and out.tolist() == [4] * 5
        assert calls[0] is X
        st = lad.status()
        assert st["device_calls"] == 1 and st["fallback_calls"] == 0
        assert st["fallback"] == "test-fallback" and lad.transitions == []
        assert lad.warm_fallback(np.zeros((8, 12), np.float32))
    finally:
        lad.close()


def test_fallback_gets_host_features_from_a_tensor():
    seen = []

    def err(p, X):
        raise RuntimeError("device down")

    def fb(X):
        seen.append(X)
        return _labels(2, X.shape[0])

    lad = tdegrade.DegradeLadder(err, _Fallback(fb), probe_every=60.0)
    try:
        X = torch.arange(24, dtype=torch.float32).reshape(2, 12)
        assert lad(None, X).tolist() == [2, 2]
        assert isinstance(seen[0], np.ndarray)
        np.testing.assert_array_equal(seen[0], X.numpy())
        assert lad.transitions == [("HEALTHY", "DEGRADED",
                                    "error:RuntimeError")]
        assert lad.status()["fallback_calls"] == 1
    finally:
        lad.close()


@pytest.mark.parametrize("where", ["predict", "probe", "fetch"])
def test_card_errors_raise_instead_of_demoting(where):
    """With ``raise_device_errors`` (the default on a CUDA tensor) a device
    error that is neither injected nor a missed deadline ends the call:
    from the HEALTHY predict, from a probe, and from the feature fetch of
    a demoted tick. An armed ``degrade.dispatch_error`` still demotes."""
    def device(p, X):
        raise RuntimeError("CUDA error: unspecified launch failure")

    class _BadX:
        shape = (8, 12)

        def cpu(self):
            raise RuntimeError("CUDA error: unspecified launch failure")

    clock = [0.0]
    lad = tdegrade.DegradeLadder(
        device, _Fallback(lambda X: _labels(3)), deadline=0.5,
        first_deadline=0.5, probe_every=1.0, probe_successes=1,
        clock=lambda: clock[0], rng=random.Random(0),
        raise_device_errors=True)
    try:
        if where == "predict":
            with pytest.raises(RuntimeError, match="launch failure"):
                lad(None, X8)
            assert lad.state == "HEALTHY" and lad.transitions == []
            return
        plan = tfaults.FaultPlan([tfaults.FaultRule("degrade.dispatch_error",
                                                    times=1)])
        with tfaults.installed(plan):
            assert lad(None, X8).tolist() == [3] * 8
        assert lad.transitions == [("HEALTHY", "DEGRADED",
                                    "error:FaultInjected")]
        if where == "probe":
            clock[0] = lad._next_probe_at + 0.01
            with pytest.raises(RuntimeError, match="launch failure"):
                lad(None, X8)
        else:
            with mock.patch.object(tdegrade, "host_array",
                                   lambda x: x.cpu()):
                with pytest.raises(RuntimeError, match="launch failure"):
                    lad(None, _BadX())
        assert lad.status()["rung"] == "DEGRADED"
    finally:
        lad.close()


@pytest.mark.parametrize("raise_errors,want", [(None, False), (True, True),
                                               (False, False)])
def test_raise_device_errors_default_follows_the_tensor(raise_errors, want):
    """None decides by the features: a CPU tensor or a numpy array is off
    the card, so the ladder absorbs the error as the JAX ladder does."""
    lad = tdegrade.DegradeLadder(lambda p, X: _labels(1),
                                 raise_device_errors=raise_errors)
    try:
        for X in (X8, torch.zeros((8, 12))):
            assert lad._absorbs(RuntimeError("x"), X) is not want
            assert lad._absorbs(tfaults.FaultInjected("x", 1), X)
    finally:
        lad.close()


def _forest_serving(capacity=128):
    syn = SyntheticFlows(n_flows=capacity - 8, seed=3, churn=0.2)
    eng = FlowStateEngine(capacity, device="cpu", track_dirty=True)
    for _ in range(2):
        eng.ingest(syn.tick())
        eng.step()
    d = chip_smoke.random_forest(0, eng.features().numpy(), n_trees=8)
    k = fk.compile_forest(d, n_features=12, device="cpu")
    return syn, eng, d, k


def test_host_mode_label_cache_equals_full_predict_through_the_ladder():
    """Under the ladder the label cache runs in host mode: each tick's
    labels equal a full-table predict, through demotion (the native
    rung), BROKEN (no commit, the tried rows marked again) and
    re-promotion."""
    syn, eng, d, k = _forest_serving()
    nf = tmodels.resolve_fallback(
        "forest", tmodels.forest.ForestModel.from_numpy(
            dict(d, max_depth=d["max_depth"]), device="cpu"))
    clock = [0.0]
    broken = {"on": False}

    class Fallback:
        kind = "native-forest"
        scores = None

        def predict(self, X):
            if broken["on"]:
                raise OSError("rung down")
            return nf.predict(X)

    lad = tdegrade.DegradeLadder(fk.predict, Fallback(), probe_every=0.5,
                                 probe_successes=1, clock=lambda: clock[0])
    inc = IncrementalLabels(eng, lad, k, degrade=lad)
    assert inc.host_native and inc.status()["mode"] == "host"
    plan = [None, "dispatch_error", None, "broken", None, None]
    try:
        for step in plan:
            eng.mark_tick()
            eng.ingest(syn.tick())
            eng.step()
            broken["on"] = step == "broken"
            rules = ([tfaults.FaultRule("degrade.dispatch_error", times=99)]
                     if step in ("dispatch_error", "broken") else [])
            with tfaults.installed(tfaults.FaultPlan(rules)):
                labels = inc.labels()
            want = fk.predict(k, eng.features()).numpy()
            if step == "broken":
                assert lad.render_stale and lad.state == "BROKEN"
            else:
                np.testing.assert_array_equal(labels, want)
            clock[0] += 1.0
        assert lad.state == "HEALTHY"
        kinds = [t[1] for t in lad.transitions]
        assert "DEGRADED" in kinds and "BROKEN" in kinds
        assert inc.status()["invalidations"] >= 2
    finally:
        lad.close()


# ---------------------------------------------------------------------------
# CLI drills against the JAX CLI
# ---------------------------------------------------------------------------


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv)
    return out.getvalue(), [ln for ln in err.getvalue().splitlines()
                            if ln.startswith("DEGRADE")]


FAMILIES = ("Randomforest", "knearest", "svm")


def _checkpoints(tmp_path, sub):
    from test_torch_incremental import _capture_and_sample, _checkpoints

    capture, X = _capture_and_sample(tmp_path)
    jdir, tdir = _checkpoints(tmp_path, sub, X)
    return capture, jdir, tdir


@pytest.mark.chaos
@pytest.mark.parametrize("pipeline", ["off", "auto"])
@pytest.mark.parametrize("sub", FAMILIES)
def test_armed_dispatch_error_demotes_and_repromotes_like_jax(
        tmp_path, monkeypatch, sub, pipeline):
    """``degrade.dispatch_error`` armed on the second and third device
    calls: both serves demote, render the fallback's labels, re-promote
    after ``--probe-successes`` clean probes, and print the same tables
    and the same transitions as the JAX serial serve (the port pipelined
    at a depth no render can outrun)."""
    monkeypatch.delenv("TCSDN_KNN_TOPK", raising=False)
    monkeypatch.delenv("TCSDN_SVC_KERNEL", raising=False)
    monkeypatch.setattr(tcli, "PIPELINE_DEPTH", 64)
    capture, jdir, tdir = _checkpoints(tmp_path, sub)
    common = [sub, "--source", "replay", "--capture", capture,
              "--capacity", "48", "--print-every", "1", "--table-rows", "16",
              "--probe-every", "0", "--probe-successes", "2"]
    with jfaults.installed(jfaults.FaultPlan([jfaults.FaultRule(
            "degrade.dispatch_error", after=1, times=2)])):
        want, want_edges = _run(jcli.main, common + [
            "--native-checkpoint", jdir, "--pipeline", "off"])
    with tfaults.installed(tfaults.FaultPlan([tfaults.FaultRule(
            "degrade.dispatch_error", after=1, times=2)])):
        got, got_edges = _run(tcli.main, common + [
            "--native-checkpoint", tdir, "--device", "cpu",
            "--pipeline", pipeline])
    assert want.count("Flow ID") == 6
    assert got == want
    assert got_edges == want_edges
    assert got_edges[0].startswith("DEGRADE: HEALTHY -> DEGRADED")
    assert got_edges[-1].startswith("DEGRADE: PROBING -> HEALTHY")


@pytest.mark.parametrize("table_rows", ["16", "0"])
def test_broken_rung_renders_stale_column_like_jax(tmp_path, monkeypatch,
                                                   table_rows):
    """No fallback (forced for both packages) and every device call after
    the first failing: the ladder goes BROKEN and each later table carries
    ``Label State = STALE`` over the last good labels, as JAX renders it."""
    monkeypatch.setattr(tcli, "PIPELINE_DEPTH", 64)
    monkeypatch.setattr(jmodels, "resolve_fallback", lambda *a: None)
    monkeypatch.setattr(tmodels, "resolve_fallback", lambda *a: None)
    capture, jdir, tdir = _checkpoints(tmp_path, "Randomforest")
    common = ["Randomforest", "--source", "replay", "--capture", capture,
              "--capacity", "48", "--print-every", "1", "--table-rows",
              table_rows, "--probe-every", "60"]
    with jfaults.installed(jfaults.FaultPlan([jfaults.FaultRule(
            "degrade.dispatch_error", after=1, times=None)])):
        want, want_edges = _run(jcli.main, common + [
            "--native-checkpoint", jdir, "--pipeline", "off"])
    runs = {}
    for pipeline in ("off", "auto"):
        with tfaults.installed(tfaults.FaultPlan([tfaults.FaultRule(
                "degrade.dispatch_error", after=1, times=None)])):
            runs[pipeline] = _run(tcli.main, common + [
                "--native-checkpoint", tdir, "--device", "cpu",
                "--pipeline", pipeline])
    assert want.count("STALE") > 0 and want.count("Label State") == 5
    for got, edges in runs.values():
        assert got == want
        assert edges == want_edges == [
            "DEGRADE: HEALTHY -> DEGRADED (error:FaultInjected)",
            "DEGRADE: DEGRADED -> BROKEN (no-fallback)"]
