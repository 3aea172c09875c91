"""The port's locktrace runtime witness
(``traffic_classifier_sdn_tpu_torch/utils/locktrace.py``), the
counterpart of tests/test_locktrace.py.

Covers: online cycle detection with an injected deterministic schedule
(no sleeps — interleavings are pinned by joins, and detection is
lockdep-style so no actual deadlock has to manifest), the
condition-wait exemption, the static/dynamic agreement contract (ONE
AB/BA source is flagged by the port's static ``lock-order`` rule AND
trips the runtime witness; removing either nesting makes BOTH pass),
the static-graph cross-check, the committed
``docs/artifacts/torch_lock_order_graph.json``'s currency, the CLI env
hook, the same schedules through JAX's witness and the port's giving
the same violations, and both packages' witnesses armed in one
process, nesting last in first out.
"""

from __future__ import annotations

import json
import os
import threading

import pytest

from traffic_classifier_sdn_tpu.utils import locktrace as jlocktrace
from traffic_classifier_sdn_tpu_torch.analysis_static import lint_paths
from traffic_classifier_sdn_tpu_torch.analysis_static.framework import (
    LintRunner,
    collect_modules,
)
from traffic_classifier_sdn_tpu_torch.analysis_static.graftlock import (
    build_graph_report,
)
from traffic_classifier_sdn_tpu_torch.analysis_static.rules import (
    LockOrderRule,
)
from traffic_classifier_sdn_tpu_torch.utils import locktrace

PACKAGE_DIR = os.path.dirname(
    os.path.dirname(os.path.abspath(lint_paths.__code__.co_filename))
)
REPO_ROOT = os.path.dirname(PACKAGE_DIR)

# The AB/BA deadlock fixture, shared verbatim between the static rule
# run and the runtime execution.
ABBA_SRC = """
import threading

class Pair:
    def __init__(self):
        self._a_lock = threading.Lock()
        self._b_lock = threading.Lock()

    def fwd(self):
        with self._a_lock:
            with self._b_lock:
                return 1

    def rev(self):
        with self._b_lock:
            with self._a_lock:
                return 2
"""

ABBA_FWD_FLAT = ABBA_SRC.replace(
    "with self._a_lock:\n            with self._b_lock:\n"
    "                return 1",
    "with self._a_lock:\n            return 1",
)
ABBA_REV_FLAT = ABBA_SRC.replace(
    "with self._b_lock:\n            with self._a_lock:\n"
    "                return 2",
    "with self._b_lock:\n            return 2",
)

COND_SRC = """
import threading

class Stage:
    def __init__(self):
        self._lock = threading.Condition()
        self._go_lock = threading.Lock()
        self.ready = False

    def park(self):
        with self._lock:
            while not self.ready:
                self._lock.wait()

    def release(self):
        with self._go_lock:
            with self._lock:
                self.ready = True
                self._lock.notify_all()
"""


@pytest.fixture(scope="module")
def port_modules():
    """One parse of the port tree for the module's graph tests."""
    modules, errs = collect_modules([PACKAGE_DIR], relative_to=REPO_ROOT)
    assert errs == []
    return modules


def _run_two_threads(pair) -> None:
    t1 = threading.Thread(target=pair.fwd)
    t1.start()
    t1.join()
    t2 = threading.Thread(target=pair.rev)
    t2.start()
    t2.join()


def _exec_fixture(tmp_path, src: str, name: str = "abba_fixture.py"):
    path = tmp_path / name
    path.write_text(src, encoding="utf-8")
    ns: dict = {}
    exec(compile(src, str(path), "exec"), ns)  # noqa: S102 — test fixture
    return path, ns


# ---------------------------------------------------------------------------
# online cycle detection
# ---------------------------------------------------------------------------


def test_witness_catches_abba_and_static_rule_agrees(tmp_path):
    path, ns = _exec_fixture(tmp_path, ABBA_SRC)
    static = LintRunner([LockOrderRule()]).run([str(path)])
    assert len(static) == 1 and static[0].rule == "lock-order"
    scope = lambda f: f == str(path)  # noqa: E731
    with locktrace.tracing(scope=scope) as w:
        _run_two_threads(ns["Pair"]())
    assert len(w.violations) == 1
    v = w.violations[0]
    sites = set(v["edge"]) | set(v["conflict_path"])
    assert all(str(path) in s for s in sites)


@pytest.mark.parametrize("flat", [ABBA_FWD_FLAT, ABBA_REV_FLAT],
                         ids=["fwd-flat", "rev-flat"])
def test_removing_either_edge_passes_both(tmp_path, flat):
    path, ns = _exec_fixture(tmp_path, flat, "flat.py")
    assert LintRunner([LockOrderRule()]).run([str(path)]) == []
    scope = lambda f, p=str(path): f == p  # noqa: E731
    with locktrace.tracing(scope=scope) as w:
        _run_two_threads(ns["Pair"]())
    assert w.violations == []


def test_witness_detects_without_interleaving_single_thread(tmp_path):
    path, ns = _exec_fixture(tmp_path, ABBA_SRC)
    scope = lambda f: f == str(path)  # noqa: E731
    with locktrace.tracing(scope=scope) as w:
        pair = ns["Pair"]()
        pair.fwd()
        pair.rev()
    assert len(w.violations) == 1


def _injected_schedule(mod):
    """Two logical threads through the bare witness API of ``mod``:
    a→b, then b→a (the closing acquisition is checked online)."""
    w = mod.LockWitness()
    seen: list = []

    def t1():
        w.note_acquire("a.py:1")
        w.note_acquire("b.py:2")
        w.note_release("b.py:2")
        w.note_release("a.py:1")

    def t2():
        w.note_acquire("b.py:2")
        w.note_acquire("a.py:1")
        seen.append(len(w.violations))
        w.note_release("a.py:1")
        w.note_release("b.py:2")

    for fn in (t1, t2):
        t = threading.Thread(target=fn, name=f"sched-{fn.__name__}")
        t.start()
        t.join()
    return w, seen


def test_witness_injected_schedule_no_threads():
    w, seen = _injected_schedule(locktrace)
    assert seen == [1]
    assert w.violations[0]["edge"] == ["b.py:2", "a.py:1"]


@pytest.mark.parametrize("schedule", ["abba", "fwd-flat", "cond"])
def test_same_schedule_same_violations_as_jax(tmp_path, schedule):
    """One lock schedule through JAX's witness and the port's: the same
    edges and the same violations (site for site)."""
    if schedule == "abba":
        src, run = ABBA_SRC, lambda ns: _run_two_threads(ns["Pair"]())
    elif schedule == "fwd-flat":
        src, run = ABBA_FWD_FLAT, lambda ns: _run_two_threads(ns["Pair"]())
    else:
        def run(ns):
            stage = ns["Stage"]()
            t = threading.Thread(target=stage.park)
            t.start()
            stage.release()
            t.join()
        src = COND_SRC
    out = {}
    for name, mod in (("jax", jlocktrace), ("port", locktrace)):
        path, ns = _exec_fixture(tmp_path, src, f"{schedule}.py")
        scope = lambda f, p=str(path): f == p  # noqa: E731
        with mod.tracing(scope=scope) as w:
            run(ns)
        out[name] = (w.edges(), [
            (v["edge"], v["conflict_path"]) for v in w.violations
        ])
    assert out["port"] == out["jax"]
    w_port, seen_port = _injected_schedule(locktrace)
    w_jax, seen_jax = _injected_schedule(jlocktrace)
    assert seen_port == seen_jax
    assert w_port.violations == w_jax.violations


def test_witness_condition_wait_releases_its_lock(tmp_path):
    path, ns = _exec_fixture(tmp_path, COND_SRC, "cond_fixture.py")
    scope = lambda f: f == str(path)  # noqa: E731
    with locktrace.tracing(scope=scope) as w:
        stage = ns["Stage"]()
        t = threading.Thread(target=stage.park)
        t.start()
        stage.release()
        t.join()
    assert w.violations == []
    assert len(w.edges()) == 1


def test_witness_same_order_clean(tmp_path):
    path, ns = _exec_fixture(tmp_path, ABBA_SRC, "consistent.py")
    scope = lambda f: f == str(path)  # noqa: E731
    with locktrace.tracing(scope=scope) as w:
        pair = ns["Pair"]()
        pair.fwd()
        pair.fwd()
    assert w.violations == []
    assert len(w.edges()) == 1


# ---------------------------------------------------------------------------
# scope, stdlib hygiene, and nesting
# ---------------------------------------------------------------------------


def test_stdlib_locks_stay_real():
    import queue

    with locktrace.tracing(scope=lambda f: False):
        q = queue.Queue()
        assert not isinstance(q.mutex, locktrace.TracedLock)
        lock = threading.Lock()
        assert not isinstance(lock, locktrace.TracedLock)


def test_port_locks_get_wrapped_under_default_scope():
    from traffic_classifier_sdn_tpu.obs.flight_recorder import (
        FlightRecorder as JFlightRecorder,
    )
    from traffic_classifier_sdn_tpu_torch.obs.flight_recorder import (
        FlightRecorder,
    )

    with locktrace.tracing() as w:
        rec = FlightRecorder(capacity=4)
        assert isinstance(rec._lock, locktrace.TracedLock)
        # the JAX package's locks are outside the port's scope
        assert not isinstance(JFlightRecorder(capacity=4)._lock,
                              locktrace.TracedLock)
        rec.record("demo", x=1)
        assert rec.count() == 1
    assert w.violations == []
    rec.record("late", x=2)
    assert rec.count() == 2


def test_both_witnesses_nest_last_in_first_out():
    """JAX's witness armed first, the port's inside it (the order the
    fixtures arm them in): each wraps its own package's locks at their
    own construction sites, each ``_installed`` guard refuses only its
    own second install, and the LIFO uninstall restores the factories
    exactly."""
    from traffic_classifier_sdn_tpu.serving import pipeline as jpipeline
    from traffic_classifier_sdn_tpu_torch.serving import pipeline

    real_lock, real_cond = threading.Lock, threading.Condition
    with jlocktrace.tracing() as jw:
        jax_lock = threading.Lock
        with locktrace.tracing() as tw:
            with pytest.raises(RuntimeError):
                locktrace.install(locktrace.LockWitness())
            with pytest.raises(RuntimeError):
                jlocktrace.install(jlocktrace.LockWitness())
            port_h = pipeline.Handoff(depth=2)
            jax_h = jpipeline.Handoff(depth=2)
            assert isinstance(port_h._lock, locktrace.TracedCondition)
            assert isinstance(jax_h._lock, jlocktrace.TracedCondition)
            with port_h._lock, jax_h._lock:
                pass
        assert threading.Lock is jax_lock
        assert locktrace._installed is None and jlocktrace._installed is jw
    assert threading.Lock is real_lock
    assert threading.Condition is real_cond
    assert tw.report()["sites"] == [port_h._lock._site]
    assert port_h._lock._site.startswith(
        "traffic_classifier_sdn_tpu_torch/serving/pipeline.py:")
    assert jw.report()["sites"] == [jax_h._lock._site]
    assert "_torch" not in jax_h._lock._site


# ---------------------------------------------------------------------------
# static-graph cross-check
# ---------------------------------------------------------------------------


def test_cross_check_maps_sites_and_flags_unknown_edges():
    w = locktrace.LockWitness()

    def seq():
        w.note_acquire("pkg/a.py:10")
        w.note_acquire("pkg/b.py:20")
        w.note_release("pkg/b.py:20")
        w.note_release("pkg/a.py:10")

    t = threading.Thread(target=seq)
    t.start()
    t.join()
    graph = {
        "nodes": [
            {"id": "pkg/a.py::A._lock", "constructed_at": ["pkg/a.py:10"]},
            {"id": "pkg/b.py::B._lock", "constructed_at": ["pkg/b.py:20"]},
        ],
        "edges": [
            {"from": "pkg/a.py::A._lock", "to": "pkg/b.py::B._lock"},
        ],
    }
    report = w.check_against(graph)
    assert report["checked"]
    assert report["unknown_edges"] == []
    assert report["unmapped_sites"] == []
    graph["edges"] = []
    report = w.check_against(graph)
    assert len(report["unknown_edges"]) == 1
    assert report["unknown_edges"][0]["from"] == "pkg/a.py::A._lock"


def test_check_against_none_is_inert():
    w = locktrace.LockWitness()
    assert w.check_against(None) == {"unknown_edges": [],
                                     "unmapped_sites": [],
                                     "checked": False}


# ---------------------------------------------------------------------------
# the committed artifact
# ---------------------------------------------------------------------------


def test_lock_graph_artifact_is_current(port_modules):
    """docs/artifacts/torch_lock_order_graph.json must match a fresh
    build from the port's source. Regenerate from the repo root with:

        python -m traffic_classifier_sdn_tpu_torch.analysis_static \\
            --lock-graph docs/artifacts/torch_lock_order_graph.json
    """
    artifact_path = locktrace.DEFAULT_GRAPH_PATH
    assert os.path.exists(artifact_path)
    with open(artifact_path, encoding="utf-8") as f:
        committed = json.load(f)
    assert committed == build_graph_report(port_modules), (
        "docs/artifacts/torch_lock_order_graph.json is stale — "
        "regenerate it (see this test's docstring)"
    )


def test_port_graph_shape_and_known_edges(port_modules):
    report = build_graph_report(port_modules)
    assert report["cycles"] == []
    with open(os.path.join(REPO_ROOT, "docs", "artifacts",
                           "lock_order_graph.json"), encoding="utf-8") as f:
        jax_graph = json.load(f)
    assert set(report) == set(jax_graph)
    assert report["schema_version"] == jax_graph["schema_version"]
    edge_pairs = {(e["from"], e["to"]) for e in report["edges"]}
    assert any(
        "DegradeLadder._lock" in a and "DeviceWatchdog._lock" in b
        for a, b in edge_pairs
    ), edge_pairs
    node_ids = {n["id"] for n in report["nodes"]}
    for lock in ("serving_checkpoint.py::_rotation_lock()",
                 "pipeline.py::Handoff._lock",
                 "pipeline.py::ServePipeline._lock",
                 "drift.py::DriftController._lock",
                 "actuation.py::ActuationPlane._lock"):
        assert any(n.endswith(lock) for n in node_ids), lock
    # the actuation plane never holds its FSM lock across the socket:
    # no edge leaves it, and no blocking call runs under it
    assert not any("ActuationPlane._lock" in a for a, _ in edge_pairs)


def test_cli_env_flag_arms_witness_and_reports_clean(
    tmp_path, monkeypatch, capsys
):
    """``TCSDN_LOCKTRACE=1`` arms the witness for a real port CLI serve
    (replay source, in-process): the run completes, the witness
    uninstalls cleanly, no ordering violation is reported, and the
    report written through ``TCSDN_LOCKTRACE_OUT`` maps every observed
    site onto the committed static graph."""
    import numpy as np

    from traffic_classifier_sdn_tpu_torch import cli, interop
    from traffic_classifier_sdn_tpu_torch.ingest.protocol import format_line
    from traffic_classifier_sdn_tpu_torch.ingest.replay import (
        SyntheticFlows,
    )
    from traffic_classifier_sdn_tpu_torch.io.checkpoint import save_model

    capture = tmp_path / "capture.tsv"
    syn = SyntheticFlows(n_flows=8, seed=3)
    with open(capture, "wb") as f:
        f.write(b"header to ignore\n")
        for _ in range(8):
            for r in syn.tick():
                f.write(format_line(r))
    rng = np.random.RandomState(0)
    params = interop.gnb_params_from_numpy({
        "theta": rng.gamma(2.0, 100.0, (4, 12)),
        "var": rng.gamma(2.0, 50.0, (4, 12)) + 1.0,
        "class_prior": np.full(4, 0.25),
    }, device="cpu")
    ckpt = str(tmp_path / "gnb")
    save_model(ckpt, "gnb", params,
               classes=["dns", "ping", "telnet", "voice"])
    out = tmp_path / "locktrace.json"
    monkeypatch.setenv(locktrace.ENV_FLAG, "1")
    monkeypatch.setenv(locktrace.ENV_OUT, str(out))
    real_lock = threading.Lock
    cli.main([
        "gaussiannb", "--source", "replay", "--capture", str(capture),
        "--native-checkpoint", ckpt, "--capacity", "32",
        "--print-every", "4", "--max-ticks", "8", "--device", "cpu",
    ])
    assert locktrace._installed is None
    assert threading.Lock is real_lock
    assert "LOCKTRACE VIOLATION" not in capsys.readouterr().err
    report = json.loads(out.read_text())
    assert report["violations"] == []
    assert report["sites"]  # the serve's locks were traced
    assert report["cross_check"]["checked"]
    assert report["cross_check"]["unknown_edges"] == []


def test_cli_early_sysexit_unwinds_witness(monkeypatch):
    """A sys.exit inside the serve body after the witness installed
    must not leak the monkeypatched factories."""
    from traffic_classifier_sdn_tpu_torch import cli

    monkeypatch.setenv(locktrace.ENV_FLAG, "1")
    real_lock = threading.Lock
    with pytest.raises(SystemExit):
        cli.main(["gaussiannb", "--source", "synthetic", "--device", "cpu",
                  "--obs-dump-on-exit"])  # needs --obs-dir: exits
    assert locktrace._installed is None
    assert threading.Lock is real_lock


def test_finish_does_not_duplicate_live_recorded_violations():
    from traffic_classifier_sdn_tpu_torch.obs.flight_recorder import (
        FlightRecorder,
    )

    rec = FlightRecorder(capacity=64)
    w = locktrace.LockWitness(recorder=rec)

    def t1():
        w.note_acquire("x.py:1")
        w.note_acquire("y.py:2")
        w.note_acquire("z.py:3")
        for s in ("z.py:3", "y.py:2", "x.py:1"):
            w.note_release(s)

    def t2():
        w.note_acquire("z.py:3")
        w.note_acquire("y.py:2")
        w.note_acquire("x.py:1")
        for s in ("x.py:1", "y.py:2", "z.py:3"):
            w.note_release(s)

    for fn in (t1, t2):
        t = threading.Thread(target=fn)
        t.start()
        t.join()
    assert len(w.violations) == 3
    live = rec.count("locktrace.violation")
    assert live == len(w.violations)
    locktrace.finish(w, recorder=rec)
    assert rec.count("locktrace.violation") == live


def test_witness_maps_onto_static_graph_for_real_port_locks():
    graph = locktrace.load_static_graph()
    assert graph is not None
    from traffic_classifier_sdn_tpu_torch.serving.degrade import (
        DeviceWatchdog,
    )

    with locktrace.tracing() as w:
        wd = DeviceWatchdog()
        assert wd.call(lambda: 7, deadline=5.0) == 7
        wd.close()
    report = w.check_against(graph)
    assert report["checked"]
    assert not any("degrade.py" in s for s in report["unmapped_sites"]), (
        report["unmapped_sites"])
