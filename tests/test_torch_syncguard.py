"""The port's syncguard runtime witness
(``traffic_classifier_sdn_tpu_torch/utils/syncguard.py``), the
counterpart of tests/test_syncguard.py.

Covers: the counting shims on torch's seams (``np.asarray`` through
``Tensor.__array__``, ``.numpy()``/``.cpu()``/``.tolist()``/``.item()``,
the scalarizing dunders, iteration, ``.to`` moves, the host→device
converters), attribution to the nearest in-package call site (walking
through torch's own Python), out-of-scope frames left uncounted, exact
restoration of every patched attribute, the live allowlist check
(violation dedup + flight-recorder event), the CLI env hooks and report
file, the CUDA sync-debug arming (the card faked: these tests run on the
CPU), both packages' witnesses armed in one process, the committed budget
artifact's currency and shape — and the static/dynamic agreement
contract: ONE fixture is flagged by the port's static ``implicit-sync``
rule AND trips the runtime witness at the same site, and the reasoned
suppression silences both because it becomes the budget's allowlist
entry.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import textwrap
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traffic_classifier_sdn_tpu.utils import syncguard as jsyncguard
from traffic_classifier_sdn_tpu_torch.analysis_static import lint_paths
from traffic_classifier_sdn_tpu_torch.analysis_static.framework import (
    collect_modules,
)
from traffic_classifier_sdn_tpu_torch.analysis_static.graftsync import (
    build_sync_report,
)
from traffic_classifier_sdn_tpu_torch.obs import FlightRecorder
from traffic_classifier_sdn_tpu_torch.utils import syncguard

PACKAGE_DIR = os.path.dirname(
    os.path.dirname(os.path.abspath(lint_paths.__code__.co_filename))
)
REPO_ROOT = os.path.dirname(PACKAGE_DIR)
JAX_BUDGET = os.path.join(REPO_ROOT, "docs", "artifacts",
                          "hot_path_sync_budget.json")

_ME = os.path.abspath(__file__)


def _self_scope(filename: str) -> bool:
    return os.path.abspath(filename) == _ME


def _kind_totals(witness) -> dict[str, int]:
    totals: dict[str, int] = {}
    for per in witness.counts().values():
        for kind, n in per.items():
            totals[kind] = totals.get(kind, 0) + n
    return totals


def _prev_lineno() -> int:
    return sys._getframe(1).f_lineno - 1


@pytest.fixture(scope="module")
def fresh_budget():
    """One parse of the port tree for the module's artifact tests."""
    modules, errs = collect_modules([PACKAGE_DIR], relative_to=REPO_ROOT)
    assert errs == []
    return build_sync_report(modules)


# ---------------------------------------------------------------------------
# the counting shims
# ---------------------------------------------------------------------------


def test_shims_count_by_kind():
    t = torch.arange(4)
    f = torch.arange(4.0)
    with syncguard.guarding(scope=_self_scope) as w:
        np.asarray(t)                  # Tensor.__array__
        np.asarray([1, 2, 3])          # host value: silent
        t.numpy()
        t.cpu()
        t.tolist()
        t[0].item()
        int(t[1])
        float(f[2])
        bool(t[3])
        [0, 1][t[1]]                   # operator.index
        for _ in t:                    # iteration
            pass
        torch.as_tensor([1.0, 2.0])    # host→device upload
        torch.tensor(np.ones(2))
        torch.asarray([1, 2])
        torch.as_tensor(t)             # already a tensor: silent
        t.to(torch.float32)            # a dtype: no move
        t.to("cpu")                    # its own device: no move
        len(t)                         # the shape: no seam
    assert _kind_totals(w) == {
        "np.asarray": 1, ".numpy()": 1, ".cpu()": 1, ".tolist()": 1,
        ".item()": 1, "int()": 1, "float()": 1, "bool()": 1,
        "index": 1, "iteration": 1, "upload": 3,
    }


def test_card_crossings_are_counted_apart():
    """Conversions of host tensors count (the CPU suites' exercise) but
    only a move onto another device is a crossing (``device_counts``):
    the census of a serve on a card reads those. The ``meta`` device
    stands in for a card."""
    t = torch.arange(3.0)
    with syncguard.guarding(scope=_self_scope) as w:
        t.cpu()                                  # host: counted only
        torch.as_tensor([1.0, 2.0])              # host upload: counted only
        torch.as_tensor([1.0, 2.0], device="meta")  # onto a device
        t.to("meta")                             # a move: device_put
    report = w.report()
    assert _kind_totals(w) == {".cpu()": 1, "upload": 2, "device_put": 1}
    crossed: dict[str, int] = {}
    for per in report["device_counts"].values():
        for kind, n in per.items():
            crossed[kind] = crossed.get(kind, 0) + n
    assert crossed == {"upload": 1, "device_put": 1}


def test_torch_internal_conversions_attribute_to_the_asking_line():
    # Tensor.__format__ (torch's own Python) calls .item(), and
    # __array__ calls .numpy(): each is one sync, charged to the line
    # that asked, counted once
    t = torch.arange(3)
    with syncguard.guarding(scope=_self_scope) as w:
        text = f"{t[2]}"
        line = _prev_lineno()
    assert text == "2"
    assert w.counts() == {f"{_site(line)}": {".item()": 1}}
    with syncguard.guarding(scope=_self_scope) as w:
        np.asarray(t)
    assert _kind_totals(w) == {"np.asarray": 1}


def _site(line: int) -> str:
    return f"{_ME.replace(os.sep, '/')}:{line}"


def test_site_attribution_is_the_call_site():
    t = torch.arange(2)
    with syncguard.guarding(scope=_self_scope) as w:
        t.tolist()
        line = _prev_lineno()
    (site,) = w.counts().keys()
    path, _, observed = site.rpartition(":")
    assert path.endswith("test_torch_syncguard.py")
    assert int(observed) == line


def test_out_of_scope_frames_are_not_counted():
    t = torch.arange(2)
    with syncguard.guarding(scope=lambda fn: False) as w:
        np.asarray(t)
        t.item() if t.numel() == 1 else t.tolist()
    assert w.counts() == {}


def test_default_scope_is_the_port_package_only():
    assert syncguard._default_scope(
        os.path.join(PACKAGE_DIR, "serving", "pipeline.py"))
    assert not syncguard._default_scope(
        os.path.join(REPO_ROOT, "traffic_classifier_sdn_tpu", "serving",
                     "pipeline.py"))
    assert not syncguard._default_scope(
        os.path.join(PACKAGE_DIR, "utils", "syncguard.py"))
    assert not syncguard._default_scope(_ME)


PATCHED = [(torch.Tensor, n) for n in (*syncguard._METHOD_KINDS,
                                       "to", "cuda")] + [
    (torch, n) for n in syncguard._UPLOADS
]


def test_uninstall_restores_the_exact_originals():
    before = {(o, n): getattr(o, n) for o, n in PATCHED}
    own = {(o, n): n in o.__dict__ for o, n in PATCHED}
    t = torch.arange(2)
    with syncguard.guarding(scope=_self_scope) as w:
        assert all(getattr(o, n) is not before[(o, n)]
                   for o, n in PATCHED)
        shim = torch.Tensor.tolist
    assert all(getattr(o, n) is before[(o, n)] for o, n in PATCHED)
    # an inherited dunder is inherited again, not shadowed
    assert all((n in o.__dict__) == own[(o, n)] for o, n in PATCHED)
    # a shim reference outliving uninstall still works, uncounted
    assert shim(t) == [0, 1]
    assert w.counts() == {}


def test_double_install_is_refused_and_state_is_kept():
    with syncguard.guarding(scope=_self_scope) as w:
        with pytest.raises(RuntimeError):
            syncguard.install(syncguard.SyncWitness())
        assert syncguard._installed is w
    assert syncguard._installed is None


# ---------------------------------------------------------------------------
# the live allowlist check
# ---------------------------------------------------------------------------


def _span_budget(allowed=()):  # whole file hot, optional allowlist
    return {
        "hot_spans": {os.path.basename(_ME): [[1, 100000]]},
        "allowed_syncs": [{"site": s} for s in allowed],
    }


def test_violation_dedup_and_flight_recorder_event():
    rec = FlightRecorder(capacity=64)
    t = torch.arange(3)
    with syncguard.guarding(
        budget=_span_budget(), recorder=rec, scope=_self_scope
    ) as w:
        for _ in range(3):
            t.cpu()  # same site every iteration
    violations = w.violations
    assert len(violations) == 1  # deduped by site
    v = violations[0]
    assert v["kind"] == ".cpu()"
    assert "test_torch_syncguard.py:" in v["site"]
    assert v["thread"]
    assert rec.count("syncguard.violation") == 1
    # all three calls still counted — dedup applies to flagging only
    assert _kind_totals(w) == {".cpu()": 3}


def test_allowed_site_is_not_a_violation():
    t = torch.arange(3)
    with syncguard.guarding(
        budget=_span_budget(), scope=_self_scope
    ) as probe:
        t.tolist()
    (site,) = probe.counts().keys()
    line = site.rpartition(":")[2]
    budget = _span_budget(allowed=[os.path.basename(_ME) + ":" + line])
    assert probe.check_against(budget) == {
        "unknown_syncs": [], "unbudgeted_cuda_syncs": [],
        "checked": True,
    }
    assert probe.check_against(_span_budget())["unknown_syncs"] == [
        {"site": site, "kinds": {".tolist()": 1}},
    ]


def test_check_against_none_is_inert():
    w = syncguard.SyncWitness()
    assert w.check_against(None) == {
        "unknown_syncs": [], "unbudgeted_cuda_syncs": [],
        "checked": False,
    }


def test_finish_reports_once_and_writes_the_report(capsys, tmp_path,
                                                   monkeypatch):
    out = tmp_path / "report.json"
    monkeypatch.setenv(syncguard.ENV_OUT, str(out))
    rec = FlightRecorder(capacity=64)
    t = torch.arange(3)
    with syncguard.guarding(
        budget=_span_budget(), recorder=rec, scope=_self_scope
    ) as w:
        t.numpy()
    report = syncguard.finish(w, recorder=rec)
    assert report is not None and len(report["violations"]) == 1
    assert "SYNCGUARD VIOLATION" in capsys.readouterr().err
    assert rec.count("syncguard.violation") == 1
    late = FlightRecorder(capacity=64)
    syncguard.finish(w, recorder=late)
    assert late.count("syncguard.violation") == 1
    written = json.loads(out.read_text())
    assert written["counts"] == report["counts"]
    assert written["violations"] == report["violations"]


# ---------------------------------------------------------------------------
# env hooks
# ---------------------------------------------------------------------------


def test_load_budget_env_override(tmp_path, monkeypatch):
    budget = {"hot_spans": {}, "allowed_syncs": []}
    p = tmp_path / "b.json"
    p.write_text(json.dumps(budget), encoding="utf-8")
    monkeypatch.setenv("TCSDN_TORCH_SYNC_BUDGET", str(p))
    assert syncguard.load_budget() == budget
    monkeypatch.setenv("TCSDN_TORCH_SYNC_BUDGET", str(tmp_path / "no.json"))
    assert syncguard.load_budget() is None


def test_maybe_guard_from_env(monkeypatch):
    monkeypatch.delenv("TCSDN_SYNCGUARD", raising=False)
    assert syncguard.maybe_guard_from_env() is None
    monkeypatch.setenv("TCSDN_SYNCGUARD", "1")
    w = syncguard.maybe_guard_from_env()
    try:
        assert w is not None and syncguard._installed is w
        assert syncguard.maybe_guard_from_env() is None
    finally:
        syncguard.uninstall()
    assert syncguard._installed is None


def test_sync_debug_mode_needs_a_card(monkeypatch):
    monkeypatch.setenv(syncguard.ENV_TRANSFER_GUARD, "log")
    filters = list(warnings.filters)
    with syncguard.guarding(scope=_self_scope):
        assert syncguard._tg_prev is None  # no card: nothing armed
    assert warnings.filters == filters


def test_sync_debug_warnings_are_recorded_by_site_and_restored(
    monkeypatch,
):
    """The CUDA sync-debug arming with the card faked: the mode is set
    to "warn" and restored, each "synchronizing CUDA operation" warning
    is counted at the nearest in-scope frame (every one, not once per
    location), other warnings pass through, and the filters and
    ``showwarning`` come back exactly."""
    modes = []
    monkeypatch.setenv(syncguard.ENV_TRANSFER_GUARD, "log")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    filters = list(warnings.filters)
    show = warnings.showwarning
    passed = []
    monkeypatch.setattr(warnings, "showwarning",
                        lambda *a, **k: passed.append(a[0]))
    show = warnings.showwarning
    with syncguard.guarding(scope=_self_scope) as w:
        for _ in range(3):
            warnings.warn("called a synchronizing CUDA operation")
            line = _prev_lineno()
        warnings.warn("something else")
    assert modes == ["warn", 0]
    assert w.cuda_counts() == {_site(line): 3}
    assert [str(m) for m in passed] == ["something else"]
    assert warnings.showwarning is show
    assert warnings.filters == filters
    report = w.check_against(_span_budget())
    assert report["unbudgeted_cuda_syncs"] == [
        {"site": _site(line), "count": 3, "hot": True}]


# ---------------------------------------------------------------------------
# both packages' witnesses in one process
# ---------------------------------------------------------------------------


def test_both_witnesses_nest_and_count_their_own():
    """JAX's witness (numpy/jax seams) and the port's (tensor seams)
    armed at once, last in first out: each counts its own conversions
    at the same call sites, neither double counts, each ``_installed``
    guard refuses only its own second install, and uninstalling both
    restores every seam exactly."""
    np_asarray, tolist = np.asarray, torch.Tensor.tolist
    dev = jnp.arange(3.0)
    t = torch.arange(3)
    with jsyncguard.guarding(scope=_self_scope) as jw:
        with syncguard.guarding(scope=_self_scope) as tw:
            with pytest.raises(RuntimeError):
                syncguard.install(syncguard.SyncWitness())
            with pytest.raises(RuntimeError):
                jsyncguard.install(jsyncguard.SyncWitness())
            np.asarray(dev)
            np.asarray(t)
            t.tolist()
        assert torch.Tensor.tolist is tolist
        assert np.asarray is not np_asarray  # JAX's still armed
    assert np.asarray is np_asarray
    assert _kind_totals(jw) == {"np.asarray": 1}
    assert _kind_totals(tw) == {"np.asarray": 1, ".tolist()": 1}


# ---------------------------------------------------------------------------
# the static/dynamic agreement contract
# ---------------------------------------------------------------------------

FIXTURES = {
    ".cpu()": "return x.cpu()",
    ".numpy()": "return x.numpy()",
    ".tolist()": "return x.tolist()",
    ".item()": "return x.sum().item()",
    "np.asarray": "return np.asarray(x)",
    "int()": "return int(x.sum())",
    "bool()": "return 1 if x.any() else 0",
    "iteration": "return [v for v in x]",
}


def _fixture(body: str) -> str:
    return textwrap.dedent(f"""\
        import numpy as np
        import torch


        def serve_tick(x: torch.Tensor):
            {body}
        """)


def _fixture_budget(tmp_path, path):
    modules, errs = collect_modules([str(path)], relative_to=str(tmp_path))
    assert errs == []
    return build_sync_report(modules)


def _load_fixture(path):
    spec = importlib.util.spec_from_file_location(
        f"sync_fx_{abs(hash(str(path)))}", str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_same_fixture_flagged_statically_and_tripped_at_runtime(
    tmp_path, kind,
):
    path = tmp_path / "fixture.py"
    path.write_text(_fixture(FIXTURES[kind]), encoding="utf-8")
    findings = lint_paths([str(path)])
    assert [f.rule for f in findings] == ["implicit-sync"]
    static_line = findings[0].line

    budget = _fixture_budget(tmp_path, path)
    assert "fixture.py" in budget["hot_spans"]
    assert budget["allowed_syncs"] == []

    mod = _load_fixture(path)
    scope = lambda fn: fn.startswith(str(tmp_path))  # noqa: E731
    with syncguard.guarding(budget=budget, scope=scope) as w:
        mod.serve_tick(torch.arange(4))
    violations = w.violations
    assert len(violations) == 1
    assert violations[0]["kind"] == kind
    assert int(violations[0]["site"].rpartition(":")[2]) == static_line


def test_suppression_becomes_allowlist_and_silences_witness(tmp_path):
    path = tmp_path / "fixture.py"
    path.write_text(_fixture(
        "return x.cpu()  # graftlint: disable=implicit-sync "
        "-- render-sync: test seam"), encoding="utf-8")
    assert lint_paths([str(path)]) == []

    budget = _fixture_budget(tmp_path, path)
    allowed = budget["allowed_syncs"]
    assert len(allowed) == 1
    assert allowed[0]["discipline"] == "render-sync"
    assert allowed[0]["rule"] == "implicit-sync"

    mod = _load_fixture(path)
    scope = lambda fn: fn.startswith(str(tmp_path))  # noqa: E731
    with syncguard.guarding(budget=budget, scope=scope) as w:
        mod.serve_tick(torch.arange(4))
    assert w.violations == []
    assert _kind_totals(w) == {".cpu()": 1}


def test_upload_fixture_flagged_statically_and_tripped_at_runtime(
    tmp_path,
):
    path = tmp_path / "fixture.py"
    path.write_text(_fixture("return torch.as_tensor(np.ones(3, np.int64)) + x"),
                    encoding="utf-8")
    findings = lint_paths([str(path)])
    assert [f.rule for f in findings] == ["transfer-discipline"]
    budget = _fixture_budget(tmp_path, path)
    mod = _load_fixture(path)
    scope = lambda fn: fn.startswith(str(tmp_path))  # noqa: E731
    with syncguard.guarding(budget=budget, scope=scope) as w:
        mod.serve_tick(torch.arange(3))
    assert [v["kind"] for v in w.violations] == ["upload"]
    assert int(w.violations[0]["site"].rpartition(":")[2]) == (
        findings[0].line)


# ---------------------------------------------------------------------------
# the committed artifact
# ---------------------------------------------------------------------------


def test_sync_budget_artifact_is_current(fresh_budget):
    """docs/artifacts/torch_hot_path_sync_budget.json must match a
    fresh build from the port's source. Regenerate from the repo root
    with:

        python -m traffic_classifier_sdn_tpu_torch.analysis_static \\
            --sync-budget docs/artifacts/torch_hot_path_sync_budget.json
    """
    artifact_path = syncguard.DEFAULT_BUDGET_PATH
    assert os.path.exists(artifact_path)
    with open(artifact_path, encoding="utf-8") as f:
        committed = json.load(f)
    assert committed == fresh_budget, (
        "docs/artifacts/torch_hot_path_sync_budget.json is stale — "
        "regenerate it (see this test's docstring)"
    )


def test_sync_budget_artifact_shape(fresh_budget):
    budget = fresh_budget
    probe = syncguard.SyncWitness(budget=budget)
    for entry in budget["allowed_syncs"]:
        assert entry["discipline"] in budget["disciplines"]
        assert entry["reason"]
        path, line = probe._split(entry["site"])
        assert probe._in_hot_span(path, line), entry["site"]
    assert set(budget["serve_paths"]) == {
        "serial", "pipelined", "incremental", "degraded",
    }
    with open(JAX_BUDGET, encoding="utf-8") as f:
        jax_budget = json.load(f)
    assert budget["schema_version"] == jax_budget["schema_version"]
    assert budget["disciplines"] == jax_budget["disciplines"]
    assert set(budget) == set(jax_budget)


def test_hot_roots_are_jax_roots_minus_feature_stage(fresh_budget):
    with open(JAX_BUDGET, encoding="utf-8") as f:
        jax_roots = json.load(f)["hot_roots"]
    jax_rel = {r.split("/", 1)[1] for r in jax_roots}
    port_rel = {r.split("/", 1)[1] for r in fresh_budget["hot_roots"]}
    assert all(r.startswith("traffic_classifier_sdn_tpu_torch/")
               for r in fresh_budget["hot_roots"])
    assert port_rel == jax_rel - {"serving/pipeline.py::FeatureStage.features"}
