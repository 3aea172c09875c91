"""The port's static-analysis pass
(``traffic_classifier_sdn_tpu_torch/analysis_static``), held against the
JAX package's (``traffic_classifier_sdn_tpu/analysis_static``).

- The port's tree lints clean (the tier-1 self-enforcement test, marked
  ``lint``), and the CLI keeps JAX's contract: the same 13 rule ids,
  exit codes 0/1/2, ``--json``/``--sarif``/``--select``.
- The rules that do not depend on JAX (ctypes-abi on JAX's per-symbol
  idiom, lock-discipline, fault-site-registry, atomic-io, lock-order,
  blocking-under-lock, thread-lifecycle, bad-suppression) take the SAME
  fixture sources as tests/test_graftlint.py through both linters and
  give the same (rule id, line) sets.
- Fixtures pin each torch-specific seam of implicit-sync and
  transfer-discipline, each caught and each suppressible only with a
  reason that names a discipline; the retargeted jit-purity
  (``torch.compile``/``torch.jit``/``torch.cuda.graph``), retrace-hazard
  (compiled call sites) and donation-hazard (a tensor used on another
  CUDA stream with no ``record_stream`` or fence); and ctypes-abi on the
  port's ``_SIGNATURES`` table idiom, a symbol missing from the table
  still flagged.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

import test_graftlint as jt
from traffic_classifier_sdn_tpu.analysis_static import rules as jrules
from traffic_classifier_sdn_tpu.analysis_static.framework import (
    LintRunner as JLintRunner,
)
from traffic_classifier_sdn_tpu_torch.analysis_static import lint_paths
from traffic_classifier_sdn_tpu_torch.analysis_static import rules
from traffic_classifier_sdn_tpu_torch.analysis_static.framework import (
    BAD_SUPPRESSION,
    LintRunner,
)
from traffic_classifier_sdn_tpu_torch.analysis_static.graftsync import (
    DISCIPLINES,
)
from traffic_classifier_sdn_tpu.analysis_static.graftsync import (
    DISCIPLINES as JAX_DISCIPLINES,
)

PACKAGE_DIR = os.path.dirname(
    os.path.dirname(os.path.abspath(lint_paths.__code__.co_filename))
)
REPO_ROOT = os.path.dirname(PACKAGE_DIR)
ALL_IDS = [cls.id for cls in rules.ALL_RULES]


def _write(tmp_path, files: dict) -> None:
    for name, src in files.items():
        p = tmp_path / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src), encoding="utf-8")


def _lint(tmp_path, source, filename="snippet.py"):
    _write(tmp_path, {filename: source})
    return lint_paths([str(tmp_path / filename)])


# ---------------------------------------------------------------------------
# the same fixtures through both linters
# ---------------------------------------------------------------------------

# (case, rule id, {file: source}) — the sources are tests/test_graftlint.py's
PARITY = [
    ("ctypes-pos", "ctypes-abi", {"snippet.py": jt.CTYPES_POSITIVE}),
    ("ctypes-neg", "ctypes-abi", {"snippet.py": jt.CTYPES_NEGATIVE}),
    ("ctypes-xlang-mismatch", "ctypes-abi",
     {"native.cpp": jt.CROSS_LANG_CPP, "engine.py": jt.CROSS_LANG_PY_MISMATCH}),
    ("ctypes-xlang-clean", "ctypes-abi",
     {"native.cpp": jt.CROSS_LANG_CPP, "engine.py": jt.CROSS_LANG_PY_CLEAN}),
    ("lock-pos", "lock-discipline", {"snippet.py": jt.LOCK_POSITIVE}),
    ("lock-neg", "lock-discipline", {"snippet.py": jt.LOCK_NEGATIVE}),
    ("lock-ring", "lock-discipline", {"snippet.py": jt.LOCK_RING_POSITIVE}),
    ("lock-handoff-pos", "lock-discipline",
     {"snippet.py": jt.LOCK_HANDOFF_POSITIVE}),
    ("lock-handoff-neg", "lock-discipline",
     {"snippet.py": jt.LOCK_HANDOFF_NEGATIVE}),
    ("lock-watchdog-pos", "lock-discipline",
     {"snippet.py": jt.LOCK_WATCHDOG_POSITIVE}),
    ("lock-watchdog-neg", "lock-discipline",
     {"snippet.py": jt.LOCK_WATCHDOG_NEGATIVE}),
    ("lock-retrain-pos", "lock-discipline",
     {"snippet.py": jt.LOCK_RETRAIN_POSITIVE}),
    ("lock-retrain-neg", "lock-discipline",
     {"snippet.py": jt.LOCK_RETRAIN_NEGATIVE}),
    ("fault-pos", "fault-site-registry",
     {"faults.py": jt.FAULTS_REGISTRY, "user.py": jt.FAULT_SITE_POSITIVE}),
    ("fault-neg", "fault-site-registry",
     {"faults.py": jt.FAULTS_REGISTRY, "user.py": jt.FAULT_SITE_NEGATIVE}),
    ("atomic-pos", "atomic-io", {"snippet.py": jt.ATOMIC_POSITIVE}),
    ("atomic-module", "atomic-io", {"snippet.py": jt.ATOMIC_MODULE_SCOPE}),
    ("atomic-neg", "atomic-io", {"snippet.py": jt.ATOMIC_NEGATIVE}),
    ("order-abba", "lock-order", {"snippet.py": jt.LOCK_ORDER_ABBA}),
    ("order-consistent", "lock-order",
     {"snippet.py": jt.LOCK_ORDER_CONSISTENT}),
    ("blocking-pos", "blocking-under-lock",
     {"snippet.py": jt.BLOCKING_POSITIVE}),
    ("blocking-neg", "blocking-under-lock",
     {"snippet.py": jt.BLOCKING_NEGATIVE}),
    ("thread-pos", "thread-lifecycle",
     {"snippet.py": jt.THREAD_LIFECYCLE_POSITIVE}),
    ("thread-neg", "thread-lifecycle",
     {"snippet.py": jt.THREAD_LIFECYCLE_NEGATIVE}),
    ("bad-suppression", "atomic-io", {"snippet.py": (
        jt.ATOMIC_POSITIVE.replace(
            'os.replace(path + ".tmp", path)',
            'os.replace(path + ".tmp", path)  # graftlint: disable=atomic-io')
        + "\nx = 1  # graftlint: disable=no-such-rule -- typo'd id\n"
        + "y = 2  # graftlint: disable=lock-order -- a real id\n"
        + "z = 3  # graftlint: enable everything\n")}),
]


def _rule_sets(tmp_path, rule_id, files):
    out = {}
    for name, mod, runner in (("jax", jrules, JLintRunner),
                              ("port", rules, LintRunner)):
        d = tmp_path / name
        _write(d, files)
        rule = next(cls for cls in mod.ALL_RULES if cls.id == rule_id)
        findings = runner(
            [rule()], known_ids=[c.id for c in mod.ALL_RULES]
        ).run([str(d)])
        out[name] = sorted({(f.rule, f.line) for f in findings})
    return out


@pytest.mark.parametrize("case,rule_id,files", PARITY,
                         ids=[c[0] for c in PARITY])
def test_same_fixture_same_findings_as_jax(tmp_path, case, rule_id, files):
    got = _rule_sets(tmp_path, rule_id, files)
    assert got["port"] == got["jax"]
    if case.endswith(("-pos", "-abba", "-mismatch", "-module", "-ring")) or (
        case == "bad-suppression"
    ):
        assert got["port"], "the positive fixture must fire"


def test_list_rules_prints_the_same_13_ids_as_jax():
    ids = []
    for pkg in ("traffic_classifier_sdn_tpu",
                "traffic_classifier_sdn_tpu_torch"):
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg}.analysis_static",
             "--list-rules"],
            capture_output=True, text=True, cwd=REPO_ROOT, timeout=120,
            env=dict(os.environ, JAX_PLATFORMS="cpu"),
        )
        assert proc.returncode == 0, proc.stderr
        ids.append([line.split()[0] for line in proc.stdout.splitlines()])
    assert ids[0] == ids[1]
    assert len(ids[1]) == 13
    assert ids[1] == ALL_IDS


def test_disciplines_are_jax_eight():
    assert DISCIPLINES == JAX_DISCIPLINES
    assert len(DISCIPLINES) == 8


# ---------------------------------------------------------------------------
# the torch sync seams (implicit-sync), each caught and suppressible only
# with a discipline
# ---------------------------------------------------------------------------

SEAMS = {
    ".item()": "return x.sum().item()",
    ".tolist()": "return x.tolist()",
    ".cpu()": "return x.cpu()",
    ".numpy()": "return x.numpy()",
    ".to(cpu)": "return x.to('cpu')",
    "np.asarray": "return np.asarray(x)",
    "int()": "return int(x.sum())",
    "float()": "return float(x.max())",
    "bool()": "return bool(x.any())",
    "truthiness": "if x.any():\n        return 1",
    "iteration": "for v in x:\n        pass",
    "cuda.synchronize": "torch.cuda.synchronize()",
    ".synchronize()": "torch.cuda.Event().synchronize()",
    "nonzero()": "return x.nonzero()",
    "torch.nonzero": "return torch.nonzero(x)",
    "mask-index": "return x[x > 0]",
    "mask-name": "m = x > 0\n    return x[m]",
    "unique()": "return torch.unique(x)",
    "masked_select()": "return x.masked_select(x > 0)",
    "repeat_interleave()": "return x.repeat_interleave(x)",
}

CLEAN_SEAMS = {
    "len": "return len(x)",
    "shape": "return x.shape[0] + x.size(0) + x.numel()",
    "sized-repeat": "return x.repeat_interleave(x, output_size=8)",
    "index-gather": "return x[x.argsort()]",
    "identity": "return 0 if x is None else 1",
    "device-ops": "return torch.where(x > 0, x, 0).sum()",
}


def _seam_fixture(body: str) -> str:
    return (
        "import numpy as np\nimport torch\n\n\n"
        "def serve_tick(x: torch.Tensor):\n    " + body + "\n"
    )


@pytest.mark.parametrize("seam", sorted(SEAMS))
def test_torch_sync_seam_is_caught(tmp_path, seam):
    findings = _lint(tmp_path, _seam_fixture(SEAMS[seam]))
    assert [f.rule for f in findings] == ["implicit-sync"], findings
    assert "serve_tick" in findings[0].message


@pytest.mark.parametrize("seam", sorted(CLEAN_SEAMS))
def test_torch_metadata_and_device_ops_are_not_syncs(tmp_path, seam):
    assert _lint(tmp_path, _seam_fixture(CLEAN_SEAMS[seam])) == []


def _suppressed(src: str, line: int, comment: str) -> str:
    lines = src.split("\n")
    lines[line - 1] += "  # graftlint: disable=" + comment
    return "\n".join(lines)


@pytest.mark.parametrize("seam", sorted(SEAMS) + [
    f"upload-{k}" for k in ("as_tensor", "tensor", "to-device", "cuda")])
def test_torch_sync_seam_suppressible_only_with_a_discipline(tmp_path,
                                                             seam):
    if seam.startswith("upload-"):
        rule, src = "transfer-discipline", _seam_fixture(UPLOADS[seam[7:]])
    else:
        rule, src = "implicit-sync", _seam_fixture(SEAMS[seam])
    (finding,) = _lint(tmp_path, src)
    good = _suppressed(src, finding.line,
                       f"{rule} -- render-sync: the render boundary")
    assert _lint(tmp_path, good) == []
    bad = _suppressed(src, finding.line, f"{rule} -- it is fine")
    findings = _lint(tmp_path, bad)
    assert [f.rule for f in findings] == [BAD_SUPPRESSION]
    assert "discipline" in findings[0].message


def test_cold_path_sync_is_free(tmp_path):
    src = _seam_fixture("return x").replace("serve_tick", "warmup") + (
        "\n\ndef helper(x: torch.Tensor):\n    return x.cpu()\n")
    assert _lint(tmp_path, src) == []


def test_sync_reached_through_a_helper_and_a_tensor_attribute(tmp_path):
    src = """
        import torch


        class Table:
            def __init__(self, n):
                self.active = torch.zeros(n, dtype=torch.bool, device="cuda")


        def _render(t: Table):
            return t.active.tolist()


        def serve_tick(t: Table):
            return _render(t)
    """
    findings = _lint(tmp_path, src)
    assert [f.rule for f in findings] == ["implicit-sync"]
    assert "_render" in findings[0].message


def test_kernel_wrapper_results_are_device_tensors(tmp_path):
    _write(tmp_path, {
        "pkg/__init__.py": "",
        "pkg/ops/__init__.py": "",
        "pkg/ops/forest_kernel.py": (
            "def forest_proba(ops, X):\n    return X\n"),
        "pkg/serve.py": (
            "from .ops import forest_kernel as fk\n\n\n"
            "def serve_tick(ops, X):\n"
            "    p = fk.forest_proba(ops, X)\n"
            "    return p.argmax(1).tolist()\n"),
    })
    findings = lint_paths([str(tmp_path / "pkg")])
    assert [(f.rule, f.path.endswith("serve.py")) for f in findings] == [
        ("implicit-sync", True)]


def test_sync_under_lock(tmp_path):
    src = """
        import threading
        import torch


        class Gate:
            def __init__(self):
                self._lock = threading.Lock()
                self._count = torch.zeros((), dtype=torch.int32,
                                          device="cuda")

            def drain(self):
                with self._lock:
                    return int(self._count)

            def drain_outside(self):
                with self._lock:
                    c = self._count
                return int(c)
    """
    findings = _lint(tmp_path, src)
    assert [f.rule for f in findings] == ["sync-under-lock"]
    assert findings[0].line == 14  # drain's int(); drain_outside is clean


# ---------------------------------------------------------------------------
# transfer-discipline
# ---------------------------------------------------------------------------

UPLOADS = {
    "as_tensor": "return torch.as_tensor(np.ones(3, np.float32)) + x",
    "tensor": "return torch.tensor(np.ones(3, np.float32), device=x.device)",
    "to-device": "h = torch.from_numpy(np.ones(3, np.float32))\n"
                 "    return h.to(x.device) + x",
    "cuda": "h = torch.from_numpy(np.ones(3, np.float32))\n"
            "    return h.cuda() + x",
}


@pytest.mark.parametrize("kind", sorted(UPLOADS))
def test_per_tick_upload_is_caught(tmp_path, kind):
    findings = _lint(tmp_path, _seam_fixture(UPLOADS[kind]))
    assert [f.rule for f in findings] == ["transfer-discipline"]


def test_upload_suppressible_with_epoch_cached(tmp_path):
    body = UPLOADS["as_tensor"] + (
        "  # graftlint: disable=transfer-discipline -- epoch-cached: one "
        "upload per epoch")
    assert _lint(tmp_path, _seam_fixture(body)) == []


def test_device_tensor_moves_are_not_uploads(tmp_path):
    body = "return x.to(x.device) + x.to(torch.float32).to(x.device)"
    assert _lint(tmp_path, _seam_fixture(body)) == []


# ---------------------------------------------------------------------------
# the retargeted jit-purity / retrace-hazard / donation-hazard
# ---------------------------------------------------------------------------

JIT_PURITY_POSITIVE = {
    "compile-decorator": """
        import time
        import torch

        @torch.compile
        def step(x):
            t = time.time()
            return x * t + x.sum().item()
    """,
    "compile-call": """
        import numpy as np
        import torch

        def body(x):
            print("tracing")
            return x + np.random.rand()

        fast = torch.compile(body)
    """,
    "jit-script": """
        import torch

        @torch.jit.script
        def step(x):
            return float(x.sum())
    """,
    "cuda-graph": """
        import torch

        def capture(g, x):
            with torch.cuda.graph(g):
                y = x.cpu()
            return y
    """,
}

JIT_PURITY_CLEAN = """
    import time
    import torch

    @torch.compile
    def step(x):
        return torch.where(x > 0, x, 0).sum()

    def host(x):
        t = time.time()
        return x.item(), t

    def capture(g, x):
        with torch.cuda.graph(g):
            y = x * 2
        return y.cpu()
"""


@pytest.mark.parametrize("case", sorted(JIT_PURITY_POSITIVE))
def test_jit_purity_fires_on_torch_tracing(tmp_path, case):
    _write(tmp_path, {"snippet.py": JIT_PURITY_POSITIVE[case]})
    findings = LintRunner([rules.JitPurityRule()]).run(
        [str(tmp_path / "snippet.py")])
    assert findings and {f.rule for f in findings} == {"jit-purity"}


def test_jit_purity_clean_and_suppressible(tmp_path):
    _write(tmp_path, {"snippet.py": JIT_PURITY_CLEAN})
    assert LintRunner([rules.JitPurityRule()]).run(
        [str(tmp_path / "snippet.py")]) == []
    src = JIT_PURITY_POSITIVE["jit-script"].replace(
        "return float(x.sum())",
        "return float(x.sum())  # graftlint: disable=jit-purity -- "
        "scripted for a host-only tool")
    _write(tmp_path, {"s2.py": src})
    assert LintRunner([rules.JitPurityRule()]).run(
        [str(tmp_path / "s2.py")]) == []


RETRACE_POSITIVE = """
    import torch

    def body(x, n):
        return x * n

    fast = torch.compile(body)

    def run(x):
        a = fast(x, 3)
        b = fast(x, [1, 2])
        c = torch.tensor([1, 2, 3])
        return a, b, c
"""

RETRACE_NEGATIVE = """
    import torch

    def body(x, n):
        return x * n

    fast = torch.compile(body, dynamic=True)

    def run(x, n):
        c = torch.tensor([1, 2, 3], dtype=torch.int64)
        return fast(x, 3), fast(x, n), c
"""


def test_retrace_hazard_fires_on_compiled_call_sites(tmp_path):
    _write(tmp_path, {"snippet.py": RETRACE_POSITIVE})
    findings = LintRunner([rules.RetraceHazardRule()]).run(
        [str(tmp_path / "snippet.py")])
    assert sorted(f.line for f in findings) == [10, 11, 12]


def test_retrace_hazard_clean(tmp_path):
    _write(tmp_path, {"snippet.py": RETRACE_NEGATIVE})
    assert LintRunner([rules.RetraceHazardRule()]).run(
        [str(tmp_path / "snippet.py")]) == []


STREAM_HAZARD = """
    import torch


    def serve_tick(x: torch.Tensor, side):
        y = x * 2
        with torch.cuda.stream(side):
            z = y.sum()
        return z
"""

STREAM_FENCES = {
    "record_stream": STREAM_HAZARD.replace(
        "        with torch.cuda.stream(side):",
        "        y.record_stream(side)\n        with torch.cuda.stream(side):"),
    "synchronize": STREAM_HAZARD.replace(
        "        return z", "        side.synchronize()\n        return z"),
    "wait_stream": STREAM_HAZARD.replace(
        "        with torch.cuda.stream(side):",
        "        side.wait_stream(torch.cuda.current_stream())\n"
        "        with torch.cuda.stream(side):"),
    "current-stream": STREAM_HAZARD.replace(
        "        y = x * 2",
        "        y = x * 2\n        side = torch.cuda.current_stream()"),
    "made-inside": STREAM_HAZARD.replace(
        "        y = x * 2\n        with torch.cuda.stream(side):\n",
        "        with torch.cuda.stream(side):\n"
        "            y = torch.ones(3, device=\"cuda\")\n"),
}


def test_donation_hazard_fires_on_an_unfenced_cross_stream_use(tmp_path):
    _write(tmp_path, {"snippet.py": STREAM_HAZARD})
    findings = LintRunner([rules.DonationHazardRule()]).run(
        [str(tmp_path / "snippet.py")])
    assert [(f.rule, f.line) for f in findings] == [("donation-hazard", 8)]
    assert "record_stream" in findings[0].message


@pytest.mark.parametrize("fence", sorted(STREAM_FENCES))
def test_donation_hazard_clean_when_fenced(tmp_path, fence):
    _write(tmp_path, {"snippet.py": STREAM_FENCES[fence]})
    assert LintRunner([rules.DonationHazardRule()]).run(
        [str(tmp_path / "snippet.py")]) == []


def test_donation_hazard_through_a_stream_context_name(tmp_path):
    src = STREAM_HAZARD.replace(
        "        with torch.cuda.stream(side):",
        "        ctx = torch.cuda.stream(side)\n        with ctx:")
    _write(tmp_path, {"snippet.py": src})
    findings = LintRunner([rules.DonationHazardRule()]).run(
        [str(tmp_path / "snippet.py")])
    assert [f.rule for f in findings] == ["donation-hazard"]


# ---------------------------------------------------------------------------
# ctypes-abi on the port's _SIGNATURES table idiom
# ---------------------------------------------------------------------------

TABLE_CPP = """
    #include <cstdint>
    extern "C" {
    void* tx_create(uint32_t n) { (void)n; return nullptr; }
    void tx_destroy(void* h) { (void)h; }
    uint64_t tx_count(void* h, uint32_t k) { (void)h; (void)k; return 0; }
    }
"""

TABLE_PY = """
    import ctypes as ct
    import threading

    from .loader import LazyLib

    _lazy = LazyLib("x.cpp", "demo")
    _lock = threading.Lock()
    _VP, _U32, _U64 = ct.c_void_p, ct.c_uint32, ct.c_uint64
    _SIGNATURES = {
        "tx_create": (_VP, [_U32]),
        "tx_destroy": (None, [_VP]),
        "tx_count": (_U64, [_VP, _U32]),
    }


    def _load():
        lib = _lazy.load()
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        return lib


    def go():
        _lib = _load()
        h = _lib.tx_create(4)
        n = _lib.tx_count(h, 1)
        _lib.tx_destroy(h)
        return n
"""


def _table_findings(tmp_path, py):
    _write(tmp_path, {"native.cpp": TABLE_CPP, "engine.py": py})
    return LintRunner([rules.CtypesAbiRule()]).run(
        [str(tmp_path / "engine.py")])


def test_ctypes_table_idiom_declares_every_entry(tmp_path):
    assert _table_findings(tmp_path, TABLE_PY) == []


def test_ctypes_table_missing_symbol_still_flagged(tmp_path):
    py = TABLE_PY.replace('        "tx_count": (_U64, [_VP, _U32]),\n', "")
    findings = _table_findings(tmp_path, py)
    assert [f.rule for f in findings] == ["ctypes-abi"]
    assert "tx_count" in findings[0].message
    assert "called without declared" in findings[0].message


def test_ctypes_table_entry_checked_against_the_cpp(tmp_path):
    py = TABLE_PY.replace('"tx_count": (_U64, [_VP, _U32])',
                          '"tx_count": (_U32, [_VP])')
    findings = _table_findings(tmp_path, py)
    msgs = sorted(f.message for f in findings)
    assert len(findings) == 2, msgs
    assert any("restype" in m for m in msgs)
    assert any("argument(s)" in m for m in msgs)


def test_ctypes_table_without_an_applying_loop_declares_nothing(tmp_path):
    py = TABLE_PY.replace("            fn.restype = restype\n", "")
    findings = _table_findings(tmp_path, py)
    assert sorted({f.message.split("'")[1] for f in findings}) == [
        "tx_count", "tx_create", "tx_destroy"]


# ---------------------------------------------------------------------------
# self-enforcement + CLI contract
# ---------------------------------------------------------------------------


@pytest.mark.lint
def test_port_package_is_clean():
    findings = lint_paths([PACKAGE_DIR])
    assert findings == [], "\n".join(f.render() for f in findings)


def test_every_port_suppression_carries_a_reason():
    """Every ``graftlint: disable`` in the port has a reason (else it is
    a bad-suppression the clean run above would report); every sync
    suppression names one of JAX's eight disciplines."""
    import re

    pat = re.compile(r"graftlint:\s*disable=([\w,-]+)\s+--\s*(.+)$")
    n_sync = 0
    for root, _, files in os.walk(PACKAGE_DIR):
        if "analysis_static" in root:
            continue
        for name in files:
            if not name.endswith(".py"):
                continue
            for line in open(os.path.join(root, name), encoding="utf-8"):
                if "graftlint: disable" not in line:
                    continue
                m = pat.search(line)
                assert m, line
                if {"implicit-sync", "transfer-discipline"} & set(
                    m.group(1).split(",")
                ):
                    n_sync += 1
                    assert any(d in m.group(2) for d in DISCIPLINES), line
    assert n_sync >= 20


def test_cli_exit_codes(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    mod = "traffic_classifier_sdn_tpu_torch.analysis_static"
    dirty = tmp_path / "dirty.py"
    dirty.write_text(textwrap.dedent(jt.ATOMIC_POSITIVE), encoding="utf-8")
    sarif_path = tmp_path / "findings.sarif"
    found = subprocess.run(
        [sys.executable, "-m", mod, "--json", "--sarif", str(sarif_path),
         str(dirty)],
        capture_output=True, text=True, env=env, cwd=REPO_ROOT,
    )
    assert found.returncode == 1
    report = json.loads(found.stdout)
    assert report["schema_version"] == 2
    assert report["count"] == 1
    assert report["findings"][0]["rule"] == "atomic-io"
    sarif = json.loads(sarif_path.read_text(encoding="utf-8"))
    assert sarif["version"] == "2.1.0"
    run = sarif["runs"][0]
    assert run["tool"]["driver"]["informationUri"] == (
        "docs/TORCH_STATIC_ANALYSIS.md")
    assert run["results"][0]["ruleId"] == "atomic-io"

    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n", encoding="utf-8")
    ok = subprocess.run([sys.executable, "-m", mod, str(clean)],
                        capture_output=True, text=True, env=env,
                        cwd=REPO_ROOT)
    assert ok.returncode == 0 and "clean" in ok.stdout

    empty_select = subprocess.run(
        [sys.executable, "-m", mod, "--select=,", str(clean)],
        capture_output=True, text=True, env=env, cwd=REPO_ROOT,
    )
    assert empty_select.returncode == 2
    unknown = subprocess.run(
        [sys.executable, "-m", mod, "--select=no-such", str(clean)],
        capture_output=True, text=True, env=env, cwd=REPO_ROOT,
    )
    assert unknown.returncode == 2
    not_py = tmp_path / "script.sh"
    not_py.write_text("echo hi\n", encoding="utf-8")
    usage = subprocess.run([sys.executable, "-m", mod, str(not_py)],
                           capture_output=True, text=True, env=env,
                           cwd=REPO_ROOT)
    assert usage.returncode == 2


def test_every_rule_has_fixture_coverage():
    covered = {
        "jit-purity", "retrace-hazard", "ctypes-abi", "lock-discipline",
        "fault-site-registry", "atomic-io",
        "lock-order", "blocking-under-lock", "thread-lifecycle",
        "implicit-sync", "transfer-discipline", "donation-hazard",
        "sync-under-lock",
    }
    assert set(ALL_IDS) == covered
