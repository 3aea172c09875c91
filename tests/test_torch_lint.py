"""``tools/torch_lint.sh``: on the port's package the gate exits 0 with
graftlint ``pass`` (ruff and mypy ``skipped`` where they are not
installed) and writes its JSON summary and SARIF copy; on a path holding
one violating fixture it exits non-zero and the summary carries the
finding."""

import json
import os
import pathlib
import subprocess
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "tools" / "torch_lint.sh"

pytestmark = pytest.mark.lint

VIOLATION = """
    import threading
    import torch


    class Gate:
        def __init__(self):
            self._lock = threading.Lock()
            self._count = torch.zeros((), dtype=torch.int32, device="cuda")

        def drain(self):
            with self._lock:
                return int(self._count)
"""


def _lint(tmp_path, *paths):
    summary, sarif = tmp_path / "summary.json", tmp_path / "sarif.json"
    proc = subprocess.run(
        ["sh", str(SCRIPT), *paths], cwd=ROOT, capture_output=True,
        text=True, timeout=600,
        env={**os.environ, "LINT_SUMMARY": str(summary),
             "LINT_SARIF": str(sarif), "TMPDIR": str(tmp_path)},
    )
    return proc, json.loads(summary.read_text()), sarif


def _status(summary):
    return {t["name"]: t["status"] for t in summary["tools"]}


def test_package_passes_the_gate(tmp_path):
    proc, summary, sarif = _lint(tmp_path)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    status = _status(summary)
    assert status["graftlint"] == "pass" and summary["ok"] is True
    assert status["ruff"] in ("pass", "skipped")
    assert status["mypy"] in ("pass", "skipped")
    graft = summary["tools"][0]
    assert graft["findings"] == [] and len(graft["rules"]) == 13
    assert graft["sarif"] == str(sarif) and sarif.exists()


def test_violating_fixture_fails_the_gate(tmp_path):
    fixture = tmp_path / "fixture"
    fixture.mkdir()
    (fixture / "gate.py").write_text(textwrap.dedent(VIOLATION))
    proc, summary, _ = _lint(tmp_path, str(fixture))
    assert proc.returncode != 0
    assert _status(summary)["graftlint"] == "fail" and not summary["ok"]
    assert [f["rule"] for f in summary["tools"][0]["findings"]] == [
        "sync-under-lock"]
    assert "torch lint: FAILURES" in proc.stderr
