"""``tools/torch_doctor.py`` against ``tools/tpu_doctor.py`` on the CPU.

Both doctors run in subprocesses on the same flags at a small size. The
port's bundle has JAX's keys and check ids in JAX's order, and on the CPU
every check's status equals JAX's: platform, compile, retrace, transfers
and cadence pass, hbm skips. What the port's checks read differs by
design (see the tool's docstring): compile times the kernels' build and
the warmup where JAX counts XLA compiles, and retrace watches kernel
library loads and, on a card, allocator segments where JAX counts
compiles; on the CPU neither can fail for a reason JAX's could not, so
the statuses agree. A forced ``--cadence-budget-s 0`` fails with a
non-zero exit and still writes its ``--out`` bundle; a missing sync budget
skips ``transfers``; ``--platform default``, which is also what no flags
mean, fails its platform check on a machine without a card and runs
nothing on the CPU.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = ["--capacity", "1024", "--flows-per-tick", "128", "--ticks", "3",
         "--table-rows", "16"]
IDS = ["platform", "compile", "retrace", "hbm", "transfers", "cadence"]


def _doctor(tool, tmp_path, *extra, env=None):
    out = tmp_path / f"{tool}.json"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / f"{tool}.py"), *SMALL,
         *extra, "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu", **(env or {})},
    )
    bundle = json.loads(out.read_text()) if out.exists() else None
    return proc, bundle


def test_cpu_bundle_has_jax_ids_order_keys_and_statuses(tmp_path):
    proc, got = _doctor("torch_doctor", tmp_path, "--platform", "cpu",
                        "--expect", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    jproc, want = _doctor("tpu_doctor", tmp_path, "--platform", "cpu",
                          "--expect", "cpu")
    assert jproc.returncode == 0, jproc.stderr[-3000:]
    assert [c["id"] for c in got["checks"]] == IDS
    assert [c["id"] for c in want["checks"]] == IDS
    assert set(got) == set(want)
    assert got["metric"] == "torch_doctor" and want["metric"] == "tpu_doctor"
    assert got["config"] == want["config"]
    assert [c["status"] for c in got["checks"]] == [
        c["status"] for c in want["checks"]]
    assert (got["verdict"], got["platform"], got["failed_checks"],
            got["skipped_checks"]) == (want["verdict"], want["platform"],
                                       want["failed_checks"],
                                       want["skipped_checks"])
    assert got["skipped_checks"] == ["hbm"]
    # the bundle on stdout is the one written to --out
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == got
    checks = {c["id"]: c for c in got["checks"]}
    assert checks["compile"]["kernels"] is None
    assert checks["retrace"]["library_loads"] == 0
    assert checks["transfers"]["unknown_syncs"] == []
    assert checks["transfers"]["d2h_syncs_observed"] > 0


def test_forced_cadence_failure_exits_nonzero_and_writes_the_bundle(
        tmp_path):
    proc, got = _doctor("torch_doctor", tmp_path, "--platform", "cpu",
                        "--expect", "cpu", "--cadence-budget-s", "0")
    assert proc.returncode != 0
    assert "torch_doctor: FAIL — cadence" in proc.stderr
    assert got["verdict"] == "fail" and got["failed_checks"] == ["cadence"]
    assert [c["id"] for c in got["checks"]] == IDS


def test_missing_sync_budget_skips_transfers(tmp_path):
    proc, got = _doctor(
        "torch_doctor", tmp_path, "--platform", "cpu", "--expect", "cpu",
        env={"TCSDN_TORCH_SYNC_BUDGET": str(tmp_path / "absent.json")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    checks = {c["id"]: c for c in got["checks"]}
    assert checks["transfers"]["status"] == "skip"
    assert "torch_hot_path_sync_budget.json missing" in \
        checks["transfers"]["detail"]
    assert got["skipped_checks"] == ["hbm", "transfers"]


def test_default_platform_without_a_card_fails_and_never_runs_on_the_cpu(
        tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --platform default runs on it")
    proc, got = _doctor("torch_doctor", tmp_path, "--platform", "default",
                        "--expect", "gpu")
    assert proc.returncode != 0
    assert got["verdict"] == "fail" and got["failed_checks"] == ["platform"]
    assert got["platform"] == "none" and got["device"] is None
    assert [c["id"] for c in got["checks"]] == IDS
    assert all(c["status"] == "skip" for c in got["checks"][1:])


def test_no_flags_mean_the_card_and_fail_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default platform runs on it")
    proc, got = _doctor("torch_doctor", tmp_path)
    assert proc.returncode != 0
    assert got["verdict"] == "fail" and got["failed_checks"] == ["platform"]
    assert got["config"]["expect"] == "gpu"
    assert got["platform"] == "none" and got["device"] is None
