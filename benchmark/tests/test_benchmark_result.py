"""The last line's keys, and what a run without a card prints."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from harness import cells
from harness.result import result_line
from small import run_small


@pytest.fixture(scope="module")
def small_out():
    return run_small("knn5_refit61k.replay16x64k", 21, 1.0, trace=True)


def test_untraced_line_keys(small_out):
    bench = cells.load_benchmark()
    dev = {"platform": "gpu", "kind": "x", "count": 1}
    line = result_line(bench, "knn5_refit61k.replay16x64k", small_out, False, dev)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"flows_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["correct"] is True
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    json.dumps(line)


def test_traced_line_keys(small_out):
    bench = cells.load_benchmark()
    dev = {"platform": "gpu", "kind": "x", "count": 1}
    line = result_line(bench, "knn5_refit61k.replay16x64k", small_out, True, dev)
    assert list(line)[-1] == "checks" and "breakdown" in line
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in cells.reported(
        bench, "knn5_refit61k.replay16x64k", "per_layer")}
    assert set(line["metrics"]) <= names
    assert {"ingest_ms.replay", "device_stage_ms.replay",
            "predict_rows.replay"} <= set(line["metrics"])
    assert line["metrics"]["predict_rows.replay"]["value"] == 256


def test_without_a_card_a_run_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "knn5_refit61k.replay16x64k", "--seed", "1", "--seconds", "1"],
        cwd=cells.ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout == ""


def test_without_the_program_a_run_prints_no_result(tmp_path):
    import shutil

    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cells.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "knn5_refit61k.replay16x64k", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
