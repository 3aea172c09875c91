"""The harness finds every piece of a cell by name, and a new cell is new
files and entries."""

from __future__ import annotations

import json
import re
import shutil

import pytest
import torch

from harness import cells
from harness.runner import run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return cells.load_benchmark()


def test_benchmark_file_has_the_contract_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                  "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


@pytest.mark.parametrize(
    "cell", [w["name"] for w in cells.load_benchmark()["workloads"]])
def test_every_cell_finds_its_files(bench, cell):
    w = cells.workload(bench, cell)
    config = cells.config(bench, w["config"])
    traffic = cells.traffic(w["traffic"])
    assert traffic["name"] == w["traffic"] and config["name"] == w["config"]
    assert hasattr(cells.family("families", config["family"]), "build")
    assert hasattr(cells.family("reference", config["family"]), "load")
    e2e = [m["name"] for m in cells.reported(bench, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = cells.reported(bench, cell, "per_layer")
    assert layer
    for m in layer:
        assert m["moves"] in e2e
        assert callable(cells.reader(m["name"]))


def test_every_per_layer_metric_has_a_reader(bench):
    for m in bench["per_layer"]:
        assert (cells.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()


def test_a_new_cell_is_files_and_entries(bench, tmp_path):
    """A cell, a traffic mix and a metric added as files and entries only,
    in a copy of the benchmark, run with the harness as it is."""
    root = tmp_path
    shutil.copytree(cells.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    bench = json.loads(json.dumps(bench))
    traffic = cells.traffic("replay16x64k")
    traffic.update(name="tiny3x128", switches=3, conversations_per_switch=128,
                   queue_depth=1, render_samples=4)
    (root / "benchmark/traffic/tiny3x128.json").write_text(json.dumps(traffic))
    # the forest's configuration file, which no cell of BENCHMARK.json names
    config = json.loads((cells.BENCH_DIR / "configs/rf100.json").read_text())
    config["name"] = "rf100_copy"
    (root / "benchmark/configs/rf100_copy.json").write_text(json.dumps(config))
    (root / "benchmark/metrics/renders.tiny.py").write_text(
        "def read(run):\n    return float(run.frames)\n")
    bench["configs"].append({"name": "rf100_copy", "source": "x",
                             "file": "benchmark/configs/rf100_copy.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "rf100_copy.tiny3x128",
                               "config": "rf100_copy", "traffic": "tiny3x128",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "renders.tiny", "unit": "renders",
                               "better": "higher", "source": "program_counter",
                               "layer": "pipeline", "moves": "flows_per_s",
                               "workloads": ["rf100_copy.tiny3x128"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    b2 = cells.load_benchmark(root)
    w = cells.workload(b2, "rf100_copy.tiny3x128")
    cfg = cells.config(b2, w["config"], root)
    tr = cells.traffic(w["traffic"], root / "benchmark")
    out = run_cell(cfg, tr, 7, 0.5, False, torch.device("cpu"),
                   root=root, log=lambda s: None)
    assert all(v <= lim for v, lim in out["checks"].values())
    reader = cells.reader("renders.tiny", root / "benchmark")
    assert reader(out["run"]) >= 1
    assert [m["name"] for m in cells.reported(b2, w["name"], "per_layer")] == [
        m["name"] for m in bench["per_layer"]
        if w["name"] in m.get("workloads", [])]


def test_an_open_loop_times_every_burst_from_when_it_was_due():
    """A traffic file with ``"loop": "open"`` (a later cell's, as data only)
    offers bursts at its fixed rate and reports the label latencies."""
    from small import run_small

    out = run_small("knn5_refit61k.replay16x64k", 2 ** 31 + 5, 1.0,
                    loop="open")
    assert all(v <= lim for v, lim in out["checks"].values()), out["checks"]
    assert set(out["e2e"]) == {"setup_s", "label_p95_ms", "label_p50_ms"}
    assert 0 < out["e2e"]["label_p50_ms"][1] <= out["e2e"]["label_p95_ms"][1]
    assert 90 <= out["attempted"] <= 100  # due in one second at 100/s
