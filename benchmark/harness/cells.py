"""Finding what a cell is made of, by the names in ``BENCHMARK.json``: its
configuration (the file the entry names), its traffic mix
(``benchmark/traffic/<mix>.json``), the model family's two sides
(``benchmark/families/<family>.py`` for the program,
``benchmark/reference/<family>.py`` for the plain reference) and the reader
of each per-layer metric (``benchmark/metrics/<metric>.py``). A new cell or
metric is new files and entries; nothing here names one."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(bench_dir / "traffic" / f"{name}.json") as f:
        return json.load(f)


def family(side: str, name: str):
    """The module of a model family: ``side`` is ``families`` (the
    program's) or ``reference``."""
    if side not in ("families", "reference"):
        raise ValueError(side)
    return importlib.import_module(f"{side}.{name}")


def reader(metric: str, bench_dir: Path = BENCH_DIR):
    """The ``read(run)`` function of a per-layer metric's file."""
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reported(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    that list it, and those without a list whose moved metric the cell
    reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]
