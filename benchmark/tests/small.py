"""Small copies of the cells for CPU runs: 2 switches of 256
conversations, a 600-row KNN corpus, the real forest."""

from __future__ import annotations

import copy
import json

import torch

from harness import cells
from harness.runner import run_cell


def small_cell(name: str, loop: str | None = None):
    """(config, traffic) of ``<config>.<traffic>``, found by the names of
    their files, cut to the small size; ``loop`` overrides the traffic's
    loop (``open``: 100 bursts a second)."""
    config_name, traffic_name = name.split(".", 1)
    with open(cells.BENCH_DIR / "configs" / f"{config_name}.json") as f:
        config = json.load(f)
    traffic = copy.deepcopy(cells.traffic(traffic_name))
    traffic.update(switches=2, conversations_per_switch=256, queue_depth=1,
                   trace_offset_bursts=4, trace_bursts=4, render_samples=8)
    if loop is not None:
        traffic["loop"] = loop
    if "corpus" in config:
        config["corpus"].update(rows=600, snapshots_per_conversation=4,
                                polls=16)
    if traffic["loop"] == "open":
        traffic["rate_bursts_per_s"] = 100.0
    return config, traffic


def run_small(name: str, seed: int, seconds: float = 1.0, trace=False,
              loop: str | None = None):
    config, traffic = small_cell(name, loop)
    return run_cell(config, traffic, seed, seconds, trace,
                    torch.device("cpu"), log=lambda s: None)
