"""The control, the reference in the program's place one precision down
(bfloat16), fails the comparison: at a small size here, at the cells' own
size on the card (``benchmark/control.py``; the readings are in PERF.md)."""

from __future__ import annotations

import pytest
import torch

from harness import check
from harness.control import readings
from small import small_cell


@pytest.mark.parametrize("cell", ["rf100.replay16x64k",
                                  "knn5_refit61k.replay16x64k"])
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7])
def test_the_control_fails(cell, seed):
    config, traffic = small_cell(cell)
    r = readings(config, traffic, seed, 40, torch.device("cpu"))
    assert not check.passed(r)
    assert r["feature_rows"][0] > r["feature_rows"][1]
    assert r["render_rows"][0] > r["render_rows"][1]


def test_the_reference_agrees_with_itself():
    config, traffic = small_cell("knn5_refit61k.replay16x64k")
    config["limits"] = dict(config["limits"])
    from harness import cells
    from harness.traffic import Generator, TrafficSpec

    spec = TrafficSpec(traffic)
    gen = Generator(spec, 3)
    for b in range(12):
        gen.burst(b)
    model = cells.family("reference", "knn").load(config, 3, cells.ROOT)
    a = check.reference_view(gen, spec, model, torch.device("cpu"), 11, [], 64)
    b = check.reference_view(gen, spec, model, torch.device("cpu"), 11, [], 64)
    meta = check.expected_meta(spec, check.meta_slots(spec, 3))
    a.update(dropped=0, parse_errors=0)
    assert check.passed(check.compare(a, b, meta, meta, config["limits"], 0))


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7])
def test_the_kernel_alone_one_precision_down_fails(seed):
    """The KNN kernel's arithmetic in bfloat16 on the float32 features: the
    labels barely move, the (similarity, index) lists do."""
    config, traffic = small_cell("knn5_refit61k.replay16x64k")
    r = readings(config, traffic, seed, 40, torch.device("cpu"),
                 kernel_only=True)
    assert r["feature_rows"][0] == 0
    assert r["topk_rows"][0] > r["topk_rows"][1]
    assert not check.passed(r)
