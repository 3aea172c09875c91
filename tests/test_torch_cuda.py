"""Card-only checks of the port (``requires_cuda``): the CUDA forest
kernel against its plain version, and the CUDA flow table and serve
against the same code on the CPU. The CPU side is held to the JAX
reference by the other ``test_torch_*`` files, so these carry that parity
onto the card.

This file imports nothing of JAX, so it runs on a machine with a card and
no JAX: ``python -m pytest --noconftest -m requires_cuda
tests/test_torch_cuda.py`` (``--noconftest`` skips ``tests/conftest.py``,
which configures JAX). Without a card every test skips.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from __graft_entry__ import _synth_forest
from traffic_classifier_sdn_tpu_torch import cli, interop
from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows
from traffic_classifier_sdn_tpu_torch.io import checkpoint
from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    return torch.device("cuda")


def _forests():
    """Stumps, a root-leaf tree, a reference-shaped random forest, and a
    deep one (up to 150 internal nodes per tree, depth up to 20)."""
    rng = np.random.RandomState(0)
    sample = (rng.gamma(1.0, 100.0, (2000, 12))).astype(np.float32)
    root_leaf = _synth_forest(n_trees=3)
    root_leaf["left"][1] = -1
    root_leaf["right"][1] = -1
    return {
        "stumps": _synth_forest(),
        "root_leaf": root_leaf,
        "random": chip_smoke.random_forest(1, sample, n_trees=40),
        "deep": chip_smoke.random_forest(
            2, sample, n_trees=10, node_count=(129, 301), max_depth=20
        ),
    }


@pytest.mark.parametrize("name", ["stumps", "root_leaf", "random", "deep"])
def test_kernel_bitwise_equals_plain(cuda, name):
    d = _forests()[name]
    k = fk.compile_forest(d, n_features=12, device=cuda)
    rng = np.random.RandomState(3)
    X = (rng.gamma(1.0, 100.0, (777, 12))).astype(np.float32)
    # some inputs exactly on split thresholds (the <= edge)
    internal = np.argwhere(d["left"] != -1)
    for i, (t, n) in enumerate(internal[:300]):
        X[i, d["feature"][t, n]] = np.float32(d["threshold"][t, n])
    Xc = torch.from_numpy(X).to(cuda)
    launches = fk.forest_proba.launches
    got = fk.forest_proba(k, Xc)
    torch.cuda.synchronize()
    assert fk.forest_proba.launches == launches + 1
    assert torch.equal(got, fk.forest_proba_plain(k, Xc))
    cpu = fk.compile_forest(d, n_features=12, device="cpu")
    np.testing.assert_array_equal(
        got.cpu().numpy().view(np.uint32),
        fk.forest_proba(cpu, torch.from_numpy(X)).numpy().view(np.uint32),
    )


def test_wrapper_on_card(cuda):
    k = fk.compile_forest(_synth_forest(), n_features=12, device=cuda)
    launches = fk.forest_proba.launches
    assert fk.forest_proba(k, torch.zeros((0, 12), device=cuda)).shape == (0, 6)
    assert fk.forest_proba.launches == launches  # no rows, no launch
    with pytest.raises(ValueError, match="operands"):
        fk.forest_proba(k, torch.zeros((4, 12)))
    with pytest.raises(ValueError, match="contiguous"):
        fk.forest_proba(k, torch.zeros((12, 4), device=cuda).t())


def test_flow_table_cuda_bitwise_equals_cpu(cuda):
    """The same synthetic wires through the table on both devices."""
    wires = []
    syn = SyntheticFlows(n_flows=3000, seed=4)
    for k in range(4):
        wires.append(chip_smoke.tick_wire(syn, k == 0))
    tables = {d: ft.make_table(4096, d) for d in ("cpu", cuda)}
    for w in wires:
        for d in tables:
            tables[d] = ft.apply_wire(tables[d], ft.wire_tensor(w, d))
    clear = torch.tensor([5, 17, 4096, 4096])
    for d in tables:
        tables[d] = ft.clear_slots(tables[d], clear.to(d))
    a, b = tables["cpu"], tables[cuda]
    for d in ("fwd", "rev"):
        for f in dataclasses.fields(ft.DirState):
            x = getattr(getattr(a, d), f.name)
            y = getattr(getattr(b, d), f.name).cpu()
            assert torch.equal(x, y), f"{d}.{f.name}"
    assert torch.equal(ft.features12(a), ft.features12(b).cpu())
    ra = ft.top_active_render(a, torch.zeros(4096, dtype=torch.int32), 64, 2)
    rb = ft.top_active_render(
        b, torch.zeros(4096, dtype=torch.int32, device=cuda), 64, 2
    )
    for x, y in zip(ra, rb):
        assert torch.equal(x, y.cpu())


def test_serve_on_card_prints_what_the_cpu_serve_prints(cuda, tmp_path, capsys):
    """The port CLI on CUDA (kernel path) and on the CPU (plain path) print
    the same tables; the kernel launches once per render tick."""
    table = chip_smoke.synthetic_table(300, 2, "cpu")
    d = chip_smoke.random_forest(0, ft.features12(table).numpy(), n_trees=16)
    checkpoint.save_model(
        str(tmp_path), "forest", interop.forest_params_from_numpy(d, "cpu"),
        classes=chip_smoke.CLASSES,
    )
    argv = ["Randomforest", "--native-checkpoint", str(tmp_path),
            "--source", "synthetic", "--synthetic-flows", "300",
            "--capacity", "512", "--max-ticks", "4", "--print-every", "2"]
    launches = fk.forest_proba.launches
    summary = cli.main(argv)  # CUDA by default
    on_card = capsys.readouterr().out
    assert fk.forest_proba.launches == launches + len(summary.render_ticks) == launches + 2
    cli.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out == on_card
