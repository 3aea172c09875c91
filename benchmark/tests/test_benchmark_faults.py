"""A run with the timed path broken underneath comes out not correct, and a
sound one correct: the comparison is shown to fail. Small CPU runs of the
cells (``small.py``); the faults are planted in the program at run time."""

from __future__ import annotations

import pytest
import torch

from harness import check
from small import run_small

CELLS = ["rf100.replay16x64k", "knn5_refit61k.replay16x64k"]
KERNEL = {"rf100.replay16x64k": "forest_kernel",
          "knn5_refit61k.replay16x64k": "knn_kernel"}


def _kernel_module(cell):
    import importlib

    return importlib.import_module(
        f"traffic_classifier_sdn_tpu_torch.ops.{KERNEL[cell]}")


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = run_small(cell, seed=2 ** 31 + 3)
    assert check.passed(out["checks"]), out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_leaves_the_table_unchanged(cell, monkeypatch):
    from traffic_classifier_sdn_tpu_torch.core import flow_table as ft

    real = ft.apply_wire_dirty
    calls = []

    def stuck(table, dirty, w):
        calls.append(1)
        if len(calls) <= 4:  # the set-up rounds (2 switches x 2 rounds)
            return real(table, dirty, w)
        return table, ft.mark_dirty_wire(dirty, w)

    monkeypatch.setattr(ft, "apply_wire_dirty", stuck)
    out = run_small(cell, seed=11)
    assert len(calls) > 4
    assert out["checks"]["feature_rows"][0] > 0
    assert not check.passed(out["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_left_out(cell, monkeypatch):
    mod = _kernel_module(cell)
    real = mod.predict

    def half(k, X):
        n = X.shape[0]
        lab = real(k, X[: n // 2])
        # the other half takes what the predicted half gave
        return torch.cat([lab, lab[: n - n // 2]])

    monkeypatch.setattr(mod, "predict", half)
    out = run_small(cell, seed=12)
    assert out["checks"]["label_rows"][0] > 0
    assert not check.passed(out["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_one_answer_altered_where_it_is_made(cell, monkeypatch):
    mod = _kernel_module(cell)
    real = mod.predict

    def altered(k, X):
        lab = real(k, X).clone()
        lab[0] = (lab[0] + 1) % 6
        return lab

    monkeypatch.setattr(mod, "predict", altered)
    out = run_small(cell, seed=13)
    assert out["checks"]["label_rows"][0] >= 1
    assert not check.passed(out["checks"])


def test_a_ranking_altered_in_the_render(monkeypatch):
    from traffic_classifier_sdn_tpu_torch.core import flow_table as ft

    real = ft.top_active_flags

    def swapped(table, n, floor):
        idx, valid, fa, ra = real(table, n, floor)
        return idx.flip(0), valid.flip(0), fa.flip(0), ra.flip(0)

    monkeypatch.setattr(ft, "top_active_flags", swapped)
    out = run_small("rf100.replay16x64k", seed=14)
    assert out["checks"]["render_rows"][0] > 0
    assert not check.passed(out["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_a_kernel_that_fails_under_the_degrade_ladder(cell, monkeypatch):
    """The ladder serves the host fallback, whose labels are right: only
    the ladder's own counts show that the kernel did not serve."""
    mod = _kernel_module(cell)
    real = mod.predict
    calls = []

    def failing(k, X):
        calls.append(1)
        if len(calls) <= 4:  # the set-up rounds
            return real(k, X)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(mod, "predict", failing)
    out = run_small(cell, seed=15)
    c = out["checks"]
    assert len(calls) > 4
    assert c["fallback_calls"][0] > 0 and c["rung_changes"][0] > 0
    assert c["label_rows"][0] == 0
    assert not check.passed(c)


def test_knn_similarities_one_precision_down(monkeypatch):
    """The kernel's lists in bfloat16: the labels stay right, the lists
    do not."""
    from traffic_classifier_sdn_tpu_torch.ops import knn_kernel

    real = knn_kernel.topk_sim_idx

    def low(g, X):
        sims, idx = real(g, X)
        return sims.to(torch.bfloat16).float(), idx

    monkeypatch.setattr(knn_kernel, "topk_sim_idx", low)
    out = run_small("knn5_refit61k.replay16x64k", seed=16)
    c = out["checks"]
    assert c["topk_rows"][0] > 0 and c["label_rows"][0] == 0
    assert not check.passed(c)


def test_knn_search_over_part_of_the_corpus(monkeypatch):
    """The kernel's neighbours taken from the first half of the corpus."""
    import dataclasses

    from traffic_classifier_sdn_tpu_torch.ops import knn_kernel

    real = knn_kernel.topk_sim_idx

    def part(g, X):
        half = g.n_rows // 2
        fields = {f.name: getattr(g, f.name) for f in dataclasses.fields(g)}
        fields.update(n_rows=half, records=g.records[:half],
                      fit_X=g.fit_X[:half], half_sq=g.half_sq[:half],
                      fit_y=g.fit_y[:half])
        return real(type(g)(**fields), X)

    monkeypatch.setattr(knn_kernel, "topk_sim_idx", part)
    out = run_small("knn5_refit61k.replay16x64k", seed=17)
    assert out["checks"]["topk_rows"][0] > 0
    assert not check.passed(out["checks"])
