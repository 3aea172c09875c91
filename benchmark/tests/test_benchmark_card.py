"""On the card: a small run of each cell through the kernels is correct and
its trace names the family's kernel. Skips without a CUDA device."""

from __future__ import annotations

import pytest
import torch

from harness import cells, check, profile
from harness.runner import run_cell
from small import small_cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only there")
    return torch.device("cuda", 0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell,kernel", [("rf100.replay16x64k", "forest_proba"),
                                         ("knn5_refit61k.replay16x64k", "knn_topk")])
def test_small_run_on_the_card(card, cell, kernel):
    config, traffic = small_cell(cell)
    out = run_cell(config, traffic, 9, 1.0, True, card, log=lambda s: None)
    assert check.passed(out["checks"]), out["checks"]
    trace = out["run"].trace
    assert trace is not None and trace["busy_s"] > 0
    assert profile.kernel_seconds(trace, kernel)
    assert cells.reader("device_idle_share.replay")(out["run"]) is not None


@pytest.mark.requires_cuda
def test_a_predict_off_the_kernel_is_not_correct_in_a_traced_run(card, monkeypatch):
    """The forest served by its plain PyTorch version on the card: labels
    right, but the trace holds no forest kernel."""
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel

    def plain(k, X):
        return torch.argmax(forest_kernel.forest_proba_plain(k, X),
                            dim=-1).to(torch.int32)

    monkeypatch.setattr(forest_kernel, "predict", plain)
    config, traffic = small_cell("rf100.replay16x64k")
    out = run_cell(config, traffic, 10, 1.0, True, card, log=lambda s: None)
    assert out["checks"]["kernel_absent_from_trace"][0] == 1
    assert not check.passed(out["checks"])
