"""Random-forest predict — the torch port of
``traffic_classifier_sdn_tpu/models/forest.py``.

A forest ``nn.Module`` holding the importer node arrays as buffers
(``left``/``right``/``feature``/``threshold``/``values``, (T, M) each,
``values`` (T, M, C)). ``scores``/``predict`` run the gather traversal
(ops/tree_eval.py), the semantic reference; serving goes through the CUDA
forest kernel instead (models/__init__._build_serving_path).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..io.sklearn_import import f32_safe_thresholds
from ..ops import tree_eval

PARAM_FIELDS = ("left", "right", "feature", "threshold", "values")


class ForestModel(nn.Module):
    STATIC_FIELDS = ("max_depth",)  # non-array checkpoint fields

    def __init__(self, left, right, feature, threshold, values,
                 max_depth: int):
        super().__init__()
        self.register_buffer("left", left)  # (T, M) int32
        self.register_buffer("right", right)  # (T, M) int32
        self.register_buffer("feature", feature)  # (T, M) int32
        self.register_buffer("threshold", threshold)  # (T, M) f32
        self.register_buffer("values", values)  # (T, M, C) leaf class counts
        self.max_depth = int(max_depth)

    @classmethod
    def from_numpy(cls, d, device=None) -> "ForestModel":
        """Build from an importer dict (or the JAX ``Params`` fields as
        numpy arrays) on ``device`` (default CUDA, see device.py). Thresholds go through ``f32_safe_thresholds``:
        sklearn compares f32 features against f64 midpoint thresholds, and
        round-down keeps every decision identical in pure f32 (the
        rounding is the identity on thresholds that already are f32)."""
        device = resolve_device(device)
        thr = f32_safe_thresholds(np.asarray(d["threshold"], np.float64))

        def t(a, dtype):  # a copy: the caller's arrays may be read-only
            return torch.tensor(np.asarray(a), dtype=dtype, device=device)

        return cls(
            left=t(d["left"], torch.int32),
            right=t(d["right"], torch.int32),
            feature=t(d["feature"], torch.int32),
            threshold=t(thr, torch.float32),
            values=t(d["values"], torch.float32),
            max_depth=int(d["max_depth"]),
        )

    def node_arrays(self) -> dict:
        """The node arrays as host numpy (the operand builders' input)."""
        return {k: getattr(self, k).cpu().numpy() for k in PARAM_FIELDS}

    def scores(self, X: torch.Tensor) -> torch.Tensor:
        """Ensemble-averaged class probabilities, (N, C)."""
        return tree_eval.forest_proba(
            self.left, self.right, self.feature, self.threshold,
            self.values, X, self.max_depth,
        )

    def predict(self, X: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.scores(X), dim=-1).to(torch.int32)

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return self.predict(X)
