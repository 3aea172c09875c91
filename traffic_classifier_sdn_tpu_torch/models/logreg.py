"""Multinomial logistic-regression predict — the torch port of
``traffic_classifier_sdn_tpu/models/logreg.py``.

sklearn's ``LogisticRegression.predict`` is the argmax of the decision
function ``X @ coef.T + intercept``; softmax is monotonic, so the argmax
needs no normalization. One (N, 12) @ (12, C) float32 matmul: TF32 is off
(device.py), the counterpart of the JAX ``Precision.HIGHEST``. The JAX
package computes this in XLA, in no hand-written kernel, so the port
runs it as plain torch ops on the card too.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .base import argmax_labels


class LogregModel(nn.Module):
    STATIC_FIELDS = ()  # non-array checkpoint fields

    def __init__(self, coef, intercept):
        super().__init__()
        self.register_buffer("coef", coef)  # (C, F) f32
        self.register_buffer("intercept", intercept)  # (C,) f32

    @classmethod
    def from_numpy(cls, d, device=None) -> "LogregModel":
        """Build from an importer dict (``coef``, ``intercept``) on
        ``device`` (default CUDA, see device.py)."""
        device = resolve_device(device)

        def t(k):  # a copy: the caller's arrays may be read-only
            return torch.tensor(np.asarray(d[k]), dtype=torch.float32,
                                device=device)

        return cls(coef=t("coef"), intercept=t("intercept"))

    def scores(self, X: torch.Tensor) -> torch.Tensor:
        """Decision function, (N, C)."""
        return torch.matmul(X, self.coef.t()) + self.intercept

    def predict(self, X: torch.Tensor) -> torch.Tensor:
        return argmax_labels(self.scores(X))

    def predict_scores(self, X: torch.Tensor):
        """(labels, scores) from one score computation; ``argmax(scores)
        == predict`` by construction."""
        s = self.scores(X)
        return argmax_labels(s), s

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return self.predict(X)
