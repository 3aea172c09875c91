"""Gaussian naive Bayes predict as a closed-form log-probability — the
torch port of ``traffic_classifier_sdn_tpu/models/gnb.py``.

Joint log likelihood per class c:

    log P(c) − ½ Σ_f [ log(2π σ²_cf) + (x_f − θ_cf)² / σ²_cf ]

The per-class constant (log prior − ½ Σ log 2πσ²) and the reciprocal
variances are folded at import time in float64 and rounded once to
float32, as the JAX ``from_numpy`` does, so predict is two broadcast
multiplies and a reduction over the 12 features. Plain torch ops on the
card too: the JAX package computes this in XLA, in no hand-written
kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .base import argmax_labels


def fold(d) -> dict:
    """The importer dict (``theta``, ``var``, ``class_prior``) folded into
    float64 ``theta``/``inv_var``/``log_const``. An absent class (prior
    0: a fit that saw none of its rows) gets zero mean and precision and a
    ``-inf`` score, so it never wins the argmax and its NaN moments cannot
    reach the present classes."""
    theta = np.asarray(d["theta"], dtype=np.float64)
    var = np.asarray(d["var"], dtype=np.float64)
    prior = np.asarray(d["class_prior"], dtype=np.float64)
    present = prior > 0.0
    safe_prior = np.where(present, prior, 1.0)
    safe_var = np.where(present[:, None], var, 1.0)
    log_const = np.where(
        present,
        np.log(safe_prior)
        - 0.5 * np.sum(np.log(2.0 * math.pi * safe_var), axis=1),
        -np.inf,
    )
    return {
        "theta": np.where(present[:, None], theta, 0.0),
        "inv_var": np.where(present[:, None], 1.0 / safe_var, 0.0),
        "log_const": log_const,
    }


class GnbModel(nn.Module):
    STATIC_FIELDS = ()  # non-array checkpoint fields

    def __init__(self, theta, inv_var, log_const):
        super().__init__()
        self.register_buffer("theta", theta)  # (C, F) f32 class means
        self.register_buffer("inv_var", inv_var)  # (C, F) f32 1/σ²
        self.register_buffer("log_const", log_const)  # (C,) f32

    @classmethod
    def from_numpy(cls, d, device=None) -> "GnbModel":
        """Build from an importer dict (``theta``, ``var``,
        ``class_prior``) on ``device`` (default CUDA, see device.py)."""
        device = resolve_device(device)
        return cls(**{
            k: torch.tensor(a, dtype=torch.float32, device=device)
            for k, a in fold(d).items()
        })

    def scores(self, X: torch.Tensor) -> torch.Tensor:
        """Joint log likelihood, (N, C)."""
        diff = X[:, None, :] - self.theta[None, :, :]  # (N, C, F)
        quad = torch.sum(diff * diff * self.inv_var[None, :, :], dim=-1)
        return self.log_const[None, :] - 0.5 * quad

    def predict(self, X: torch.Tensor) -> torch.Tensor:
        return argmax_labels(self.scores(X))

    def predict_scores(self, X: torch.Tensor):
        """(labels, log-likelihood scores) from one score computation."""
        s = self.scores(X)
        return argmax_labels(s), s

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return self.predict(X)
