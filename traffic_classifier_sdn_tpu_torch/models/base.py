"""Label helpers shared by the model families: the argmax that turns
scores into class indices, and the host-side decode (a copy of
``ClassList`` from ``traffic_classifier_sdn_tpu/models/base.py``).

Class *labels* (strings) never enter device code; ``ClassList`` decodes
the (N,) int32 indices a family's ``predict`` returns."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def argmax_labels(scores: torch.Tensor) -> torch.Tensor:
    """(N,) int32 argmax over the last axis, as ``jnp.argmax`` picks it:
    the first maximum wins, and a NaN counts as the maximum (the first
    NaN of the row)."""
    return torch.argmax(scores, dim=-1).to(torch.int32)


@dataclass(frozen=True)
class ClassList:
    """Host-side label decode: every model carries its own class list."""

    names: tuple

    def decode(self, indices) -> list:
        idx = np.asarray(indices).ravel()
        return [self.names[i] for i in idx]
