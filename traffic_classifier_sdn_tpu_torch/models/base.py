"""Host-side label decode shared by the model families (a copy of
``ClassList`` from ``traffic_classifier_sdn_tpu/models/base.py``).

Class *labels* (strings) never enter device code; ``ClassList`` decodes
the (N,) int32 indices a family's ``predict`` returns."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ClassList:
    """Host-side label decode: every model carries its own class list."""

    names: tuple

    def decode(self, indices) -> list:
        idx = np.asarray(indices).ravel()
        return [self.names[i] for i in idx]
