"""Carry model weights from the JAX package into the port.

The port never imports the JAX package; the caller hands over numpy
arrays (or objects whose attributes convert with ``np.asarray``, such as
the JAX ``Params`` dataclasses), and this module builds the port's
module from them. Tests use it to run the same weights through both
packages; together with ``io/checkpoint.save_model`` it converts a JAX
checkpoint into the port's format.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np

from .models.forest import PARAM_FIELDS, ForestModel


def forest_params_from_numpy(d, device=None) -> ForestModel:
    """The JAX forest parameters — its ``Params`` fields or importer dict —
    as the port's ``ForestModel`` on ``device`` (default CUDA).
    Thresholds pass through ``f32_safe_thresholds``, as in the JAX
    ``forest.from_numpy``."""
    def get(k):
        return d[k] if isinstance(d, Mapping) else getattr(d, k)

    fields = {k: np.asarray(get(k)) for k in PARAM_FIELDS}
    fields["max_depth"] = int(get("max_depth"))
    return ForestModel.from_numpy(fields, device=device)
