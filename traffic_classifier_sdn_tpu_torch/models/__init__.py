"""Classifier families of the port (so far the random forest) and the
serving-path resolution — the torch counterpart of
``traffic_classifier_sdn_tpu/models/__init__.py``.

Registry keys mirror the reference's CLI subcommands under normalized
names. A family's params are an ``nn.Module`` whose buffers are the
checkpoint arrays; ``LoadedModel.serving_path`` resolves the
serving-optimized ``(predict_fn, params)`` pair.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass
from typing import Any

from . import forest
from .base import ClassList

MODEL_CLASSES = {
    "forest": forest.ForestModel,
}

# reference CLI subcommand → normalized model name (traffic_classifier.py:189)
SUBCOMMAND_ALIASES = {
    "Randomforest": "forest",
    "randomforest": "forest",
}


def _build_serving_path(name: str, params) -> tuple[Callable, Any]:
    """(predict_fn, params) for full-table serving. The forest serves
    through ops/forest_kernel: on CUDA tensors the hand-written kernel, on
    CPU tensors its plain version. The selector is compiled at the
    framework's fixed 12-column feature width (a forest whose trees never
    split on the last feature still sees the full matrix)."""
    if name == "forest":
        from ..core.features import NUM_FEATURES
        from ..ops import forest_kernel

        return forest_kernel.predict, forest_kernel.compile_forest(
            params.node_arrays(), n_features=NUM_FEATURES,
            device=params.left.device,
        )
    raise ValueError(f"no serving path for model family {name!r}")


@dataclass(frozen=True)
class LoadedModel:
    name: str
    params: Any
    classes: ClassList | None
    predict: Callable
    scores: Callable
    # lazily resolved serving pair — see serving_path()
    serve_params: Any = None
    serve_predict: Callable | None = None

    def serving_path(self) -> tuple[Callable, Any]:
        """The serving-optimized ``(predict_fn, params)`` pair, resolved
        as ONE unit and built lazily (checkpoint round-trips skip the
        kernel operand build)."""
        if self.serve_predict is None:
            fn, p = _build_serving_path(self.name, self.params)
            object.__setattr__(self, "serve_predict", fn)
            object.__setattr__(self, "serve_params", p)
        return self.serve_predict, self.serve_params


def make_loaded_model(name: str, params, classes) -> LoadedModel:
    """Assemble a LoadedModel (used by the checkpoint loader)."""
    return LoadedModel(
        name=name,
        params=params,
        classes=classes,
        predict=params.predict,
        scores=params.scores,
    )
