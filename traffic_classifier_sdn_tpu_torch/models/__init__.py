"""Classifier families of the port (so far the random forest, KNN and
RBF-SVC) and the serving-path resolution — the torch counterpart of
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

from . import forest, knn, svc
from .base import ClassList

MODEL_CLASSES = {
    "forest": forest.ForestModel,
    "knn": knn.KnnModel,
    "svc": svc.SvcModel,
}

# reference CLI subcommand → normalized model name (traffic_classifier.py:189;
# both 'knearest' and 'kneighbors' accepted, as in the JAX package)
SUBCOMMAND_ALIASES = {
    "knearest": "knn",
    "kneighbors": "knn",
    "svm": "svc",
    "Randomforest": "forest",
    "randomforest": "forest",
}


def _build_serving_path(name: str, params) -> tuple[Callable, Any]:
    """(predict_fn, params) for full-table serving. Each family serves
    through its kernel module — on CUDA tensors the hand-written kernel,
    on CPU tensors its plain version:

    - forest: ops/forest_kernel, the selector compiled at the framework's
      fixed 12-column feature width (a forest whose trees never split on
      the last feature still sees the full matrix);
    - knn: ops/knn_kernel, the exact top-k (the JAX default ``sort``
      tier's semantics; the ``--knn-topk`` menu is not ported);
    - svc: ops/rbf_kernel, the two-float difference form (the JAX default
      ``TCSDN_SVC_KERNEL=chunked``; ``dot`` is not ported)."""
    if name == "forest":
        from ..core.features import NUM_FEATURES
        from ..ops import forest_kernel

        return forest_kernel.predict, forest_kernel.compile_forest(
            params.node_arrays(), n_features=NUM_FEATURES,
            device=params.left.device,
        )
    if name == "knn":
        from ..ops import knn_kernel

        return knn_kernel.predict, knn_kernel.compile_knn(params)
    if name == "svc":
        from ..ops import rbf_kernel

        return rbf_kernel.predict, rbf_kernel.compile_svc(params)
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
