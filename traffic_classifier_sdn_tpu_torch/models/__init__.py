"""The six classifier families of the port (random forest, KNN, RBF-SVC,
logistic regression, Gaussian naive Bayes, k-means) and the serving-path
resolution — the torch counterpart of
``traffic_classifier_sdn_tpu/models/__init__.py``.

Registry keys mirror the reference's CLI subcommands under normalized
names. A family's params are an ``nn.Module`` whose buffers are the
checkpoint arrays; ``LoadedModel.serving_path`` resolves the
serving-optimized ``(predict_fn, params)`` pair.
"""

from __future__ import annotations

import copy
from collections.abc import Callable
from dataclasses import dataclass
from typing import Any

from . import forest, gnb, kmeans, knn, logreg, svc
from .base import ClassList

MODEL_CLASSES = {
    "logreg": logreg.LogregModel,
    "gnb": gnb.GnbModel,
    "kmeans": kmeans.KmeansModel,
    "knn": knn.KnnModel,
    "svc": svc.SvcModel,
    "forest": forest.ForestModel,
}
# the families whose serving predict has a hand-written CUDA kernel; the
# others serve their module's plain torch predict
KERNEL_FAMILIES = ("forest", "knn", "svc")

# reference CLI subcommand → normalized model name (traffic_classifier.py:189;
# both 'knearest' and 'kneighbors' accepted, as in the JAX package)
SUBCOMMAND_ALIASES = {
    "logistic": "logreg",
    "kmeans": "kmeans",
    "knearest": "knn",
    "kneighbors": "knn",
    "svm": "svc",
    "Randomforest": "forest",
    "randomforest": "forest",
    "gaussiannb": "gnb",
}


def module_predict(params, X):
    """The serving predict of a family without a kernel: its module's
    plain torch ``predict`` (logreg, gnb, kmeans)."""
    return params.predict(X)


def _build_serving_path(name: str, params) -> tuple[Callable, Any]:
    """(predict_fn, params) for full-table serving. The kernel families
    serve through their kernel module — on CUDA tensors the hand-written
    kernel, on CPU tensors its plain version:

    - forest: ops/forest_kernel, the selector compiled at the framework's
      fixed 12-column feature width (a forest whose trees never split on
      the last feature still sees the full matrix);
    - knn: ops/knn_kernel, the exact top-k (the JAX default ``sort``
      tier's semantics; the ``--knn-topk`` menu is not ported);
    - svc: ops/rbf_kernel, the two-float difference form (the JAX default
      ``TCSDN_SVC_KERNEL=chunked``; ``dot`` is not ported);
    - logreg, gnb, kmeans: the module's own predict, plain torch ops on
      either device (the JAX package serves their XLA predict)."""
    if name in MODEL_CLASSES and name not in KERNEL_FAMILIES:
        return module_predict, params
    if name == "forest":
        from ..core.features import NUM_FEATURES
        from ..ops import forest_kernel as mod

        operands = mod.compile_forest(
            params.node_arrays(), n_features=NUM_FEATURES,
            device=params.left.device,
        )
    elif name == "knn":
        from ..ops import knn_kernel as mod

        operands = mod.compile_knn(params)
    elif name == "svc":
        from ..ops import rbf_kernel as mod

        operands = mod.compile_svc(params)
    else:
        raise ValueError(f"no serving path for model family {name!r}")
    if next(params.buffers()).device.type == "cuda":
        # build and load the kernel here, at model load: a kernel that does
        # not build raises before any serve (or degrade ladder) exists
        mod._launcher()
    return mod.predict, operands


@dataclass(frozen=True)
class ServingFallback:
    """A degraded-rung predict: ``predict(X) -> labels`` as a plain host
    call on host (numpy) features with the params baked in, the kind the
    ladder reports, and ``scores(X) -> (N, C)``, the rung's score surface
    (``argmax(scores) == predict``)."""

    predict: Callable
    kind: str
    scores: Callable | None = None


def resolve_fallback(name: str, params) -> ServingFallback | None:
    """The degrade ladder's per-family host rung (serving/degrade.py): what
    still classifies when the card's dispatch stalls or errors.

    - forest / knn: the native C++ host evaluators of this package
      (native/forest_eval.cpp, native/knn_eval.cpp);
    - svc, logreg, gnb, kmeans, and forest / knn where g++ cannot build
      those: the family's plain torch version on the CPU, with the params
      copied to the CPU once here, so a sick card is never entered again.
      For a kernel family it is the kernel module's CPU path: the KNN and
      SVC plain versions run over
      65,536-row slices, so a table of 2²⁰ rows never builds an (N, S)
      matrix. This is the counterpart of the JAX package's eager-CPU
      fallback.

    The feature matrix itself still comes from the card's flow table, so
    a total loss of the card also stalls the feature fetch, which the
    ladder bounds with its deadline (the BROKEN rung)."""
    import numpy as np
    import torch

    if name == "forest":
        from ..native import forest as native_forest

        if native_forest.available():
            from ..core.features import NUM_FEATURES

            nf = native_forest.NativeForest(
                dict(params.node_arrays(), n_features=NUM_FEATURES)
            )
            return ServingFallback(
                lambda X: nf.predict(np.asarray(X, np.float32)),
                "native-forest",
                scores=lambda X: nf.predict_proba(np.asarray(X, np.float32)),
            )
    if name == "knn":
        from ..native import knn as native_knn

        if native_knn.available():
            hk = native_knn.NativeKnn({
                "fit_X": params.fit_X.cpu().numpy(),
                "y": params.fit_y.cpu().numpy(),
                "n_neighbors": params.n_neighbors,
                "classes": np.arange(params.n_classes),
            })
            return ServingFallback(
                lambda X: hk.predict(np.asarray(X, np.float32)),
                "native-knn",
                scores=lambda X: hk.votes(np.asarray(X, np.float32)),
            )
    if name not in MODEL_CLASSES:
        return None
    from ..ops import forest_kernel, knn_kernel, rbf_kernel

    predict, operands = _build_serving_path(
        name, copy.deepcopy(params).to("cpu")
    )
    scores = {"forest": forest_kernel.forest_proba, "knn": knn_kernel.scores,
              "svc": rbf_kernel.scores}.get(name, lambda p, X: p.scores(X))

    def plain_cpu(X):
        Xc = torch.from_numpy(np.ascontiguousarray(X, np.float32))
        return predict(operands, Xc).numpy()

    def plain_cpu_scores(X):
        Xc = torch.from_numpy(np.ascontiguousarray(X, np.float32))
        return scores(operands, Xc).numpy()

    return ServingFallback(plain_cpu, "plain-cpu", scores=plain_cpu_scores)


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
    """Assemble a LoadedModel (used by the checkpoint loader). A k-means
    model stored without class names decodes its cluster ids through
    ``kmeans.CLUSTER_LABELS_CHECKPOINT``."""
    if name == "kmeans" and classes is None:
        classes = ClassList(kmeans.CLUSTER_LABELS_CHECKPOINT)
    return LoadedModel(
        name=name,
        params=params,
        classes=classes,
        predict=params.predict,
        scores=params.scores,
    )
