"""The six classifier families of the port (random forest, KNN, RBF-SVC,
logistic regression, Gaussian naive Bayes, k-means) and the serving-path
resolution — the torch counterpart of
``traffic_classifier_sdn_tpu/models/__init__.py``.

Registry keys mirror the reference's CLI subcommands under normalized
names. A family's params are an ``nn.Module`` whose buffers are the
checkpoint arrays; ``LoadedModel.serving_path`` resolves the
serving-optimized ``(predict_fn, params)`` pair, through the JAX
package's serving menus (``--knn-topk``, ``TCSDN_SVC_KERNEL``,
``TCSDN_FOREST_KERNEL``).
"""

from __future__ import annotations

import copy
import functools
from collections.abc import Callable
from dataclasses import dataclass
from typing import Any

import numpy as np

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


# the --knn-topk / TCSDN_KNN_TOPK menu (the usage text of the CLI flag's
# error and of resolve_knn_topk's ValueError)
KNN_TOPK_CHOICES = (
    "sort, argmax, hier[<group>], screened[<group>], pallas, native, "
    "ivf[<nprobe>]"
)
_KNN_TOPK_WARNED: set[str] = set()
# TCSDN_FOREST_KERNEL values that are TPU layouts of the one function the
# port's forest kernel computes (the JAX package's GEMM forms and Pallas
# kernels); each serves through ops/forest_kernel.py
FOREST_KERNEL_LAYOUTS = ("gemm", "pallas", "pallas_fast", "gemm_v2_dot",
                         "gemm_v2_gather")


def resolve_knn_topk(value: str | None = None) -> str:
    """The serving KNN top-k tier: ``value`` (the ``--knn-topk`` flag) if
    given, else ``TCSDN_KNN_TOPK``, else ``sort``. An unknown name raises
    ``ValueError`` with the menu (the CLI turns it into a usage error);
    a numeric suffix is checked for shape here and for the corpus bounds
    (hier's group >= n_neighbors) when the serving path is built.

    The one resolution point, so the serving-semantics notes go to stderr
    here, once per process per tier: ``native`` ranks by exact float64
    distances and can differ from the float32 ranking on near-ties;
    ``ivf`` is the APPROXIMATE tier, an explicit opt-in."""
    import os
    import sys

    impl = value if value is not None else os.environ.get(
        "TCSDN_KNN_TOPK", "sort"
    )
    if impl not in ("sort", "argmax", "pallas", "native", "hier",
                    "screened", "ivf"):
        for prefix in ("screened", "hier", "ivf"):
            suffix = impl[len(prefix):]
            # a zero group or nprobe is valid for no corpus
            if (impl.startswith(prefix) and suffix.isdecimal()
                    and int(suffix) >= 1):
                break
        else:
            raise ValueError(
                f"unknown KNN top-k implementation {impl!r} "
                f"(--knn-topk / TCSDN_KNN_TOPK; choose from: "
                f"{KNN_TOPK_CHOICES})"
            )
    if impl == "native" and "native" not in _KNN_TOPK_WARNED:
        _KNN_TOPK_WARNED.add("native")
        print(
            "NOTE: TCSDN_KNN_TOPK=native ranks by exact f64 "
            "distances; labels can differ from the default f32 "
            "device ranking on near-ties (no same-run parity gate "
            "at serving time)",
            file=sys.stderr,
        )
    if impl.startswith("ivf") and "ivf" not in _KNN_TOPK_WARNED:
        _KNN_TOPK_WARNED.add("ivf")
        print(
            "NOTE: --knn-topk ivf serves the APPROXIMATE cluster-probed "
            "tier: true neighbors outside the probed lists are missed "
            "(recall_at_1 in ops/knn_ivf.py measures it); exact tiers: "
            "sort/argmax/hier/screened/native",
            file=sys.stderr,
        )
    return impl


def _host_f32(X):
    """Host float32 rows of a feature tensor (or array) for a native
    evaluator: the copy to the host waits for the tensor's producer."""
    import torch

    if isinstance(X, torch.Tensor):
        X = X.detach().cpu().numpy()
    return np.ascontiguousarray(X, np.float32)


def _native_knn(params):
    from ..native import knn as native_knn

    return native_knn.NativeKnn({
        "fit_X": params.fit_X.cpu().numpy(),  # the f32 hi corpus
        "y": params.fit_y.cpu().numpy(),
        "n_neighbors": params.n_neighbors,
        "classes": np.arange(params.n_classes),
    })


def _host_native(fn: Callable) -> Callable:
    """Mark a ``(params, X) -> host labels`` predict ``host_native``: the
    serve's host read paths take it, and the degrade ladder and the
    device-mode label cache stay off it (cli.py, serving/)."""
    fn.host_native = True
    return fn


def _screen_counted(hk, predict: Callable) -> Callable:
    """``(params, X) -> labels`` over a native KNN evaluator's ``predict``
    that diffs its cumulative screening totals (``screen_stats``) into the
    ``knn_candidates_screened`` and ``knn_candidates_abandoned`` counters
    of ``global_metrics`` after each call — one caller per serve (the
    device-stage worker), so the stateful diff is safe."""
    from ..utils.metrics import global_metrics

    last = {"screened": 0, "abandoned": 0}

    def counted(_params, X):
        out = predict(X)
        screened, abandoned, _queries = hk.screen_stats()
        global_metrics.inc("knn_candidates_screened",
                           screened - last["screened"])
        global_metrics.inc("knn_candidates_abandoned",
                           abandoned - last["abandoned"])
        last["screened"], last["abandoned"] = screened, abandoned
        return out

    return counted


def _knn_serving_path(params) -> tuple[Callable, Any]:
    """The ``--knn-topk`` menu (``resolve_knn_topk``):

    - ``sort`` (default), ``pallas``: the CUDA kernel (ops/knn_kernel.py;
      the Pallas kernel is what it ports);
    - ``argmax``, ``hier[<group>]`` (group in [k, 65536], default 128),
      ``screened[<group>]`` (group in [1, 65536], default 32): the torch
      tier of models/knn.py, row-chunked;
    - ``native``: the C++ pruned exact search on the host
      (``NativeKnn.predict``), ``host_native``;
    - ``ivf[<nprobe>]`` (default ``knn_ivf.DEFAULT_NPROBE``): the
      quantizer fits here, on the model's device. On a card the torch
      tier (ops/knn_ivf.py) serves there, with the quantizer on the card.
      On the CPU, where g++ builds the native evaluator, its IVF mirror
      on the same partition serves (``host_native``: the JAX package's
      rule for CPU hosts, whose per-row candidate gathers cost more than
      the C++ walk), else the torch tier."""
    impl = resolve_knn_topk()
    if impl in ("sort", "pallas"):
        return _kernel_serving_path("knn", params)
    if impl == "native":
        hk = _native_knn(params)
        return _host_native(_screen_counted(
            hk, lambda X: hk.predict(_host_f32(X)))), None
    if impl.startswith("ivf"):
        from ..native import knn as native_knn
        from ..ops import knn_ivf

        ivf = knn_ivf.build(
            params, nprobe=int(impl[3:] or knn_ivf.DEFAULT_NPROBE))
        if params.fit_X.device.type == "cuda" or not native_knn.available():
            return knn_ivf.predict_chunked, ivf
        hk = _native_knn(params)
        hk.build_ivf(ivf.centers.cpu().numpy(), knn_ivf.assignments_of(ivf))
        nprobe = ivf.nprobe
        return _host_native(_screen_counted(
            hk, lambda X: hk.predict_ivf(_host_f32(X), nprobe))), None
    if impl != "argmax":
        prefix = "hier" if impl.startswith("hier") else "screened"
        suffix = impl[len(prefix):]
        group = int(suffix) if suffix else (128 if prefix == "hier" else 32)
        lo = params.n_neighbors if prefix == "hier" else 1
        if group < lo or group > (1 << 16):
            raise ValueError(
                f"TCSDN_KNN_TOPK={impl!r}: group must be in [{lo}, 65536]"
            )
    return functools.partial(knn.serve_predict, top_k_impl=impl), params


def _build_serving_path(name: str, params) -> tuple[Callable, Any]:
    """(predict_fn, params) for full-table serving, through the JAX
    package's menus:

    - knn: ``--knn-topk`` / ``TCSDN_KNN_TOPK`` (``_knn_serving_path``);
    - svc: ``TCSDN_SVC_KERNEL`` = ``chunked`` (default: the CUDA kernel)
      or ``dot`` (the dot-expansion form, ``svc.serve_predict_dot``:
      torch matmuls, see its numerics note); any other value raises;
    - forest: ``TCSDN_FOREST_KERNEL`` = ``gemm`` (default), ``pallas``,
      ``pallas_fast``, ``gemm_v2_dot`` or ``gemm_v2_gather`` — TPU
      layouts of one exact function, which the port's one forest kernel
      computes — or ``native`` (the C++ host walk, ``NativeForest``,
      ``host_native``); any other value raises;
    - logreg, gnb, kmeans: the module's own predict.

    A ``host_native`` predict takes the feature tensor and returns host
    labels; the serve runs it without the degrade ladder."""
    import os

    if name == "knn":
        return _knn_serving_path(params)
    if name == "svc":
        kernel = os.environ.get("TCSDN_SVC_KERNEL", "chunked")
        if kernel == "dot":
            return svc.serve_predict_dot, params
        if kernel != "chunked":
            raise ValueError(f"TCSDN_SVC_KERNEL={kernel!r} unknown")
    if name == "forest":
        kernel = os.environ.get("TCSDN_FOREST_KERNEL", "gemm")
        if kernel == "native":
            from ..core.features import NUM_FEATURES
            from ..native import forest as native_forest

            nf = native_forest.NativeForest(
                dict(params.node_arrays(), n_features=NUM_FEATURES))
            return _host_native(lambda _p, X: nf.predict(_host_f32(X))), None
        if kernel not in FOREST_KERNEL_LAYOUTS:
            raise ValueError(f"TCSDN_FOREST_KERNEL={kernel!r} unknown")
    return _kernel_serving_path(name, params)


def _kernel_serving_path(name: str, params) -> tuple[Callable, Any]:
    """(predict_fn, params) of the default serve. The kernel families
    serve through their kernel module — on CUDA tensors the hand-written
    kernel, on CPU tensors its plain version:

    - forest: ops/forest_kernel, the selector compiled at the framework's
      fixed 12-column feature width (a forest whose trees never split on
      the last feature still sees the full matrix);
    - knn: ops/knn_kernel, the exact top-k (``--knn-topk sort``);
    - svc: ops/rbf_kernel, the two-float difference form
      (``TCSDN_SVC_KERNEL=chunked``);
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
    - svc: the SVC kernel's plain version on the CPU with its distance and
      decision loops in C++ (native/svc_eval.cpp), the plain version's
      bits, each loop one call that leaves the GIL to the host stage;
    - logreg, gnb, kmeans, and forest / knn / svc where g++ cannot build
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
            hk = _native_knn(params)
            return ServingFallback(
                lambda X: hk.predict(np.asarray(X, np.float32)),
                "native-knn",
                scores=lambda X: hk.votes(np.asarray(X, np.float32)),
            )
    if name not in MODEL_CLASSES:
        return None
    from ..ops import forest_kernel, knn_kernel, rbf_kernel

    predict, operands = _kernel_serving_path(
        name, copy.deepcopy(params).to("cpu")
    )
    if name == "svc":
        from ..native import svc as native_svc

        if native_svc.available():
            ns = native_svc.NativeSvc(operands)
            return ServingFallback(ns.predict, "native-svc", scores=ns.scores)
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


def load_reference_model(name: str, checkpoint_path: str,
                         device=None) -> LoadedModel:
    """Import a reference sklearn pickle (io/sklearn_import.py) as the
    port's module on ``device`` (default CUDA, see device.py). ``name`` is
    a family key or a CLI subcommand. A k-means model decodes its cluster
    ids through ``kmeans.CLUSTER_LABELS_CHECKPOINT``, the others through
    the pickle's ``classes_``. A missing file raises FileNotFoundError."""
    from ..io import sklearn_import

    name = SUBCOMMAND_ALIASES.get(name, name)
    raw = sklearn_import.IMPORTERS[name](checkpoint_path)
    params = MODEL_CLASSES[name].from_numpy(raw, device=device)
    if name == "kmeans":
        classes = ClassList(kmeans.CLUSTER_LABELS_CHECKPOINT)
    else:
        classes = ClassList.from_array(raw["classes"])
    return make_loaded_model(name, params, classes)
