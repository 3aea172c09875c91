"""Import the reference's pickled scikit-learn estimators into plain arrays
— the port's copy of ``traffic_classifier_sdn_tpu/io/sklearn_import.py``
(host numpy code, unchanged).

The reference ships six fitted sklearn-1.0.1 estimators as raw pickles in
``models/`` (reference: traffic_classifier.py:229-243 loads them by
subcommand). Two of them (KNeighbors, RandomForestClassifier) embed Cython
extension types (``sklearn.neighbors._kd_tree.KDTree``,
``sklearn.tree._tree.Tree``) whose binary layout changed and no longer
unpickles in modern sklearn. We therefore never instantiate sklearn classes at
all: a stub Unpickler intercepts every ``sklearn.*`` global and captures the
constructor args and ``__setstate__`` payload verbatim, and per-model
extractors lift exactly the learned arrays documented in SURVEY.md §2.2 into
plain numpy dicts, which the families' ``from_numpy`` classmethods
(models/) turn into the port's modules.

No sklearn import is required to load checkpoints (sklearn is only used by the
test suite for parity checks). ``f32_safe_thresholds`` is the threshold
rounding every forest path of the port shares.
"""

from __future__ import annotations

import io
import pickle
from typing import Any

import numpy as np


class _SkStub:
    """Captures constructor args and pickled state of a sklearn object
    without executing any sklearn code."""

    def __init__(self, *args, **kwargs):
        self._reduce_args = args
        self._reduce_kwargs = kwargs

    def __setstate__(self, state):
        self._raw_state = state
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple) and len(state) == 2:
            # pickle's 2-tuple state convention: (dict_state, slots_state)
            dict_state, slots_state = state
            if isinstance(dict_state, dict):
                self.__dict__.update(dict_state)
            if isinstance(slots_state, dict):
                self.__dict__.update(slots_state)


_stub_cache: dict[tuple[str, str], type] = {}


def _stub_class(module: str, name: str) -> type:
    key = (module, name)
    cls = _stub_cache.get(key)
    if cls is None:
        cls = type(name, (_SkStub,), {"_sk_module": module, "_sk_name": name})
        _stub_cache[key] = cls
    return cls


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.split(".")[0] == "sklearn":
            return _stub_class(module, name)
        return super().find_class(module, name)


def load_sklearn_pickle(path: str) -> Any:
    """Unpickle ``path`` with every sklearn class replaced by a stub."""
    with open(path, "rb") as f:
        return _StubUnpickler(io.BytesIO(f.read())).load()


def _classes(est) -> np.ndarray:
    return np.asarray(est.classes_)


# ---------------------------------------------------------------------------
# Per-model extraction → plain dict of numpy arrays (SURVEY.md §2.2 shapes).
# ---------------------------------------------------------------------------


def import_logreg(path: str) -> dict:
    """models/LogisticRegression → coef (C,12), intercept (C,), classes.

    Predict math (sklearn LogisticRegression.predict): argmax of
    ``X @ coef.T + intercept`` — the reference pickle is 4-class
    (classes_ = [dns, ping, telnet, voice]; SURVEY.md §2.2).
    """
    est = load_sklearn_pickle(path)
    return {
        "coef": np.asarray(est.coef_, dtype=np.float64),
        "intercept": np.asarray(est.intercept_, dtype=np.float64),
        "classes": _classes(est),
    }


def import_gnb(path: str) -> dict:
    """models/GaussianNB → theta (C,12), var (C,12), class_prior (C,)."""
    est = load_sklearn_pickle(path)
    var = getattr(est, "var_", None)
    if var is None:  # pre-1.0 pickles call it sigma_
        var = est.sigma_
    return {
        "theta": np.asarray(est.theta_, dtype=np.float64),
        "var": np.asarray(var, dtype=np.float64),
        "class_prior": np.asarray(est.class_prior_, dtype=np.float64),
        "classes": _classes(est),
    }


def import_kmeans(path: str) -> dict:
    """models/KMeans_Clustering → cluster_centers (K,12).

    The reference's checkpoint is the 4-cluster, 4-class era (SURVEY.md §2.2);
    the cluster→label map is handled by the label layer, not here.
    """
    est = load_sklearn_pickle(path)
    return {
        "cluster_centers": np.asarray(est.cluster_centers_, dtype=np.float64),
    }


def import_svc(path: str) -> dict:
    """models/SVC → support_vectors (S,12), dual_coef (C-1,S),
    intercept (C*(C-1)/2,), n_support (C,), gamma.

    Uses the private ``_dual_coef_`` / ``_intercept_`` (the exact arrays
    libsvm's ovo decision uses); sklearn's public ``dual_coef_`` is the
    negation-free view of the same data.
    """
    est = load_sklearn_pickle(path)
    d = est.__dict__
    dual = d.get("_dual_coef_", d.get("dual_coef_"))
    intercept = d.get("_intercept_", d.get("intercept_"))
    n_support = d.get("n_support_", d.get("_n_support"))
    return {
        "support_vectors": np.asarray(est.support_vectors_, dtype=np.float64),
        "dual_coef": np.asarray(dual, dtype=np.float64),
        "intercept": np.asarray(intercept, dtype=np.float64),
        "n_support": np.asarray(n_support, dtype=np.int32),
        "gamma": float(d["_gamma"]),
        "classes": _classes(est),
    }


def import_knn(path: str) -> dict:
    """models/KNeighbors → fit_X (N,12), y (N,), n_neighbors, classes.

    The pickle embeds a KDTree; we deliberately discard it — brute-force
    batched L2 + top-k is the idiomatic TPU replacement (SURVEY.md §2.3).
    """
    est = load_sklearn_pickle(path)
    return {
        "fit_X": np.asarray(est._fit_X, dtype=np.float64),
        "y": np.asarray(est._y, dtype=np.int32),
        "n_neighbors": int(est.n_neighbors),
        "classes": _classes(est),
    }


def _extract_tree(tree_stub) -> dict:
    """Pull the node arrays out of an sklearn.tree._tree.Tree — either a
    stub-unpickled one or a LIVE fitted tree (forest_dict_from_estimator).

    Tree.__reduce__ → (Tree, (n_features, n_classes_arr, n_outputs), state)
    with state = {'max_depth', 'node_count', 'nodes', 'values'}; ``nodes`` is
    a structured array with fields left_child, right_child, feature,
    threshold, impurity, n_node_samples, weighted_n_node_samples. A live
    Cython Tree exposes the same dict through ``__getstate__``.
    """
    state = getattr(tree_stub, "_raw_state", None)
    if state is None:
        state = tree_stub.__getstate__()
    nodes = state["nodes"]
    return {
        "left": np.asarray(nodes["left_child"], dtype=np.int32),
        "right": np.asarray(nodes["right_child"], dtype=np.int32),
        "feature": np.asarray(nodes["feature"], dtype=np.int32),
        "threshold": np.asarray(nodes["threshold"], dtype=np.float64),
        # (node_count, n_outputs=1, n_classes) class-count distributions
        "values": np.asarray(state["values"], dtype=np.float64)[:, 0, :],
        "max_depth": int(state["max_depth"]),
        "node_count": int(state["node_count"]),
    }


def import_forest(path: str) -> dict:
    """models/RandomForestClassifier → ragged per-tree node arrays, padded to
    the max node count so the ensemble is a dense (T, max_nodes, …) stack.

    Padding uses self-loop leaves (left=right=-1) with zero value rows, which
    the tensorized traversal in ops/tree_eval.py treats as inert.
    """
    return forest_dict_from_estimator(load_sklearn_pickle(path))


def forest_dict_from_estimator(est) -> dict:
    """The ``import_forest`` packing for an in-memory fitted
    ``RandomForestClassifier`` — ONE home for the dense-stack layout, so
    tests and tools that fuzz with freshly-fit forests exercise exactly
    the arrays the importer produces (max_depth and n_features derived,
    never hand-set)."""
    trees = [_extract_tree(t.tree_) for t in est.estimators_]
    n_trees = len(trees)
    max_nodes = max(t["node_count"] for t in trees)
    n_classes = trees[0]["values"].shape[1]

    left = np.full((n_trees, max_nodes), -1, dtype=np.int32)
    right = np.full((n_trees, max_nodes), -1, dtype=np.int32)
    feature = np.zeros((n_trees, max_nodes), dtype=np.int32)
    threshold = np.zeros((n_trees, max_nodes), dtype=np.float64)
    values = np.zeros((n_trees, max_nodes, n_classes), dtype=np.float64)
    for i, t in enumerate(trees):
        n = t["node_count"]
        left[i, :n] = t["left"]
        right[i, :n] = t["right"]
        feature[i, :n] = np.maximum(t["feature"], 0)  # leaves store -2
        threshold[i, :n] = t["threshold"]
        values[i, :n] = t["values"]

    return {
        "left": left,
        "right": right,
        "feature": feature,
        "threshold": threshold,
        "values": values,
        "max_depth": max(t["max_depth"] for t in trees),
        "classes": _classes(est),
        "n_features": int(est.n_features_in_),
    }


def f32_safe_thresholds(thr: np.ndarray) -> np.ndarray:
    """Round float64 split thresholds DOWN to float32 so that
    ``x ≤ f32(thr)`` agrees with sklearn's ``f32(x) ≤ f64(thr)`` for every
    float32 x: sklearn stores float64 midpoints of adjacent float32 feature
    values, and a midpoint that rounds *up* under f32 would flip the
    decision for a sample sitting exactly at the upper value."""
    t32 = thr.astype(np.float32)
    round_up = t32.astype(np.float64) > thr
    return np.where(
        round_up, np.nextafter(t32, np.float32(-np.inf)), t32
    ).astype(np.float32)


IMPORTERS = {
    "logreg": import_logreg,
    "gnb": import_gnb,
    "kmeans": import_kmeans,
    "svc": import_svc,
    "knn": import_knn,
    "forest": import_forest,
}

# Reference checkpoint filenames (reference: traffic_classifier.py:230-240).
REFERENCE_CHECKPOINTS = {
    "logreg": "LogisticRegression",
    "gnb": "GaussianNB",
    "kmeans": "KMeans_Clustering",
    "svc": "SVC",
    "knn": "KNeighbors",
    "forest": "RandomForestClassifier",
}
