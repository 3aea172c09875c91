"""Read a pickled scikit-learn forest without scikit-learn: every
``sklearn.*`` class is replaced by a stub that keeps its constructor
arguments and pickled state, and the trees' node arrays are lifted from
that state (``sklearn.tree._tree.Tree`` pickles its nodes as a structured
array with ``left_child``, ``right_child``, ``feature`` and ``threshold``,
and its class distributions as ``values``). A frozen copy of the
stub-unpickler idea of the port's ``io/sklearn_import.py``; it imports
nothing of the program."""

from __future__ import annotations

import io
import pickle

import numpy as np


class _Stub:
    def __init__(self, *args, **kwargs):
        self._args = args

    def __setstate__(self, state):
        self._state = state
        if isinstance(state, tuple) and len(state) == 2:
            state = state[0]
        if isinstance(state, dict):
            self.__dict__.update(state)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.split(".")[0] == "sklearn":
            return type(name, (_Stub,), {})
        return super().find_class(module, name)


def load(path: str):
    with open(path, "rb") as f:
        return _Unpickler(io.BytesIO(f.read())).load()


def forest_trees(path: str) -> tuple[list[dict], list[str], int]:
    """([{left, right, feature, threshold, values}, ...], class names,
    feature count) of a pickled ``RandomForestClassifier``; ``values`` is
    (nodes, classes)."""
    est = load(path)
    trees = []
    for t in est.estimators_:
        state = t.tree_._state
        nodes = state["nodes"]
        trees.append({
            "left": np.asarray(nodes["left_child"], np.int64),
            "right": np.asarray(nodes["right_child"], np.int64),
            "feature": np.asarray(nodes["feature"], np.int64),
            "threshold": np.asarray(nodes["threshold"], np.float64),
            "values": np.asarray(state["values"], np.float64)[:, 0, :],
        })
    return (trees, [str(c) for c in np.asarray(est.classes_).tolist()],
            int(est.n_features_in_))
