"""Plain reference of a random forest's labels (scikit-learn's
``RandomForestClassifier.predict`` in float32 serving arithmetic).

Each tree is walked from its root: at an internal node the row goes left
when ``x[feature] <= threshold``, compared as scikit-learn compares, the
float32 feature against the float64 threshold. Each reached leaf gives
its normalised class distribution divided by the tree count, rounded to
float32; the class sums start at 0 and add the trees' values in tree
order, each sum rounded to float32; the label is the first class with the
largest sum. With ``precision="bfloat16"`` (the control) features,
thresholds, leaf values and sums are bfloat16.

Plain PyTorch, in blocks of rows; it imports nothing of the program."""

from __future__ import annotations

import numpy as np
import torch

from . import sklearn_pickle

BLOCK = 1 << 18


class Forest:
    def __init__(self, trees: list[dict], classes: list[str],
                 n_features: int = 12):
        self.classes = classes
        self.n_features = n_features
        T = len(trees)
        M = max(len(t["left"]) for t in trees)
        C = len(classes)
        self.n_trees, self.n_classes = T, C
        self.left = np.full((T, M), -1, np.int64)
        self.right = np.full((T, M), -1, np.int64)
        self.feature = np.zeros((T, M), np.int64)
        self.threshold = np.zeros((T, M), np.float64)
        self.leaf = np.zeros((T, M, C), np.float32)
        self.internal_nodes = self.leaves = 0
        for i, t in enumerate(trees):
            n = len(t["left"])
            self.left[i, :n] = t["left"]
            self.right[i, :n] = t["right"]
            self.feature[i, :n] = np.maximum(t["feature"], 0)
            self.threshold[i, :n] = t["threshold"]
            is_leaf = t["left"] < 0
            v = t["values"][is_leaf]
            self.leaf[i, :n][is_leaf] = (
                v / v.sum(1, keepdims=True) / T).astype(np.float32)
            self.internal_nodes += int((~is_leaf).sum())
            self.leaves += int(is_leaf.sum())
        self._dev = {}

    @classmethod
    def from_pickle(cls, path: str) -> "Forest":
        return cls(*sklearn_pickle.forest_trees(path))

    def _on(self, device):
        key = str(device)
        if key not in self._dev:
            self._dev[key] = tuple(
                torch.from_numpy(a).to(device) for a in
                (self.left, self.right, self.feature, self.threshold,
                 self.leaf))
        return self._dev[key]

    def predict(self, X: torch.Tensor, precision: str = "float32"):
        """(labels (n,) int64, internal-node visits) of float32 rows X."""
        labels, visits = [], 0
        for i in range(0, X.shape[0], BLOCK):
            lab, v = self._block(X[i:i + BLOCK], precision)
            labels.append(lab)
            visits += v
        out = torch.cat(labels) if labels else torch.zeros(0, dtype=torch.int64)
        return out, visits

    def _block(self, X, precision):
        left, right, feature, threshold, leaf = self._on(X.device)
        n, T = X.shape[0], self.n_trees
        if precision == "float32":
            x, thr, lv, acc_dtype = X.double(), threshold, leaf, torch.float32
        elif precision == "bfloat16":
            x = X.to(torch.bfloat16)
            thr = threshold.to(torch.bfloat16)
            lv, acc_dtype = leaf.to(torch.bfloat16), torch.bfloat16
        else:
            raise ValueError(f"unknown precision {precision!r}")
        trees = torch.arange(T, device=X.device)[None, :].expand(n, T)
        node = torch.zeros((n, T), dtype=torch.int64, device=X.device)
        visits = 0
        while True:
            nxt_left = left[trees, node]
            internal = nxt_left >= 0
            count = int(internal.sum())
            if count == 0:
                break
            visits += count
            xv = torch.gather(x, 1, feature[trees, node])
            go = torch.where(xv <= thr[trees, node], nxt_left,
                             right[trees, node])
            node = torch.where(internal, go, node)
        acc = torch.zeros((n, self.n_classes), dtype=acc_dtype, device=X.device)
        for t in range(T):
            acc = acc + lv[t, node[:, t]]
        return torch.argmax(acc, dim=1), visits


def load(config: dict, seed: int, root):
    return Forest.from_pickle(str(root / config["model_file"]))
