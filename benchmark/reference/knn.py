"""Plain reference of a k-nearest-neighbours classifier's labels, brute
force over the whole corpus, in the float32 arithmetic the configuration
states.

Rows are ranked by the L2 order written as the similarity
``x.s - |s|^2 / 2``: the products of the features summed in ascending
feature order, each product and each sum rounded to float32 on its own
(``|s|^2 / 2`` likewise: the squares summed in order, then halved). The k
most similar corpus rows are taken by (similarity descending, corpus index
ascending), in the IEEE total order of float32; the label is the first
class with the most votes among them. With ``precision="bfloat16"`` (the
control) every product and sum is bfloat16. ``top_k`` also gives the k
similarities, to which the check holds the kernel's own (similarity,
index) lists bit for bit.

Plain PyTorch, in blocks of rows; it imports nothing of the program."""

from __future__ import annotations

import numpy as np
import torch

PAIRS_PER_BLOCK = 1 << 28  # (rows x corpus rows) of one block


def total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys of float32 values that order as the IEEE total order."""
    bits = x.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


class Knn:
    def __init__(self, fit_X: np.ndarray, fit_y: np.ndarray, k: int,
                 classes: list[str]):
        self.fit_X = np.ascontiguousarray(fit_X, np.float32)
        self.fit_y = np.asarray(fit_y, np.int64)
        self.k = int(k)
        self.classes = classes
        self.n_classes = len(classes)
        self._dev = {}

    @property
    def n_rows(self) -> int:
        return self.fit_X.shape[0]

    @property
    def n_features(self) -> int:
        return self.fit_X.shape[1]

    def _on(self, device, dtype):
        key = (str(device), dtype)
        if key not in self._dev:
            fx = torch.from_numpy(self.fit_X).to(device).to(dtype)
            half = fx[:, 0] * fx[:, 0]
            for f in range(1, fx.shape[1]):
                half = half + fx[:, f] * fx[:, f]
            self._dev[key] = (fx, 0.5 * half,
                              torch.from_numpy(self.fit_y).to(device))
        return self._dev[key]

    def top_k(self, X: torch.Tensor, precision: str = "float32"):
        """((n, k) float32 similarities, (n, k) int64 corpus indices) of
        each row's k most similar corpus rows, nearest first."""
        dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[precision]
        fx, half, _ = self._on(X.device, dtype)
        S = fx.shape[0]
        block = max(1, PAIRS_PER_BLOCK // S)
        sims, out = [], []
        low = torch.arange(S, device=X.device, dtype=torch.int64)
        low = (0xFFFFFFFF - low)[None, :]
        for i in range(0, X.shape[0], block):
            x = X[i:i + block].to(dtype)
            sim = x[:, 0, None] * fx[None, :, 0]
            for f in range(1, x.shape[1]):
                sim = sim + x[:, f, None] * fx[None, :, f]
            sim = (sim - half[None, :]).float()
            key = (total_order_key(sim).to(torch.int64) << 32) | low
            top = torch.topk(key, self.k, dim=1).values
            idx = 0xFFFFFFFF - (top & 0xFFFFFFFF)
            sims.append(torch.gather(sim, 1, idx))
            out.append(idx)
            del sim, key
        if not out:
            return (torch.zeros((0, self.k), device=X.device),
                    torch.zeros((0, self.k), dtype=torch.int64, device=X.device))
        return torch.cat(sims), torch.cat(out)

    def neighbours(self, X: torch.Tensor, precision: str = "float32"):
        """(n, k) corpus indices of each row's k nearest rows, nearest first."""
        return self.top_k(X, precision)[1]

    def predict(self, X: torch.Tensor, precision: str = "float32"):
        """(labels (n,) int64, (similarities, indices) of the k nearest
        rows): the vote of the k nearest rows."""
        _, _, y = self._on(X.device, torch.float32)
        sims, idx = self.top_k(X, precision)
        votes = torch.nn.functional.one_hot(y[idx], self.n_classes).sum(1)
        return torch.argmax(votes, dim=1), (sims, idx)


def load(config: dict, seed: int, root):
    from harness import corpus

    X, y = corpus.make(config["corpus"], seed)
    return Knn(X, y, config["n_neighbors"], list(config["classes"]))
