"""The KNN corpus of a configuration, made from the seed in the
class-shaped conversation geometry of the traffic: ``conversations`` per
class report ``polls`` polls of class-shaped deltas (``traffic.draw_deltas``),
and each gives ``snapshots`` rows, the 12 features the flow table holds
after a poll drawn from its 2nd to its last. The rows come shuffled; the
labels are the class indices. The reference and the program get the same
arrays."""

from __future__ import annotations

import numpy as np

from reference import flows

from .traffic import class_shapes, draw_deltas


def make(spec: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """((rows, 12) float32 features, (rows,) int64 labels)."""
    shapes = class_shapes(spec["classes"])
    snaps, polls = int(spec["snapshots_per_conversation"]), int(spec["polls"])
    rows = int(spec["rows"])
    n_conv = rows // (len(shapes) * snaps)
    if n_conv * len(shapes) * snaps != rows:
        raise ValueError("corpus rows must split evenly over classes and snapshots")
    X, y = [], []
    for c in range(len(shapes)):
        rng = np.random.default_rng([seed, 2, c])
        d = draw_deltas(rng, np.full(n_conv * polls, c), shapes)
        cum = np.cumsum(d.reshape(n_conv, polls, 4), axis=1)
        k = rng.integers(1, polls, (n_conv, snaps))
        conv = np.repeat(np.arange(n_conv), snaps)
        k = k.reshape(-1)
        st = flows.switch_state(cum[conv, k], cum[conv, k - 1], k,
                                int(spec["poll_seconds"]))
        X.append(st["X"])
        y.append(np.full(len(k), c, np.int64))
    X, y = np.concatenate(X), np.concatenate(y)
    order = np.random.default_rng([seed, 3]).permutation(rows)
    return X[order], y[order]
