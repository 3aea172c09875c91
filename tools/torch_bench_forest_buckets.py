#!/usr/bin/env python
"""Bucket-count sweep of the PyTorch port's GEMM-form forest
(``ops/tree_gemm.compile_forest(n_buckets=…)``). The twin of
``tools/bench_forest_buckets.py``: the same flags, ``"metric"`` and keys,
measured on the port (on the card unless ``--device cpu``).

The size-bucketed GEMM pads every tree in a bucket to the bucket's max
(D, L); more buckets mean tighter padding but more, smaller matrix
products. This tool races n_buckets over the forest checkpoint at the
bench's large batch, parity-gating each point against an independent
numpy walk of the checkpoint's tree arrays, and prints one JSON line.

Each point's time is K dependent predicts (each input perturbed by the
previous sum), waited for and divided by K, K escalating until a timed
repetition costs 0.2 s — ``bench._timed_loop``'s method. This tool keeps
its own copies of ``bench._timed_loop``, ``_loop_iters`` and
``_numpy_forest_labels`` (``bench.py`` imports JAX).

Parity rows: the reference CSVs under ``--data-dir`` when given, else
8,898 seeded flow-shaped rows (the retrain set's size); ``parity_data``
says which. The checkpoint comes from ``--models-dir`` (default
``$TCSDN_MODELS_DIR``, else the committed ``tests/data/reference_pickles/``).

Usage: python tools/torch_bench_forest_buckets.py [--batch 131072]
       [--buckets 2,4,8,16,32] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from torch_bench_common import (
    add_device_arg,
    device_fields,
    models_dir,
    resolve_device,
    sync,
)

PARITY_ROWS = 8898  # seeded parity rows without --data-dir


def numpy_forest_labels(d: dict, X):
    """Independent oracle: vectorized level-synchronous node walk of the
    checkpoint's tree arrays (a copy of ``bench._numpy_forest_labels``;
    no torch involved)."""
    import numpy as np

    n_trees = d["left"].shape[0]
    probs = np.zeros((X.shape[0], d["values"].shape[2]), dtype=np.float64)
    rows = np.arange(X.shape[0])
    for t in range(n_trees):
        left, right = d["left"][t], d["right"][t]
        feat, thr, vals = d["feature"][t], d["threshold"][t], d["values"][t]
        node = np.zeros(X.shape[0], np.int64)
        active = left[node] != -1
        while active.any():
            f = feat[node]
            go_left = X[rows, f] <= thr[node]
            node = np.where(
                active, np.where(go_left, left[node], right[node]), node
            )
            active = left[node] != -1
        v = vals[node]
        probs += v / v.sum(axis=1, keepdims=True)
    return np.argmax(probs / n_trees, axis=1)


def loop_iters(batch: int, device) -> int:
    """Starting K of ``timed_loop`` (a copy of ``bench._loop_iters``): 2
    on the CPU, where one predict already clears the signal floor."""
    if device.type != "cuda":
        return 2
    return 16 if batch <= (1 << 17) else 4


MIN_SIGNAL = 0.2  # s a timed repetition must cost (bench.MIN_SIGNAL)
REPEATS = 5


def timed_loop(predict_sum, params, X, iters: int, device,
               min_signal: float = MIN_SIGNAL) -> float:
    """Device seconds per predict (a copy of ``bench._timed_loop``): K
    dependent predicts, each input perturbed by the previous sum as the
    JAX ``fori_loop`` does, timed on the host clock up to a device sync
    and divided by K. K escalates until one timed repetition costs
    ``min_signal``.
    ``predict_sum(params, X)`` returns a float32 scalar tensor."""
    import numpy as np
    import torch

    def loop(n: int):
        acc = torch.zeros((), dtype=torch.float32, device=X.device)
        Xi = X.clone()
        for i in range(n):
            Xi[0, 0] = acc * 1e-9 + float(i)
            acc = acc + predict_sum(params, Xi)
        return acc

    cap = 1 << 17
    while True:
        loop(1)
        sync(device)
        times = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            loop(iters)
            sync(device)
            times.append(time.perf_counter() - t0)
        signal = float(np.median(times))
        if signal >= min_signal or iters >= cap:
            return max(signal, 1e-12) / iters
        grow = min(
            64, max(4, int(np.ceil(2 * min_signal / max(signal, 1e-6))))
        )
        iters = min(iters * grow, cap)


def parity_rows(data_dir: str | None):
    """(X (N, 12) float64 numpy, description) of the parity rows."""
    import numpy as np

    if data_dir:
        from traffic_classifier_sdn_tpu_torch.io.datasets import (
            load_reference_datasets,
        )

        return (load_reference_datasets(data_dir).X,
                f"reference datasets ({data_dir})")
    rng = np.random.RandomState(1)
    X = np.abs(rng.gamma(1.5, 200.0, (PARITY_ROWS, 12))).astype(np.float32)
    return X.astype(np.float64), "seeded flow-shaped rows (RandomState(1))"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=131072)
    ap.add_argument("--buckets", default="2,4,8,16,32")
    ap.add_argument("--models-dir", default=None,
                    help="checkpoint tree (default $TCSDN_MODELS_DIR, else "
                    "the committed reference-shaped pickles)")
    ap.add_argument("--data-dir", default=None,
                    help="reference CSVs for the parity rows (default: "
                    "seeded flow-shaped rows)")
    add_device_arg(ap)
    args = ap.parse_args()
    device = resolve_device(args.device)

    import numpy as np
    import torch

    from traffic_classifier_sdn_tpu_torch.io import sklearn_import as ski
    from traffic_classifier_sdn_tpu_torch.ops import tree_gemm

    print(f"# device: {device_fields(device)}", file=sys.stderr, flush=True)

    t0 = time.time()
    forest_raw = ski.import_forest(
        os.path.join(args.models_dir or models_dir(), "RandomForestClassifier")
    )
    Xp, parity_data = parity_rows(args.data_dir)
    Xd = torch.as_tensor(Xp, dtype=torch.float32, device=device)
    want = numpy_forest_labels(forest_raw, Xp)

    rng = np.random.RandomState(0)
    X = torch.from_numpy(
        np.abs(rng.gamma(1.5, 200.0, (args.batch, 12))).astype(np.float32)
    ).to(device)

    def predict(g, Xb):
        return torch.argmax(tree_gemm.forest_proba_gemm(g, Xb), dim=1)

    def forest_sum(g, Xb):
        return predict(g, Xb).sum().to(torch.float32)

    out: dict = {
        "metric": "forest_bucket_sweep",
        **device_fields(device),
        "batch": args.batch,
        "parity_rows": int(Xp.shape[0]),
        "parity_data": parity_data,
        "points": {},
    }
    best = None
    for nb in (int(b) for b in args.buckets.split(",")):
        print(f"# n_buckets={nb}", file=sys.stderr, flush=True)
        g = tree_gemm.compile_forest(forest_raw, n_buckets=nb, device=device)
        got = predict(g, Xd).cpu().numpy()
        parity = float((got == want).mean() * 100.0)
        sec = timed_loop(forest_sum, g, X, loop_iters(args.batch, device),
                         device)
        point = {
            "device_ms": round(sec * 1e3, 3),
            "flows_per_sec": round(args.batch / sec, 1),
            "parity_pct": round(parity, 3),
        }
        out["points"][str(nb)] = point
        print(json.dumps({f"n_buckets_{nb}": point}), flush=True)
        if parity == 100.0 and (best is None or sec < best[1]):
            best = (nb, sec)
    if best is not None:
        out["best_n_buckets"] = best[0]
        out["best_device_ms"] = round(best[1] * 1e3, 3)
        out["best_flows_per_sec"] = round(args.batch / best[1], 1)
    out["elapsed_s"] = round(time.time() - t0, 1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
