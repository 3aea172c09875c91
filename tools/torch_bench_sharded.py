#!/usr/bin/env python
"""Sharded-path scaling bench of the PyTorch port. The twin of
``tools/bench_sharded.py``: the same flags, ``"metric"`` and result keys,
with every shard placed on the one device (``parallel/mesh.make_mesh``
over N copies of it; on the card unless ``--device cpu``).

Times every distributed predict path at shard counts 1 / 2 / 8. With all
shards on one device the absolute numbers are total work, not a speedup;
the relative shape catches layout regressions (a merge whose operand
suddenly scales with the full state, padding that stops dividing).

Paths (state axis unless noted), the JAX tool's with the port's torch
local stage:
  knn_allgather / knn_ring / knn_tournament — local top-k + merge
                  (parallel/knn_sharded.py)
  forest        — tree-sharded, shard-ordered sum of class distributions
  svc           — SV-sharded, shard-ordered sum of partial ovo decisions
  forest_dp     — batch-sharded forest (data axis)
and the kernel local stage the port serves with: ``knn_fused_*`` (the KNN
kernel once per shard, each merge) and ``svc_fused`` (the RBF kernel once
per shard) — on the card ``csrc/knn_topk.cu`` and ``csrc/rbf_decision.cu``.

``parity`` holds each path against the un-sharded model on the same
queries: KNN and forest_dp labels bitwise; the forest's probabilities and
the SVC's decisions to float32 reassociation (1e-5 absolute; 1e-5 of the
largest coefficient sum for the SVC), their labels equal off near-ties.
Any parity that fails ends the run nonzero after the JSON line.

The training canaries (cold, one call each) fit on 1,024 seeded
class-shaped rows (``$TCSDN_DATA_DIR`` when it holds the reference CSVs).
Checkpoints come from ``--models-dir`` (default ``$TCSDN_MODELS_DIR``,
else the committed ``tests/data/reference_pickles/``). Prints one JSON
line.
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

ATOL = 1e-5


def canary_data(n: int = 1024):
    """(X, y, n_classes) for the training canaries: the reference CSVs
    under ``$TCSDN_DATA_DIR`` when present, else seeded class-shaped rows
    of six classes at distinct rate scales."""
    import numpy as np

    data_dir = os.environ.get("TCSDN_DATA_DIR")
    if data_dir and os.path.isdir(data_dir):
        from traffic_classifier_sdn_tpu_torch.io.datasets import (
            load_reference_datasets,
        )

        ds = load_reference_datasets(data_dir)
        return ds.X[:n], ds.y[:n], len(ds.classes)
    rng = np.random.RandomState(0)
    theta = rng.gamma(2.0, 100.0, (6, 12))
    y = rng.randint(0, 6, n)
    X = (rng.gamma(2.0, 1.0, (n, 12)) * theta[y]).astype(np.float64)
    return X, y, 6


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--models-dir", default=None,
                    help="checkpoint tree (default $TCSDN_MODELS_DIR, else "
                    "the committed reference-shaped pickles)")
    add_device_arg(ap)
    args = ap.parse_args()
    device = resolve_device(args.device)

    import numpy as np
    import torch

    from traffic_classifier_sdn_tpu_torch.io import sklearn_import as ski
    from traffic_classifier_sdn_tpu_torch.models.forest import ForestModel
    from traffic_classifier_sdn_tpu_torch.models.knn import KnnModel
    from traffic_classifier_sdn_tpu_torch.models.svc import SvcModel
    from traffic_classifier_sdn_tpu_torch.parallel import (
        forest_sharded,
        knn_sharded,
        mesh as meshlib,
        predict as dp,
        svc_sharded,
    )
    from traffic_classifier_sdn_tpu_torch.train.distributed import (
        fit_forest,
        fit_svc,
    )

    print(f"# device: {device_fields(device)}", file=sys.stderr, flush=True)
    rng = np.random.RandomState(0)
    X = torch.as_tensor(
        np.abs(rng.gamma(1.5, 200.0, (args.batch, 12))), dtype=torch.float32
    ).to(device)

    def timed(fn, *a) -> float:
        fn(*a)  # warm
        sync(device)
        times = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            fn(*a)
            sync(device)
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    mdir = args.models_dir or models_dir()
    knn_raw = ski.import_knn(os.path.join(mdir, "KNeighbors"))
    svc_raw = ski.import_svc(os.path.join(mdir, "SVC"))
    forest_raw = ski.import_forest(
        os.path.join(mdir, "RandomForestClassifier"))

    # the un-sharded references
    kp0 = KnnModel.from_numpy(knn_raw, device=device)
    fp0 = ForestModel.from_numpy(forest_raw, device=device)
    sp0 = SvcModel.from_numpy(svc_raw, device=device)
    want_knn = kp0.predict(X)
    want_proba = fp0.scores(X)
    want_forest = fp0.predict(X)
    want_dec = sp0.decision_ovo(X)
    want_svc = sp0.predict(X)
    svc_atol = ATOL * float(sp0.pair_coef.abs().sum(1).max())
    svc_clear = want_dec.abs().min(1).values > svc_atol
    top2 = torch.topk(want_proba, 2, dim=1).values
    forest_clear = (top2[:, 0] - top2[:, 1]) > ATOL

    results: dict = {}
    parity: dict = {}
    for n_state in (1, 2, 8):
        mesh = meshlib.make_mesh(n_data=1, n_state=n_state,
                                 devices=[device] * n_state)
        r: dict = {}
        p: dict = {}

        kr = knn_sharded.pad_corpus(dict(knn_raw), n_state)
        kp = KnnModel.from_numpy(kr, device=device)
        pad = kr.get("pad_mask")
        for key, fn in (
            ("knn_allgather", knn_sharded.sharded_predict(mesh, kp, pad)),
            ("knn_ring", knn_sharded.ring_predict(mesh, kp, pad)),
            ("knn_tournament", knn_sharded.tournament_predict(mesh, kp, pad)),
            ("knn_fused_allgather", knn_sharded.fused_predict(
                mesh, kp, pad, merge="all_gather")),
            ("knn_fused_ring", knn_sharded.fused_predict(
                mesh, kp, pad, merge="ring")),
            ("knn_fused_tournament", knn_sharded.fused_predict(
                mesh, kp, pad, merge="tournament")),
        ):
            p[key] = bool(torch.equal(fn(X), want_knn))
            r[f"{key}_ms"] = timed(fn, X) * 1e3

        fr = forest_sharded.pad_trees(dict(forest_raw), n_state)
        fp = ForestModel.from_numpy(fr, device=device)
        n_real = fr.get("n_real_trees", fr["left"].shape[0])
        proba = forest_sharded.sharded_proba(mesh, fp, n_real_trees=n_real)
        got = proba(X)
        p["forest"] = bool(
            float((got - want_proba).abs().max()) <= ATOL
            and torch.equal(torch.argmax(got, 1)[forest_clear].to(torch.int32),
                            want_forest[forest_clear]))
        r["forest_ms"] = timed(forest_sharded.sharded_predict(
            mesh, fp, n_real_trees=n_real), X) * 1e3

        sr = svc_sharded.pad_support(dict(svc_raw), n_state)
        sp = SvcModel.from_numpy(sr, device=device)
        for key, fn in (
            ("svc", svc_sharded.sharded_decision(mesh, sp)),
            ("svc_fused", svc_sharded.fused_decision(mesh, sp)),
        ):
            lab, dec = fn(X)
            p[key] = bool(
                float((dec - want_dec).abs().max()) <= svc_atol
                and torch.equal(lab[svc_clear], want_svc[svc_clear]))
        r["svc_ms"] = timed(svc_sharded.sharded_predict(mesh, sp), X) * 1e3
        r["svc_fused_ms"] = timed(svc_sharded.fused_predict(mesh, sp),
                                  X) * 1e3

        results[f"state_{n_state}"] = {k: round(v, 2) for k, v in r.items()}
        parity[f"state_{n_state}"] = p

    for n_data in (1, 8):
        mesh = meshlib.make_mesh(n_data=n_data, n_state=1,
                                 devices=[device] * n_data)
        call = dp.data_parallel(mesh, lambda params, Xs: params.predict(Xs))
        parity[f"data_{n_data}"] = {
            "forest_dp": bool(torch.equal(call(fp0, X), want_forest))}
        results[f"data_{n_data}"] = {
            "forest_dp_ms": round(timed(call, fp0, X) * 1e3, 2)
        }

    # distributed TRAINING canaries (cold, one call each)
    Xt, yt, C = canary_data()
    for n_data in (1, 8):
        mesh = meshlib.make_mesh(n_data=n_data, n_state=1,
                                 devices=[device] * n_data)
        t0 = time.perf_counter()
        fit_forest(mesh, Xt, yt, C, n_trees=4, max_depth=6, n_bins=32)
        sync(device)
        results.setdefault(f"data_{n_data}", {})["forest_fit_cold_ms"] = (
            round((time.perf_counter() - t0) * 1e3, 1))
    for n_state in (1, 8):
        mesh = meshlib.make_mesh(n_data=1, n_state=n_state,
                                 devices=[device] * n_state)
        t0 = time.perf_counter()
        fit_svc(mesh, Xt, yt, C, n_iters=100, power_iters=10)
        sync(device)
        results.setdefault(f"state_{n_state}", {})["svc_fit_cold_ms"] = (
            round((time.perf_counter() - t0) * 1e3, 1))

    ok = all(v for p in parity.values() for v in p.values())
    print(json.dumps({
        "metric": "sharded_scaling_cpu_mesh",
        "batch": args.batch,
        **device_fields(device),
        "shards_on_one_device": True,
        "results": results,
        "parity": parity,
        "parity_ok": ok,
    }), flush=True)
    if not ok:
        sys.exit("torch_bench_sharded: a sharded path disagrees with the "
                 f"un-sharded model: {parity}")


if __name__ == "__main__":
    main()
