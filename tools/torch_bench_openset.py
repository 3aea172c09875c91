#!/usr/bin/env python
"""Open-set eval of the PyTorch port: known-class accuracy and
unknown-detection ROC for all six model families under the serving
rejection tier (``serving/openset.py``). The twin of
``tools/bench_openset.py``: the same flags, data, ``"bench"`` name and
JSON keys, with the families trained by the port's ``train/`` and scored
by its modules (on the card unless ``--device cpu``).

The claim: adding the calibrated rejection gate costs ~zero known-class
accuracy while detecting a never-trained class, per family, at the
shipped threshold discipline (per-class stats calibrated from the
family's OWN predicted labels, ``threshold = margin × max(calibration
score)``).

Data: class-shaped synthetic traffic (gamma rows scaled by per-class
means at distinct rate scales), seeded; one class is HELD OUT of training
entirely: the unknown application an open-world serve must reject.

Per family, the JSON reports ``closed_accuracy`` / ``gated_accuracy`` /
``accuracy_delta``, ``unknown_tpr_at_threshold`` /
``known_fpr_at_threshold``, ``mahalanobis_auc`` + ``roc`` and
``family_score_auc``.

Prints one JSON line (and writes it to ``--out`` when given).
"""

from __future__ import annotations

import argparse
import json
import sys

from torch_bench_common import add_device_arg, device_fields, resolve_device


def _make_data(seed: int, n_known: int, rows_per_class: int):
    """(theta, Xtr, ytr, Xte, yte, X_unknown): known classes 0..n-1 at
    distinct rate scales, plus a held-out class at an out-of-family
    scale AND an inverted fwd/rev pattern (the novel application)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    F = 12
    # per-class feature means: rate scale 4^c times a class-specific
    # per-feature shape — separable the way real per-app mixes are
    theta = rng.gamma(2.0, 1.0, (n_known + 1, F)) + 0.5
    for c in range(n_known):
        theta[c] *= 100.0 * (4.0 ** c)
    # the unknown application: beyond every known scale, shuffled shape
    theta[n_known] = (
        theta[n_known][rng.permutation(F)] * 100.0 * (4.0 ** (n_known + 2))
    )

    def rows(c, n):
        return (rng.gamma(2.0, 1.0, (n, F)) * theta[c]).astype(
            np.float32
        )

    Xtr = np.concatenate([rows(c, rows_per_class) for c in range(n_known)])
    ytr = np.repeat(np.arange(n_known), rows_per_class).astype(np.int32)
    Xte = np.concatenate(
        [rows(c, rows_per_class // 2) for c in range(n_known)]
    )
    yte = np.repeat(
        np.arange(n_known), rows_per_class // 2
    ).astype(np.int32)
    Xun = rows(n_known, rows_per_class)
    return Xtr, ytr, Xte, yte, Xun


def _auc(pos, neg):
    """Mann-Whitney AUC: P(score(pos) > score(neg)) with tie credit."""
    import numpy as np

    pos = np.asarray(pos, np.float64)
    neg = np.asarray(neg, np.float64)
    order = np.argsort(np.concatenate([pos, neg]), kind="mergesort")
    ranks = np.empty(order.size, np.float64)
    ranks[order] = np.arange(1, order.size + 1)
    # midranks for ties
    allv = np.concatenate([pos, neg])
    for v in np.unique(allv):
        sel = allv == v
        if sel.sum() > 1:
            ranks[sel] = ranks[sel].mean()
    r_pos = ranks[: pos.size].sum()
    u = r_pos - pos.size * (pos.size + 1) / 2.0
    return float(u / (pos.size * neg.size))


def _roc(pos, neg, points: int = 21):
    """[(fpr, tpr)] swept over the pooled score range (pos = unknown
    scores, neg = known scores; higher = more unknown)."""
    import numpy as np

    pool = np.concatenate([pos, neg])
    out = []
    for q in np.linspace(0.0, 1.0, points):
        thr = float(np.quantile(pool, q))
        out.append((
            round(float((neg > thr).mean()), 6),
            round(float((pos > thr).mean()), 6),
        ))
    return out


def _fit(family, Xtr, ytr, n_classes, device):
    """The canonical per-family trainers (the port's retrain path)."""
    if family == "logreg":
        from traffic_classifier_sdn_tpu_torch.train import logreg as t

        return t.fit(Xtr, ytr, n_classes, device=device)
    if family == "gnb":
        from traffic_classifier_sdn_tpu_torch.train import gnb as t

        return t.fit(Xtr, ytr, n_classes, device=device)
    if family == "kmeans":
        from traffic_classifier_sdn_tpu_torch.train import kmeans as t

        params, _inertia = t.fit(Xtr, k=n_classes, device=device)
        return params
    if family == "knn":
        from traffic_classifier_sdn_tpu_torch.train import knn as t

        return t.fit(Xtr, ytr, n_neighbors=5, n_classes=n_classes,
                     device=device)
    if family == "forest":
        from traffic_classifier_sdn_tpu_torch.train import forest as t

        return t.fit(Xtr, ytr, n_classes, device=device)
    from traffic_classifier_sdn_tpu_torch.train import svc as t

    return t.fit(Xtr, ytr, n_classes, device=device)


def _eval_family(family, Xtr, ytr, Xte, yte, Xun, margin, device):
    import numpy as np
    import torch

    from traffic_classifier_sdn_tpu_torch.serving.openset import (
        class_reference,
        openset_scores,
        reference_matrices,
    )

    n_known = int(ytr.max()) + 1
    params = _fit(family, Xtr, ytr, n_known, device)

    def predict(X):
        return params.predict(
            torch.from_numpy(np.asarray(X)).to(device)).cpu().numpy()

    def fam_scores(X):
        # the forest module has no predict_scores: its scores() is the
        # surface JAX's forest.predict_scores returns
        Xd = torch.from_numpy(np.asarray(X)).to(device)
        if family == "forest":
            return params.scores(Xd).cpu().numpy()
        _labels, s = params.predict_scores(Xd)
        return s.cpu().numpy()

    # serving-regime calibration: per-class stats keyed by the
    # family's OWN labels on the training window (kmeans labels are
    # cluster ids — the gate's stats follow whatever label space the
    # family serves, exactly as in the live gate)
    cal_labels = predict(Xtr)
    n_stat_classes = int(cal_labels.max()) + 1
    ref = class_reference(Xtr, cal_labels, n_stat_classes)
    # empty predicted classes are DROPPED, exactly as the serving gate
    # does (reference_matrices) — a phantom class at the origin would
    # accept low-rate novel traffic
    mean, inv_std = reference_matrices(
        ref, np.asarray(Xtr, np.float64).std(axis=0)
    )
    cal_scores = openset_scores(Xtr, mean, inv_std)
    threshold = margin * float(cal_scores.max())

    te_scores = openset_scores(Xte, mean, inv_std)
    un_scores = openset_scores(Xun, mean, inv_std)
    te_pred = predict(Xte)

    if family == "kmeans":
        # cluster ids are a permutation: mode-match before scoring
        # accuracy (analysis.eval's discipline)
        remap = {}
        for cid in np.unique(te_pred):
            vals, counts = np.unique(
                yte[te_pred == cid], return_counts=True
            )
            remap[int(cid)] = int(vals[np.argmax(counts)])
        matched = np.array([remap[int(c)] for c in te_pred])
        closed_acc = float((matched == yte).mean())
        gated_correct = (matched == yte) & (te_scores <= threshold)
    else:
        closed_acc = float((te_pred == yte).mean())
        gated_correct = (te_pred == yte) & (te_scores <= threshold)
    gated_acc = float(gated_correct.mean())

    # family score surface as a confidence diagnostic: LOW max-score =
    # less known (negate so higher = more unknown, like the serving
    # score)
    fam_auc = _auc(-fam_scores(Xun).max(axis=1),
                   -fam_scores(Xte).max(axis=1))

    return {
        "closed_accuracy": round(closed_acc, 6),
        "gated_accuracy": round(gated_acc, 6),
        "accuracy_delta": round(gated_acc - closed_acc, 6),
        "threshold": round(threshold, 6),
        "unknown_tpr_at_threshold": round(
            float((un_scores > threshold).mean()), 6
        ),
        "known_fpr_at_threshold": round(
            float((te_scores > threshold).mean()), 6
        ),
        "mahalanobis_auc": round(_auc(un_scores, te_scores), 6),
        "family_score_auc": round(fam_auc, 6),
        "roc": _roc(un_scores, te_scores),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--margin", type=float, default=3.0,
                    help="the shipped --openset-margin (default 3.0)")
    ap.add_argument("--rows-per-class", type=int, default=1024)
    ap.add_argument("--known-classes", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument(
        "--families", default="logreg,gnb,kmeans,knn,svc,forest",
        help="comma-separated family subset (smoke tests trim the "
        "fit cost; the committed artifact carries all six)",
    )
    ap.add_argument("--out", default=None,
                    help="also write the JSON here")
    add_device_arg(ap)
    args = ap.parse_args()
    device = resolve_device(args.device)

    Xtr, ytr, Xte, yte, Xun = _make_data(
        args.seed, args.known_classes, args.rows_per_class
    )
    families = tuple(
        f.strip() for f in args.families.split(",") if f.strip()
    )
    out = {
        "bench": "openset_eval",
        **device_fields(device),
        "margin": args.margin,
        "known_classes": args.known_classes,
        "rows_per_class": args.rows_per_class,
        "seed": args.seed,
        "families": {},
        "notes": (
            "serving-regime calibration: per-class stats from each "
            "family's own predicted labels on the training window; "
            "threshold = margin x max calibration score. A rejected "
            "known-class row counts as an error in gated_accuracy, so "
            "accuracy_delta is the gate's false-reject cost. roc is "
            "[fpr, tpr] over the pooled score quantiles."
        ),
    }
    for family in families:
        print(f"evaluating {family} ...", file=sys.stderr, flush=True)
        out["families"][family] = _eval_family(
            family, Xtr, ytr, Xte, yte, Xun, args.margin, device
        )
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
