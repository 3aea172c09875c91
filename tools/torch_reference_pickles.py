#!/usr/bin/env python3
"""Write seeded scikit-learn pickles in the layout of the reference's
``models/`` directory, at the shapes of its six checkpoints (SURVEY.md
§2.2), for the port's ``--checkpoint-dir`` classify path.

    python3 tools/torch_reference_pickles.py [--out tests/data/reference_pickles]

Needs scikit-learn (the pickles are fitted estimators); reading them back
does not (io/sklearn_import.py unpickles them with stub classes). The
training rows are ``chip_smoke.reference_csvs`` at 1,483 rows for each of
the notebooks' six classes (``chip_smoke.NOTEBOOK_CSVS``), split 50/50
with seed 101 as ``retrain`` splits them, of which the first 4,448 are
kept (the reference's ``shape_fit_``):

- ``RandomForestClassifier``: 100 fully grown trees (pure leaves, as the
  reference's ``max_depth=None``), ``max_features='sqrt'`` (3 of 12),
  fitted on labels of which a seeded 0.2 % are redrawn at random: on the
  clean labels these well-separated classes give trees of 11-49 nodes
  and depth 3-8, on these 27-89 nodes and depth 6-13 (the reference's:
  25-101 nodes, depth 5-14);
- ``KNeighbors``: k = 5 over the 4,448 rows;
- ``SVC``: RBF, ``gamma='scale'``, fitted on rows of all 8,898 drawn in
  the per-class counts of the reference's ``n_support_`` (579, 516, 759,
  115, 199, 113), with the first C of ``SVC_C`` under which every row is
  a support vector: 2,281 SVs, 15 pairs;
- ``GaussianNB`` on six classes; ``LogisticRegression`` (lbfgs, 100
  iterations) on the reference's four classes (dns, ping, telnet,
  voice); ``KMeans_Clustering`` with 4 clusters, k-means++, 10 inits.

Every estimator has a fixed ``random_state``, so a rerun with the same
scikit-learn writes the same arrays, but for the k-means centers and
inertia: sklearn's threaded Lloyd adds in an order that can move their
last bits. Prints each file's size and shapes.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import tempfile
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SEED = 0
ROWS_PER_CLASS = 1483
FIT_ROWS = 4448  # the reference pickles' shape_fit_
SVC_SUPPORT = (579, 516, 759, 115, 199, 113)  # the reference's n_support_
LOGREG_CLASSES = ("dns", "ping", "telnet", "voice")
FOREST_LABEL_NOISE = 0.002  # share of the forest's labels redrawn
SVC_C = (1.0, 0.1, 0.01, 1e-3, 1e-4)  # tried in order: all rows SVs


def training_rows():
    """(X (4448, 12), y, all rows' X, all rows' y, classes) of the seeded
    notebook-class CSVs."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from traffic_classifier_sdn_tpu_torch.io.datasets import (
        load_reference_datasets,
        train_test_split,
    )

    with tempfile.TemporaryDirectory() as d:
        chip_smoke.reference_csvs(d, rows=ROWS_PER_CLASS, seed=SEED,
                                  files=chip_smoke.NOTEBOOK_CSVS)
        ds = load_reference_datasets(d)
    tr, _ = train_test_split(ds, test_size=0.5, seed=101)
    return tr.X[:FIT_ROWS], tr.y[:FIT_ROWS], ds.X, ds.y, ds.classes


def fit_all(X, y, X_all, y_all, classes) -> dict:
    """{reference file name: fitted estimator}."""
    from sklearn.cluster import KMeans
    from sklearn.ensemble import RandomForestClassifier
    from sklearn.linear_model import LogisticRegression
    from sklearn.naive_bayes import GaussianNB
    from sklearn.neighbors import KNeighborsClassifier
    from sklearn.svm import SVC

    names = np.asarray(classes)[y]
    rng = np.random.RandomState(SEED)
    noisy = y.copy()
    flip = rng.rand(len(y)) < FOREST_LABEL_NOISE
    noisy[flip] = rng.randint(0, len(classes), int(flip.sum()))
    out = {}
    out["RandomForestClassifier"] = RandomForestClassifier(
        n_estimators=100, max_features="sqrt", random_state=SEED).fit(
            X, np.asarray(classes)[noisy])
    out["KNeighbors"] = KNeighborsClassifier(n_neighbors=5).fit(X, names)
    pick = np.concatenate([
        rng.choice(np.nonzero(y_all == c)[0], n, replace=False)
        for c, n in enumerate(SVC_SUPPORT)])
    names_all = np.asarray(classes)[y_all]
    for C in SVC_C:
        svc = SVC(kernel="rbf", C=C, gamma="scale").fit(X_all[pick],
                                                        names_all[pick])
        if len(svc.support_) == len(pick):
            break
    else:
        raise SystemExit(f"no C in {SVC_C} makes all {len(pick)} rows SVs")
    out["SVC"] = svc
    out["GaussianNB"] = GaussianNB().fit(X, names)
    four = np.isin(names, LOGREG_CLASSES)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # lbfgs stops at max_iter, as there
        out["LogisticRegression"] = LogisticRegression(max_iter=100).fit(
            X[four], names[four])
    out["KMeans_Clustering"] = KMeans(n_clusters=4, n_init=10,
                                      random_state=SEED).fit(X)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "tests", "data", "reference_pickles"))
    args = ap.parse_args(argv)
    rows = training_rows()
    os.makedirs(args.out, exist_ok=True)
    for name, est in fit_all(*rows).items():
        path = os.path.join(args.out, name)
        with open(path, "wb") as f:
            pickle.dump(est, f, protocol=4)
        shapes = {k: np.shape(v) for k, v in vars(est).items()
                  if isinstance(v, np.ndarray) and v.ndim}
        if name == "RandomForestClassifier":
            nodes = [e.tree_.node_count for e in est.estimators_]
            depth = [e.tree_.max_depth for e in est.estimators_]
            shapes["node_count min/mean/max"] = (
                min(nodes), float(np.mean(nodes)), max(nodes))
            shapes["max_depth min/mean/max"] = (
                min(depth), float(np.mean(depth)), max(depth))
        if name == "SVC":
            shapes["C"] = est.C
        print(f"{name}: {os.path.getsize(path)} bytes; {shapes}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
