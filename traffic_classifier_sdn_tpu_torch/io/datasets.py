"""The reference's offline training-data pipeline (C12) as a data module.

Mirrors the skeleton every training notebook repeats (SURVEY.md §3.4):
read the per-class CSVs (tab-delimited except game, which is comma-delimited),
concatenate, drop NaN rows (ping has exactly one), drop the 4 cumulative
columns to get the 12 model features, and encode labels alphabetically
(dns=0, game=1, ping=2, quake=3, telnet=4, voice=5 — pandas categorical
codes, ``1_log_Kmeans.ipynb`` cells 26-30).

Note: the notebooks trained on 6 classes (8897 rows) but
``6_quake_training_data.csv`` is absent from the repository (SURVEY.md §2,
C14), so pipelines built from ``datasets/`` see the 5 available classes
(7653 usable rows). Class count is always derived from the data, never
hardcoded.

The port's copy of the JAX package's ``io/datasets.py`` (host numpy
code, unchanged): ``--source workload`` samples its per-class deltas
from these CSVs.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass

import numpy as np

from ..core.features import (
    CSV_COLUMNS_16,
    FEATURE_INDICES_IN_16,
    LABEL_COLUMN,
    NUM_FEATURES,
)

REFERENCE_DATASET_FILES = {
    "dns": "dns_training_data.csv",
    "game": "game_training_data.csv",
    "ping": "ping_training_data.csv",
    "telnet": "telnet_training_data.csv",
    "voice": "voice_training_data.csv",
    # '6_quake_training_data.csv' (1244 rows) is referenced by the notebooks
    # but missing from the repository; included here so a user who has the
    # file can drop it in and get the full 6-class pipeline.
    "quake": "quake_training_data.csv",
}


def _read_csv(path: str) -> np.ndarray:
    """Read one training CSV into an (n, 16) float array, NaN for blanks.

    Delimiter is sniffed from the header line — the reference's game CSV is
    comma-delimited while the rest are tab-delimited (SURVEY.md §2, C14).
    """
    with open(path, newline="") as f:
        header_line = f.readline()
        delim = "," if header_line.count(",") > header_line.count("\t") else "\t"
        header = [h.strip() for h in header_line.strip().split(delim)]
        expected = list(CSV_COLUMNS_16) + [LABEL_COLUMN]
        if header != expected:
            raise ValueError(f"{path}: unexpected header {header[:3]}…")
        n_feat = len(CSV_COLUMNS_16)
        rows = []
        for rec in csv.reader(f, delimiter=delim):
            if not rec:
                continue
            # Ragged rows exist (ping has one truncated row — the NaN row the
            # notebooks dropna away, SURVEY.md §2 C14): pad to 16 features.
            vals = [
                float(v) if v.strip() != "" else np.nan for v in rec[:n_feat]
            ]
            vals += [np.nan] * (n_feat - len(vals))
            rows.append(vals)
    return np.asarray(rows, dtype=np.float64)


@dataclass(frozen=True)
class FlowDataset:
    """Labeled flow-statistics dataset in notebook feature order."""

    X16: np.ndarray  # (n, 16) full engineered features
    X: np.ndarray  # (n, 12) model features (cumulative cols dropped)
    y: np.ndarray  # (n,) int32 alphabetical label codes
    classes: tuple  # label names, alphabetical

    @property
    def n(self) -> int:
        return self.X.shape[0]


def load_reference_datasets(
    dataset_dir: str, dropna: bool = True
) -> FlowDataset:
    """Load all available per-class CSVs from ``dataset_dir``."""
    per_class = {}
    for label, fname in REFERENCE_DATASET_FILES.items():
        path = os.path.join(dataset_dir, fname)
        if os.path.exists(path):
            per_class[label] = _read_csv(path)
    if not per_class:
        raise FileNotFoundError(f"no training CSVs in {dataset_dir}")

    classes = tuple(sorted(per_class))  # alphabetical == pandas categorical
    X16 = np.concatenate([per_class[c] for c in classes], axis=0)
    y = np.concatenate(
        [np.full(len(per_class[c]), i, dtype=np.int32) for i, c in enumerate(classes)]
    )
    if dropna:
        keep = ~np.isnan(X16).any(axis=1)
        X16, y = X16[keep], y[keep]
    X = X16[:, list(FEATURE_INDICES_IN_16)]
    assert X.shape[1] == NUM_FEATURES
    return FlowDataset(X16=X16, X=X, y=y, classes=classes)


def train_test_split(
    ds: FlowDataset, test_size: float = 0.5, seed: int = 101
) -> tuple[FlowDataset, FlowDataset]:
    """Shuffled split with a fixed numpy PRNG seed.

    Functionally equivalent to the notebooks' 50/50
    ``train_test_split(random_state=101)`` (``1_log_Kmeans.ipynb`` cell 10);
    the permutation differs from sklearn's internal one, so accuracies are
    comparable, not bit-identical.
    """
    rng = np.random.RandomState(seed)
    perm = rng.permutation(ds.n)
    n_test = int(round(ds.n * test_size))
    test_idx, train_idx = perm[:n_test], perm[n_test:]

    def take(idx):
        return FlowDataset(
            X16=ds.X16[idx], X=ds.X[idx], y=ds.y[idx], classes=ds.classes
        )

    return take(train_idx), take(test_idx)
