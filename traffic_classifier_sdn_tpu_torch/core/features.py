"""Feature schema for per-flow traffic classification.

The reference engineers 16 per-flow columns (8 per direction) and trains on a
12-feature subset that drops the 4 cumulative counters. Column names and order
come from the training-CSV header written at traffic_classifier.py:217 and the
online feature vector assembled at traffic_classifier.py:104; the notebooks
drop the cumulative columns before fitting (SURVEY.md §3.4/§3.5).

Order matters: the online 12-vector must match the training column order
exactly (no scaling is applied in the reference, and none is applied here).
"""

from __future__ import annotations

# The 17-column training-CSV schema (16 features + label), exactly as the
# reference's training-data writer emits it (traffic_classifier.py:217).
CSV_COLUMNS_16 = (
    "Forward Packets",
    "Forward Bytes",
    "Delta Forward Packets",
    "Delta Forward Bytes",
    "Forward Instantaneous Packets per Second",
    "Forward Average Packets per second",
    "Forward Instantaneous Bytes per Second",
    "Forward Average Bytes per second",
    "Reverse Packets",
    "Reverse Bytes",
    "Delta Reverse Packets",
    "Delta Reverse Bytes",
    "DeltaReverse Instantaneous Packets per Second",
    "Reverse Average Packets per second",
    "Reverse Instantaneous Bytes per Second",
    "Reverse Average Bytes per second",
)
LABEL_COLUMN = "Traffic Type"

# The 4 cumulative columns dropped before training (notebook cell 4 of every
# training notebook; SURVEY.md §3.4).
CUMULATIVE_COLUMNS = (
    "Forward Packets",
    "Forward Bytes",
    "Reverse Packets",
    "Reverse Bytes",
)

# The 12 model-input features, in training column order — which the online
# vector at traffic_classifier.py:104 matches exactly.
FEATURE_COLUMNS_12 = tuple(
    c for c in CSV_COLUMNS_16 if c not in CUMULATIVE_COLUMNS
)

NUM_FEATURES = 12
assert len(FEATURE_COLUMNS_12) == NUM_FEATURES

# Indices of the 12 model features within the 16-column row.
FEATURE_INDICES_IN_16 = tuple(
    i for i, c in enumerate(CSV_COLUMNS_16) if c not in CUMULATIVE_COLUMNS
)

# Canonical 6-class label set, alphabetical — pandas categorical coding used
# by every notebook (dns=0, game=1, ping=2, quake=3, telnet=4, voice=5;
# SURVEY.md §3.4), which the reference's online remap at
# traffic_classifier.py:109-114 mirrors.
CLASSES_6 = ("dns", "game", "ping", "quake", "telnet", "voice")
