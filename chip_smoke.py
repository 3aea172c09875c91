#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``). Phases, one after another; any failure raises and
the script exits non-zero:

1. environment — the card's name and power limit, torch/CUDA versions,
   the TF32 settings;
2. build — every CUDA kernel of the port, from ``csrc/``, all ``nvcc``
   processes started together, and beside them (g++) the port's C++
   ingest engine, ``native/flow_engine.cpp``;
3. kernels against their plain versions on the card, with X from
   ``features12`` of synthetic flow tables at N = 777, 65,536 and
   1,048,576, on seeded models of the reference checkpoints' shapes (the
   reference pickles are not in the repository):
   - forest_proba: 100 trees, node counts 25-101, depth <= 14, 6 classes,
     12 features; probabilities bitwise equal, also on a copy of the
     65,536 rows with NaN/+inf/-inf features (``with_nonfinite``);
   - knn_topk: a 4448-row corpus, k = 5, 6 classes; neighbor indices and
     similarities bitwise equal;
   - rbf_decision: 2281 support vectors split over 6 classes, 15 pairs;
     decisions bitwise equal;
   labels equal for all three; CUDA-event median times of single calls,
   the time of 20 calls back to back over 20, the plain version's time,
   the bound (least time the card could take), and each launch shape with
   its instance's ptxas registers, shared memory and spills; then the
   forest kernel at every dirty bucket of incremental labels (16 to
   16,384 rows), bitwise, with its single-call and back-to-back times;
   The KNN and SVC kernels are also held bitwise to their plain versions
   on a copy of the rows with NaN/+inf/-inf features in every third row
   (``with_nonfinite(X, every=3)``) at 777 and 65,536 rows and every
   launch shape, every KNN index in [0, S);
4. serve — the port CLI in-process, serial (``<subcommand> --source
   synthetic --synthetic-flows 65536 --capacity 65536 --max-ticks 6
   --print-every 2 --pipeline off --degrade off``; native ingest and
   incremental labels at their defaults) for ``Randomforest``,
   ``knearest`` and ``svm`` on those models: 65,536 flows tracked, one
   launch of the family's kernel per render tick (every conversation
   reports every tick, so each render predicts the full table; every
   launch count set to 0 just before the serve and read just after), 64
   rows per rendered table, and the last table's labels equal to the
   plain version's labels on the same table;
4b. default serve — the same three serves with no flag at all: the JAX
   defaults, pipelined (serving/pipeline.py), through the degrade ladder
   (serving/degrade.py) and host-mode incremental labels. Every printed
   table's labels equal the plain version's on the table its render was
   dispatched against; the ladder stays HEALTHY with no fallback call and
   no transition; each render launches the kernel once (each predicts the
   whole table); ``ticks_coalesced`` and the host and device stages' busy
   seconds are printed. These are the main path: their launches are the
   ``launches`` of the kernels line;
4c. ladder drills — for each family, the no-flag serve (forest and KNN
   at 65,536 flows, SVC at 4,096, ``DRILL_FLOWS``; 10 ticks) with
   ``degrade.dispatch_error`` armed on the second device call (``--probe-every
   0 --probe-successes 2``): the ladder demotes, the demoted tables'
   labels (the host rung's) equal the plain version's, and it re-promotes
   after two clean probes, probes failing before that only on parity;
   then ``degrade.dispatch_stall`` armed the same way with
   ``--device-deadline 1``: every render stays within twice the
   deadline; then the kernel's wrapper raising from its second call, no
   site armed: the serve ends with that error and the ladder does not
   demote. The transitions are printed. One call of each host rung on
   65,536 rows is timed, its labels equal to the plain version's but on
   near-ties (``near_ties``);
4d. warmup — the no-flag forest serve of 65,536 flows with and without
   ``--warmup``: what warmup warmed, its seconds, and each render's time
   on the device stage, the first against the later ones;
5. incremental serve — ``Randomforest --source replay --native-ingest on
   --incremental auto --print-every 1 --pipeline off --degrade off`` on a
   churn capture of 65,536
   conversations (``churn_capture``: two full ticks, then 1 %, 0 %, 20 %
   and 100 % of them reporting): every table's labels equal the plain
   version's on the table it rendered, the forest kernel launches once on
   each render tick with a dirty row and never on the others, and stdout
   is byte-identical to the same capture served with ``--incremental off
   --native-ingest off``;
6. ryu serve — ``Randomforest --source ryu --monitor-cmd "<emitter>"
   --native-ingest on --pipeline off --degrade off``: a script written to a
   temporary directory prints
   the churn capture's ticks to its stdout, paced apart; every flow is
   tracked, every line parsed, the kernel launches on each render tick
   with a dirty row, and the last table's labels equal the plain
   version's;
6b. 2^20 flows — the no-flag forest serve of ``--capacity 1048576`` fed as
   raw pipe bytes through ``--source ryu`` by an emitter that generates
   four ticks of ``SyntheticFlows(1048576)`` (~2.1 M lines, ~120 MB each)
   in memory: every flow tracked, every line parsed, the last table's
   labels equal the plain version's; each poll's host time, each
   render's label time on the device stage and ``ticks_coalesced``;
6c. fan-in — the no-flag forest serve through the fan-in tier
   (``--sources 3 --source synthetic --synthetic-flows 65536
   --source-lockstep --source-quarantine 0``, 8 ticks): 21,845 flows per
   namespace fed as raw bytes into the C++ engine under each source's id;
   source 1 is killed after tick 2 (``kill_after``). Exactly its namespace
   is evicted, sources 0 and 2 keep their slots and render on, every
   printed table's labels equal the plain version's on the table its
   render was dispatched against, the roster ends HEALTHY, DEAD, HEALTHY
   and the ladder stays HEALTHY; each tick's host-stage and ingest seconds
   and the eviction's seconds are printed;
6d. families — the no-flag serves of ``logistic``, ``gaussiannb`` and
   ``kmeans`` at 65,536 synthetic flows (plain torch ops on the card: no
   kernel is launched): every printed table's labels equal the same
   module's labels on the CPU for the features its render was dispatched
   against, but on near-ties (``near_ties``); each family's predict on the
   65,536 served rows timed (CUDA-event median); then a
   ``degrade.dispatch_error`` drill of ``gaussiannb`` that demotes to the
   ``plain-cpu`` rung and re-promotes;
6e. knn-tiers — on 65,536 served rows (finite), the ``--knn-topk`` tiers
   ``sort``, ``pallas`` (the kernel), ``argmax``, ``hier``, ``hier512``,
   ``screened`` and ``screened64`` (torch tiers): each one's neighbor
   indices bitwise equal to the kernel's, ``native`` labels equal to the
   kernel's but on near-ties; each tier's predict timed beside the
   kernel's, and ``torch.matmul + torch.topk`` warmed (context only);
6f. ivf — the port's quantizer fit on the corpus on the card (K = 67):
   at nprobe = K labels and ``ivf_top1`` bitwise equal to the exact
   tier's, recall@1 at nprobe 1, 2 and 4, card labels equal to the CPU's
   on the same quantizer but on near-ties, the native mirror equal to the
   torch tier at nprobe = K but on near-ties; the build seconds and each
   form's predict time at 65,536 rows;
6g. svc-dot — ``TCSDN_SVC_KERNEL=dot`` on 65,536 served rows: its time
   beside the kernel's, its disagreements with the kernel, and its labels
   held to the CPU's dot form on every row outside ``dot_rule_rows`` (the
   rows where the float32 dot expansion's error bound reaches a
   decision's sign);
6h. menu serves — the no-flag serves at 65,536 flows of ``knearest
   --knn-topk hier``, ``knearest --knn-topk ivf`` (the native mirror, no
   ladder), ``svm`` with ``TCSDN_SVC_KERNEL=dot`` and ``Randomforest``
   with ``TCSDN_FOREST_KERNEL=native``, every printed table's labels equal
   to the tier's own function on the table its render was dispatched
   against;
6i. controller — ``Randomforest --source controller --of-port <free
   port>`` with no other flag: the port's own controller, spawned by the
   serve, and ``tools/torch_fake_switch.py`` conversing 64 host pairs for
   6 polls; the tables' labels equal the plain version's, and the
   controller ends on the serve's SIGTERM; then ``--source workload``
   on seeded training CSVs in the reference layout (20,480 flows, 6
   ticks): tick seconds and labels per class against the generator's
   ground truth;
6j. obs — the no-flag forest serve of 65,536 synthetic flows with
   ``--metrics-every 2 --obs-port 0 --obs-dir D`` and a snapshot due
   every tick under the default budget (its saves and skips), its source
   held after 6 ticks (``held_source``): ``/metrics`` scraped while it
   ticks (at least two scrapes with the ``tcsdn_stage_*`` summaries of
   poll, parse, scatter, predict, render and snapshot, and the counters
   and gauges the serve writes), ``/healthz`` 200 with the ``degrade``,
   ``label_cache`` and ``latency`` blocks, ``/events``, then SIGTERM:
   exit 143 and a flight-recorder dump whose last event is
   ``signal.sigterm``; its tables against the same serve with the obs
   surfaces off (the subsequence rule), host tick p50 with latency
   provenance on and off (one serve each) beside the plane's own host
   work a tick (``provenance_cost_s``), and a ``degrade.dispatch_error``
   drill that stays demoted: ``/healthz`` shows the rung, the dump holds
   the transition;
6k. checkpoint — a serial forest serve (``--pipeline off``) of a
   65,536-flow capture, snapshotting every 2 ticks, stopped after tick 4
   and restored: the rest prints the uninterrupted serve's stdout byte
   for byte, its labels the plain version's; the newest member truncated:
   the restore rolls back to the one before (recorded in the flight
   recorder) and prints ticks 3-6 as the uninterrupted serve; a member
   saved on the card restores on the CPU and back, every leaf and the
   index bitwise; save and restore seconds and bytes at 65,536 and 2^20
   flows;
7. breakdown — host seconds per tick of 131,072 records into 65,536 flows
   through the Python spine, the native spine from records and the
   native spine from raw bytes (each with ``step()`` and a device sync),
   and the device time of each step of the incremental label plan at 0,
   1, 20 and 100 % churn beside the full re-predict;
8. summary — a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` name and
   power-limit line, and as the last line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

It exits non-zero without printing a result when no CUDA device is
visible, and imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 0
HERE = os.path.dirname(os.path.abspath(__file__))
N_TREES = 100
N_CLASSES = 6
N_FEATURES = 12
NODE_COUNT = (25, 101)  # reference checkpoint: node_count min/max
MAX_DEPTH = 14  # reference checkpoint: max_depth max
KNN_ROWS, KNN_NEIGHBORS = 4448, 5  # reference checkpoint KNeighbors
SVC_VECTORS = 2281  # reference checkpoint SVC: support vectors, 15 pairs
KMEANS_CLUSTERS = 4  # reference checkpoint KMeans_Clustering
CAPACITY = 65536
SHAPES = (777, 65536, 1 << 20)
TIMED_RUNS = 30
# the plain KNN/SVC versions take seconds at 2^20 rows: few runs each
PLAIN_RUNS = {777: 10, 65536: 5, 1 << 20: 2}
CLASSES = ("dns", "game", "ping", "quake", "telnet", "voice")
# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s and
# non-tensor-core float32 operations/s.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# churn of each tick of the incremental serve's capture: two full ticks,
# then 1 % (655 conversations, dirty bucket 1,024), 0 %, 20 % (13,107,
# bucket 16,384) and 100 % (above the largest bucket: full predict)
CHURN_SCHEDULE = (1.0, 1.0, 0.01, 0.0, 0.2, 1.0)


def random_forest(seed: int, X_sample: np.ndarray, n_trees: int = N_TREES,
                  n_classes: int = N_CLASSES, node_count=NODE_COUNT,
                  max_depth: int = MAX_DEPTH) -> dict:
    """A seeded random forest in importer layout (``left``/``right``/
    ``feature``/``threshold``/``values`` of shape (T, M[, C])).

    Each tree grows by splitting leaves (depth < ``max_depth``), chosen
    with odds proportional to the ``X_sample`` rows reaching them, until it
    has (node_count - 1) / 2 internal nodes, the node count drawn
    from ``node_count``. A split's threshold is drawn from the values of
    ``X_sample`` rows that reach the node, so leaves are reached broadly by
    inputs of that distribution. Leaf class counts are skewed but never
    pure, so near-ties between classes are rare."""
    rng = np.random.RandomState(seed)
    M = node_count[1]
    F = X_sample.shape[1]
    left = np.full((n_trees, M), -1, np.int32)
    right = np.full((n_trees, M), -1, np.int32)
    feature = np.zeros((n_trees, M), np.int32)
    threshold = np.zeros((n_trees, M), np.float64)
    values = np.zeros((n_trees, M, n_classes), np.float64)
    deepest = 0
    for t in range(n_trees):
        n_internal = rng.randint(
            (node_count[0] - 1) // 2, (node_count[1] - 1) // 2 + 1
        )
        rows = {0: np.arange(X_sample.shape[0])}
        depth = {0: 0}
        n_nodes = 1
        for _ in range(n_internal):
            # split where the data is, as a trainer does: a leaf is
            # chosen with odds proportional to the sample rows reaching it
            open_leaves = [n for n in rows if depth[n] < max_depth]
            weight = np.array([rows[n].size + 1.0 for n in open_leaves])
            n = open_leaves[rng.choice(len(open_leaves), p=weight / weight.sum())]
            f = rng.randint(F)
            r = rows.pop(n)
            col = X_sample[r, f] if r.size else X_sample[:, f]
            thr = float(col[rng.randint(col.size)])
            go_left = X_sample[r, f] <= thr
            left[t, n], right[t, n] = n_nodes, n_nodes + 1
            feature[t, n], threshold[t, n] = f, thr
            rows[n_nodes], rows[n_nodes + 1] = r[go_left], r[~go_left]
            depth[n_nodes] = depth[n_nodes + 1] = depth[n] + 1
            deepest = max(deepest, depth[n] + 1)
            n_nodes += 2
        for n in rows:  # the leaves
            values[t, n] = rng.gamma(0.3, 100.0, n_classes) + 1e-3
    return {
        "left": left, "right": right, "feature": feature,
        "threshold": threshold, "values": values, "max_depth": deepest,
        "n_features": F,
    }


def _jittered_rows(rng, X_sample: np.ndarray, n: int) -> np.ndarray:
    """``n`` rows drawn from ``X_sample``, each value scaled by a factor
    near 1 (float64): rows near the served ones, not copies of them, with
    a nonzero two-float residual."""
    rows = X_sample[rng.randint(X_sample.shape[0], size=n)].astype(np.float64)
    return np.abs(rows * (1.0 + 0.05 * rng.randn(*rows.shape)))


def random_knn(seed: int, X_sample: np.ndarray, n_rows: int = KNN_ROWS,
               n_neighbors: int = KNN_NEIGHBORS,
               n_classes: int = N_CLASSES) -> dict:
    """A seeded KNN model in importer layout (``fit_X`` (S, F) float64,
    ``y``, ``n_neighbors``, ``classes``): the corpus is drawn from
    ``X_sample`` (``_jittered_rows``), so served rows have near neighbors,
    and the labels are uniform over the classes."""
    rng = np.random.RandomState(seed)
    return {
        "fit_X": _jittered_rows(rng, X_sample, n_rows),
        "y": rng.randint(0, n_classes, n_rows),
        "n_neighbors": n_neighbors,
        "classes": np.arange(n_classes),
    }


def random_svc(seed: int, X_sample: np.ndarray, n_sv: int = SVC_VECTORS,
               n_classes: int = N_CLASSES) -> dict:
    """A seeded RBF-SVC in libsvm importer layout (``support_vectors``,
    ``dual_coef`` (C−1, S), ``n_support``, ``intercept`` (P,), ``gamma``).
    Support vectors are drawn from ``X_sample`` (``_jittered_rows``) and γ
    is sklearn's ``'scale'`` of that sample, 1 / (F · Var): without both,
    exp(−γ·d²) underflows to 0 on served rows and every decision is its
    intercept. Dual coefficients are y·α with α in (0, 1] (the box of
    C = 1) and libsvm's signs: a class-c vector's coefficient for the pair
    (c, o) is positive when c < o, so a row near class-c vectors votes c."""
    rng = np.random.RandomState(seed)
    n_support = rng.multinomial(n_sv - n_classes,
                                np.full(n_classes, 1.0 / n_classes)) + 1
    sv_class = np.repeat(np.arange(n_classes), n_support)
    other = np.arange(n_classes - 1)[:, None]  # row r pairs class c with o
    other = other + (other >= sv_class[None, :])
    sign = np.where(sv_class[None, :] < other, 1.0, -1.0)
    n_pairs = n_classes * (n_classes - 1) // 2
    return {
        "support_vectors": _jittered_rows(rng, X_sample, n_sv),
        "dual_coef": sign * rng.uniform(1e-3, 1.0, (n_classes - 1, n_sv)),
        "n_support": n_support,
        "intercept": rng.normal(0.0, 0.5, n_pairs),
        "gamma": 1.0 / (X_sample.shape[1] * X_sample.astype(np.float64).var()),
    }


def random_logreg(seed: int, X_sample: np.ndarray,
                  n_classes: int = N_CLASSES) -> dict:
    """A seeded multinomial logistic regression in importer layout
    (``coef`` (C, F), ``intercept`` (C,), float64). Each coefficient is a
    normal draw over its feature's spread in ``X_sample``, so every feature
    moves the scores of served rows alike, and the intercepts center each
    class's score on the sample mean, so several classes win."""
    rng = np.random.RandomState(seed)
    X = X_sample.astype(np.float64)
    coef = rng.randn(n_classes, X.shape[1]) / (X.std(0) + 1.0)
    intercept = -(X.mean(0) @ coef.T) + rng.normal(0.0, 0.5, n_classes)
    return {"coef": coef, "intercept": intercept}


def random_gnb(seed: int, X_sample: np.ndarray,
               n_classes: int = N_CLASSES) -> dict:
    """A seeded Gaussian naive Bayes in importer layout (``theta``, ``var``
    (C, F), ``class_prior`` (C,)): class means are rows near served ones
    (``_jittered_rows``), variances the sample's own scaled by a gamma
    draw per class and feature, and the priors a Dirichlet draw."""
    rng = np.random.RandomState(seed)
    F = X_sample.shape[1]
    return {
        "theta": _jittered_rows(rng, X_sample, n_classes),
        "var": X_sample.astype(np.float64).var(0)[None, :]
        * rng.gamma(2.0, 0.5, (n_classes, F)) + 1.0,
        "class_prior": rng.dirichlet(np.full(n_classes, 5.0)),
    }


def random_kmeans(seed: int, X_sample: np.ndarray,
                  n_clusters: int = KMEANS_CLUSTERS) -> dict:
    """A seeded k-means in importer layout (``cluster_centers`` (K, F)):
    centers are rows near served ones (``_jittered_rows``)."""
    rng = np.random.RandomState(seed)
    return {"cluster_centers": _jittered_rows(rng, X_sample, n_clusters)}


def tick_wire(syn, create: bool) -> np.ndarray:
    """One tick of ``SyntheticFlows`` as the packed wire the Python ingest
    path builds for it: conversation i in slot i, its forward record
    creating (first tick) or updating the row and its reverse record
    updating it."""
    from traffic_classifier_sdn_tpu_torch.core import flow_table as ft

    act = syn.step_counters()
    slot = np.repeat(act.astype(np.int32), 2)
    pkts = np.empty(slot.size, np.int64)
    byts = np.empty(slot.size, np.int64)
    pkts[0::2], pkts[1::2] = syn.cum_pkts_fwd[act], syn.cum_pkts_rev[act]
    byts[0::2], byts[1::2] = syn.cum_bytes_fwd[act], syn.cum_bytes_rev[act]
    is_fwd = np.zeros(slot.size, bool)
    is_fwd[0::2] = True
    u32 = np.uint64(0xFFFFFFFF)
    batch = ft.UpdateBatch(
        slot=slot,
        time=np.full(slot.size, syn.t, np.int32),
        pkts_lo=(pkts.astype(np.uint64) & u32).astype(np.uint32),
        pkts_f=pkts.astype(np.float32),
        bytes_lo=(byts.astype(np.uint64) & u32).astype(np.uint32),
        bytes_f=byts.astype(np.float32),
        is_fwd=is_fwd,
        is_create=is_fwd & create,
    )
    syn.t += 1
    return ft.pack_wire(batch)


def synthetic_table(n_flows: int, ticks: int, device):
    """A flow table after ``ticks`` poll ticks of ``SyntheticFlows(n_flows)``
    — the table the Python ingest path builds, written in bulk through the
    port's ``apply_wire`` (``tick_wire``) so that 2^20 flows take seconds
    instead of Python's per-record minutes."""
    from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
    from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows

    syn = SyntheticFlows(n_flows=n_flows)
    table = ft.make_table(n_flows, device)
    for k in range(ticks):
        table = ft.apply_wire(
            table, ft.wire_tensor(tick_wire(syn, k == 0), device)
        )
    return table


def node_visits(k, X) -> int:
    """Node visits the walk makes on these inputs (the data-dependent
    operation count of the forest kernel), counted with torch ops on the
    rows' effective features."""
    import torch

    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk

    T, D = k.n_trees, k.n_internal
    feat, thr, left, right = fk.unpack_records(k)
    trees = torch.arange(T, device=X.device)[None, :]
    total = 0
    for i in range(0, X.shape[0], 1 << 17):
        x = fk.effective_features(X[i: i + (1 << 17)])
        code = torch.zeros((x.shape[0], T), dtype=torch.int64, device=X.device)
        active = torch.ones_like(code, dtype=torch.bool)
        while bool(active.any()):
            c = code.clamp_max(D - 1)
            xv = torch.gather(x, 1, feat[trees, c])
            nxt = torch.where(xv <= thr[trees, c], left[trees, c], right[trees, c])
            total += int(active.sum())
            code = torch.where(active, nxt, code)
            active &= code < D
    return total


def forest_bound(k, X, visits: int) -> tuple[float, str]:
    """(ms, "bytes"|"operations"): the larger of the bytes the function
    must move (X in, (N, C) out, the tree blobs once) over the HBM rate,
    and its operations (one compare per node visit, C adds per tree per
    row) over the card's float32 rate."""
    N = X.shape[0]
    nbytes = X.numel() * 4 + N * k.n_classes * 4 + k.forest.numel() * 4
    ops = visits + N * k.n_trees * k.n_classes
    return _bound(nbytes, ops)


def with_nonfinite(X, every: int = 7):
    """A copy of X with NaN, +inf or -inf (in turn) in one feature of every
    ``every``-th row, and a second one in every other such row."""
    X = X.clone()
    F = X.shape[1]
    rows = list(range(0, X.shape[0], every))
    kinds = (float("nan"), float("inf"), float("-inf"))
    for j, i in enumerate(rows):
        X[i, (5 * j) % F] = kinds[j % 3]
        if j % 2:
            X[i, (5 * j + 1 + j % (F - 1)) % F] = kinds[(j // 2) % 3]
    return X


def knn_pair_ops(g) -> int:
    """Operations per (row, corpus row) pair of the KNN top-k: F
    multiplies, F − 1 adds, one subtract and one compare (2F + 1)."""
    return 2 * g.n_features + 1


def knn_bound(g, X) -> tuple[float, str]:
    """(ms, "bytes"|"operations") of the KNN top-k: X in, (N, k) values and
    indices out, the corpus records once; ``knn_pair_ops`` per pair."""
    N, F = X.shape
    nbytes = X.numel() * 4 + N * g.n_neighbors * 8 + g.n_rows * (F + 1) * 4
    return _bound(nbytes, N * g.n_rows * knn_pair_ops(g))


def svc_pair_ops(g) -> int:
    """Operations per (row, SV) pair of the RBF-SVC decision: 4 per
    feature for d², the γ product, the exp, and P multiply-adds (4F + 2 +
    2P, 80 for F = 12, P = 15)."""
    return 4 * g.n_features + 2 + 2 * g.n_pairs


def svc_bound(g, X) -> tuple[float, str]:
    """(ms, "bytes"|"operations") of the RBF-SVC decision: X in, (N, P) out,
    the support vectors (hi, lo, coefficients) once; ``svc_pair_ops`` per
    pair."""
    N, F = X.shape
    P = g.n_pairs
    nbytes = X.numel() * 4 + N * P * 4 + g.n_sv * (2 * F + P) * 4
    return _bound(nbytes, N * g.n_sv * svc_pair_ops(g))


def _bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_median_ms(fn, runs: int, warmup: int = 3) -> float:
    """Median over ``runs`` single calls, each timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_back_to_back_ms(fn, launches: int = 20, warmup: int = 3) -> float:
    """``launches`` calls back to back between two CUDA events, divided by
    ``launches``: the rate at which calls follow one another, against the
    single-call median, which also holds the wrapper's host work."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def parse_tables(text: str) -> list[list[tuple[int, str]]]:
    """The rendered tables of a serve's stdout as [(slot, label), ...]."""
    tables, rows, seps = [], None, 0
    for line in text.splitlines():
        if line.startswith("+"):
            seps += 1
            if seps % 3 == 1:
                rows = []
            elif seps % 3 == 0:
                tables.append(rows)
            continue
        if line.startswith("|") and seps % 3 == 2:
            cells = [c.strip() for c in line.strip("|").split("|")]
            rows.append((int(cells[0]), cells[3]))
    return tables


def phase_environment() -> str:
    import torch

    from traffic_classifier_sdn_tpu_torch.device import resolve_device

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    resolve_device("cuda")  # applies the precision policy
    print(f"[env] card: {smi}")
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible")
    print(f"[env] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    return smi


def knn_plain_predict(g, X):
    """Labels of the KNN kernel's plain version (votes of its top-k)."""
    import torch

    from traffic_classifier_sdn_tpu_torch.models import knn
    from traffic_classifier_sdn_tpu_torch.ops import knn_kernel as kk

    idx = kk.topk_sim_idx_plain(g, X)[1]
    return torch.argmax(knn.count_votes(g.fit_y, g.n_classes, idx), dim=-1)


def svc_plain_predict(g, X):
    """Labels of the RBF-SVC kernel's plain version (ovo votes)."""
    import torch

    from traffic_classifier_sdn_tpu_torch.models import svc
    from traffic_classifier_sdn_tpu_torch.ops import rbf_kernel as rk

    D = rk.partial_decision_plain(g, X) + g.intercept[None, :]
    votes = svc.votes_from_decision(D, g.vote_i, g.vote_j, g.n_classes)
    return torch.argmax(votes, dim=-1)


def ptxas_instances(logs: dict) -> dict:
    """{(kernel, template arguments): "registers; stack and spills"} from
    the ``-Xptxas -v`` build logs, the arguments written as the wrappers'
    ``instance`` writes them: ``rbf_decision_kernel<64, 12, 15, false>``
    is ``("rbf_decision", "64, 12, 15, false")``."""
    found, entry = {}, None
    token = re.compile(r"Li(\d+)E|Lb(\d)E")
    for name, log in logs.items():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '\S*?_kernelI(\S*?)EEv", line)
            if m:
                args = []
                for num, flag in token.findall(m.group(1)):
                    args.append(num or ("true" if flag == "1" else "false"))
                entry = (name, ", ".join(args))
                found[entry] = ""
            elif entry and ("stack frame" in line or "registers" in line):
                found[entry] = (found[entry] + "; " + line.strip()).strip("; ")
    return found


def phase_build() -> dict:
    """Builds every kernel; returns ``ptxas_instances`` of the build."""
    from traffic_classifier_sdn_tpu_torch.native import engine as native_engine
    from traffic_classifier_sdn_tpu_torch.native import forest as native_forest
    from traffic_classifier_sdn_tpu_torch.native import knn as native_knn
    from traffic_classifier_sdn_tpu_torch.ops import (
        cuda_build,
        forest_kernel,
        knn_kernel,
        rbf_kernel,
    )

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        # g++ beside the nvccs: the ingest engine and the ladder's host rungs
        native = [pool.submit(m.build)
                  for m in (native_engine, native_forest, native_knn)]
        logs = cuda_build.build(
            [forest_kernel.KERNEL, knn_kernel.KERNEL, rbf_kernel.KERNEL]
        )
        libs = [f.result().name for f in native]
    print(f"[build] {len(logs)} kernel(s) and the native flow engine, "
          f"forest and KNN evaluators ({', '.join(libs)}) in "
          f"{time.perf_counter() - t0:.2f} s")
    instances = ptxas_instances(logs)
    for (name, args), report in instances.items():
        print(f"[build] {name}_kernel<{args}>: {report}")
    return instances


def _forest_equal(k, X, what: str) -> float:
    """Holds the forest kernel to its plain version on X, bitwise and in
    labels; returns the max |difference| (0)."""
    import torch

    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk

    got = fk.forest_proba(k, X)
    want = fk.forest_proba_plain(k, X)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(
            f"forest kernel != plain version on {what}: max |diff| {err}"
        )
    if not torch.equal(got.argmax(-1), want.argmax(-1)):
        raise AssertionError(f"forest kernel labels differ on {what}")
    return err


def _check_forest(k, X, N: int) -> dict:
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk

    err = _forest_equal(k, X, f"N={N}")
    if N == CAPACITY:
        Xn = with_nonfinite(X)
        err = max(err, _forest_equal(k, Xn, f"N={N} with NaN/inf features"))
        print(f"[kernels] forest_proba N={N}: bitwise equal on a copy with "
              f"NaN/+inf/-inf in {-(-N // 7)} rows (one or two features)")
    visits = node_visits(k, X)
    bound_ms, bound_by = forest_bound(k, X, visits)
    ms = cuda_median_ms(lambda: fk.forest_proba(k, X), TIMED_RUNS)
    b2b_ms = cuda_back_to_back_ms(lambda: fk.forest_proba(k, X))
    plain_ms = cuda_median_ms(lambda: fk.forest_proba_plain(k, X), TIMED_RUNS)
    R, per_chunk = fk.launch_shape(N, k)
    inst = fk.instance(R)
    print(f"[kernels] forest_proba N={N}: bitwise equal, kernel "
          f"{ms:.4f} ms (back to back {b2b_ms:.4f}), plain {plain_ms:.3f} "
          f"ms, bound {bound_ms:.5f} ms ({bound_by}), "
          f"{visits / (N * k.n_trees):.2f} visits/tree")
    design = "a thread per row" if fk.row_design(R) else "warps on (tree, 32 rows)"
    print(f"[kernels] forest_proba N={N}: launch shape {R} rows per tile "
          f"({design}), {per_chunk} trees per stage "
          f"({len(fk.tree_chunks(k.n_trees, per_chunk))} stage(s)): "
          f"{fk.blocks(N, R)} blocks of {fk.threads(R)} threads, "
          f"{fk.smem_bytes(k, R, per_chunk)} bytes of shared memory; instance "
          f"forest_proba_kernel<{inst}>: "
          f"{INSTANCES.get(('forest_proba', inst), 'not in the build log')}")
    return {
        "rows": N, "max_abs_err": err, "ms": ms, "back_to_back_ms": b2b_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "mean_visits_per_tree": visits / (N * k.n_trees),
        "launch_shape": {"rows_per_tile": R, "trees_per_chunk": per_chunk,
                         "blocks": fk.blocks(N, R)},
    }


def _check_knn(g, X, N: int) -> dict:
    import torch

    from traffic_classifier_sdn_tpu_torch.ops import knn_kernel as kk

    got_v, got_i = kk.topk_sim_idx(g, X)
    want_v, want_i = kk.topk_sim_idx_plain(g, X)
    torch.cuda.synchronize()
    err = float((got_v - want_v).abs().max())
    if not torch.equal(got_i, want_i) or not torch.equal(
        got_v.view(torch.int32), want_v.view(torch.int32)
    ):
        bad = int((got_i != want_i).any(1).sum())
        raise AssertionError(
            f"knn_topk kernel != plain version at N={N}: {bad} rows' indices "
            f"differ, max |value diff| {err}"
        )
    labels = kk.predict(g, X)
    if not torch.equal(labels.long(), knn_plain_predict(g, X)):
        raise AssertionError(f"knn_topk kernel labels differ at N={N}")
    bound_ms, bound_by = knn_bound(g, X)
    ms = cuda_median_ms(lambda: kk.topk_sim_idx(g, X), TIMED_RUNS)
    b2b_ms = cuda_back_to_back_ms(lambda: kk.topk_sim_idx(g, X))
    plain_ms = cuda_median_ms(lambda: kk.topk_sim_idx_plain(g, X),
                              PLAIN_RUNS[N], warmup=1)
    counts = torch.bincount(labels.long(), minlength=g.n_classes).tolist()
    rw = kk.launch_shape(N, g.n_neighbors)
    inst = kk.instance(g)
    print(f"[kernels] knn_topk N={N}: indices and values bitwise equal, "
          f"kernel {ms:.4f} ms (back to back {b2b_ms:.4f}), plain "
          f"{plain_ms:.3f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}; {knn_pair_ops(g)} operations per "
          f"pair); labels per class {counts}")
    print(f"[kernels] knn_topk N={N}: launch shape {rw} row(s) per warp: "
          f"{kk.blocks(N, rw)} blocks of {kk.THREADS} threads, "
          f"{kk.WARPS * rw} rows per block, each warp scanning the whole "
          f"corpus; instance knn_topk_kernel<{inst}>: "
          f"{INSTANCES.get(('knn_topk', inst), 'not in the build log')}")
    lib_ms = None
    if N <= CAPACITY:
        fit_t = g.fit_X.t().contiguous()
        lib_ms = cuda_median_ms(
            lambda: torch.topk(torch.matmul(X, fit_t) - g.half_sq, g.n_neighbors),
            TIMED_RUNS,
        )
        print(f"[kernels] knn_topk N={N}: context only (not the same "
              f"rounding or tie order): torch.matmul + torch.topk {lib_ms:.4f} ms")
    return {"rows": N, "max_abs_err": err, "ms": ms,
            "back_to_back_ms": b2b_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "context_only_ms": lib_ms, "launch_shape": {
                "rows_per_warp": rw, "blocks": kk.blocks(N, rw)},
            "labels_per_class": counts}


def _check_svc(g, X, N: int) -> dict:
    import torch

    from traffic_classifier_sdn_tpu_torch.ops import rbf_kernel as rk

    got = rk.partial_decision(g, X)
    want = rk.partial_decision_plain(g, X)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        bad = int((got != want).any(1).sum())
        raise AssertionError(
            f"rbf_decision kernel != plain version at N={N}: {bad} rows "
            f"differ, max |diff| {err}"
        )
    labels = rk.predict(g, X)
    if not torch.equal(labels.long(), svc_plain_predict(g, X)):
        raise AssertionError(f"rbf_decision kernel labels differ at N={N}")
    D = got + g.intercept[None, :]
    bound_ms, bound_by = svc_bound(g, X)
    ms = cuda_median_ms(lambda: rk.partial_decision(g, X), TIMED_RUNS)
    b2b_ms = cuda_back_to_back_ms(lambda: rk.partial_decision(g, X))
    plain_ms = cuda_median_ms(lambda: rk.partial_decision_plain(g, X),
                              PLAIN_RUNS[N], warmup=1)
    counts = torch.bincount(labels.long(), minlength=g.n_classes).tolist()
    print(f"[kernels] rbf_decision N={N}: decisions bitwise equal, kernel "
          f"{ms:.4f} ms (back to back {b2b_ms:.4f}), plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}; {svc_pair_ops(g)} operations per pair); max |K @ coef| {float(got.abs().max()):.3f}, min |D| "
          f"{float(D.abs().min()):.3e}; labels per class {counts}")
    R = rk.launch_shape(N)
    inst = rk.instance(g, R, has_xlo=False)
    print(f"[kernels] rbf_decision N={N}: launch shape {R} row(s) per "
          f"block: {-(-N // R)} blocks of {rk.threads_per_block(R)} threads, "
          f"support vectors in stages of {rk.STAGE}; instance "
          f"rbf_decision_kernel<{inst}>: "
          f"{INSTANCES.get(('rbf_decision', inst), 'not in the build log')}")
    lib_ms = None
    if N <= CAPACITY:
        lib_ms = cuda_median_ms(
            lambda: torch.exp(-g.gamma * torch.cdist(X, g.sv_hi) ** 2) @ g.coef_t,
            TIMED_RUNS,
        )
        print(f"[kernels] rbf_decision N={N}: context only (hi parts only, "
              f"not the same rounding): torch.cdist + exp + matmul "
              f"{lib_ms:.4f} ms")
    return {"rows": N, "max_abs_err": err, "ms": ms,
            "back_to_back_ms": b2b_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "context_only_ms": lib_ms,
            "launch_shape": {"rows_per_block": R, "blocks": -(-N // R)},
            "labels_per_class": counts}


def phase_kernels(device):
    """Seeded models of the reference checkpoints' shapes, drawn from the
    served features, and each kernel held to its plain version at every
    size of ``SHAPES``. Returns ({family: model dict}, {family: kernel
    operands}, {family: {N: result}})."""
    import torch

    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk
    from traffic_classifier_sdn_tpu_torch.ops import knn_kernel as kk
    from traffic_classifier_sdn_tpu_torch.ops import rbf_kernel as rk

    t0 = time.perf_counter()
    tables = {n: synthetic_table(n, 3, device) for n in (CAPACITY, SHAPES[-1])}
    X_cap = ft.features12(tables[CAPACITY])
    X_big = ft.features12(tables[SHAPES[-1]])
    del tables
    sample = X_cap[torch.randperm(
        CAPACITY, generator=torch.Generator().manual_seed(SEED)
    )[:4096].to(device)].cpu().numpy()
    models = {
        "forest": random_forest(SEED, sample),
        "knn": random_knn(SEED, sample),
        "svc": random_svc(SEED, sample),
        **{f: build(SEED, sample) for f, (_, _, build) in FAMILY_SERVES.items()},
    }
    ops = {
        "forest": fk.compile_forest(models["forest"], n_features=N_FEATURES,
                                    device=device),
        "knn": kk.compile_knn(interop.knn_params_from_numpy(models["knn"],
                                                            device)),
        "svc": rk.compile_svc(interop.svc_params_from_numpy(models["svc"],
                                                            device)),
    }
    k, g_knn, g_svc = ops["forest"], ops["knn"], ops["svc"]
    print(f"[kernels] forest: {k.n_trees} trees, {k.n_internal} node "
          f"records and {k.n_leaves} leaf slots per tree, depth "
          f"{models['forest']['max_depth']}; knn: {g_knn.n_rows} corpus "
          f"rows, k = {g_knn.n_neighbors}; svc: {g_svc.n_sv} support "
          f"vectors, {g_svc.n_pairs} pairs, gamma {g_svc.gamma:.4e}, "
          f"n_support {models['svc']['n_support'].tolist()}; tables built "
          f"in {time.perf_counter() - t0:.2f} s")
    checks = {"forest": _check_forest, "knn": _check_knn, "svc": _check_svc}
    results = {name: {} for name in checks}
    for N in SHAPES:
        X = X_cap[:N] if N <= CAPACITY else X_big
        for name, check in checks.items():
            results[name][N] = check(ops[name], X, N)
        if N <= CAPACITY:
            _check_nonfinite(g_knn, g_svc, X, N)
    return models, ops, results


def _check_nonfinite(g_knn, g_svc, X, N: int) -> None:
    """The KNN and SVC kernels on a copy of X with NaN/+inf/-inf in every
    third row, at the wrapper's launch and every launch shape: bitwise
    equal to their plain versions, every KNN index a corpus row."""
    import torch

    from traffic_classifier_sdn_tpu_torch.ops import knn_kernel as kk
    from traffic_classifier_sdn_tpu_torch.ops import rbf_kernel as rk

    Xn = with_nonfinite(X, every=3)
    want_v, want_i = kk.topk_sim_idx_plain(g_knn, Xn)
    runs = [("wrapper", kk.topk_sim_idx(g_knn, Xn))] + [
        (f"{rw} rows/warp", kk._launch(g_knn, Xn, rw))
        for rw in kk.rows_per_warp_choices(g_knn.n_neighbors)]
    for shape, (v, i) in runs:
        if not torch.equal(i, want_i) or not torch.equal(
                v.view(torch.int32), want_v.view(torch.int32)):
            raise AssertionError(
                f"knn_topk kernel != plain version on NaN/inf rows at N={N}, "
                f"{shape}: {int((i != want_i).any(1).sum())} rows differ")
        if not bool(((i >= 0) & (i < g_knn.n_rows)).all()):
            raise AssertionError(f"knn_topk index out of [0, S) at N={N}")
    want = rk.partial_decision_plain(g_svc, Xn)
    shapes = [("wrapper", rk.partial_decision(g_svc, Xn))] + [
        (f"{R} rows/block", rk._launch(g_svc, Xn, None, R))
        for R in rk.ROWS_PER_BLOCK]
    for shape, got in shapes:
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(
                f"rbf_decision kernel != plain version on NaN/inf rows at "
                f"N={N}, {shape}")
    bad = ~torch.isfinite(Xn).all(1)
    print(f"[kernels] knn_topk and rbf_decision N={N}: bitwise equal to "
          f"their plain versions on a copy with NaN/+inf/-inf in "
          f"{int(bad.sum())} rows, at the wrapper's launch and every launch "
          f"shape ({len(runs) - 1} and {len(shapes) - 1}); every KNN index "
          f"in [0, {g_knn.n_rows}), rows with a NaN decision: "
          f"{int(torch.isnan(want).any(1).sum())}")


# the serial bare-kernel serve (the JAX defaults turn both on)
SERIAL = ("--pipeline", "off", "--degrade", "off")

# family → (CLI subcommand, interop builder of the port's model)
SERVES = {
    "forest": ("Randomforest", "forest_params_from_numpy"),
    "knn": ("knearest", "knn_params_from_numpy"),
    "svc": ("svm", "svc_params_from_numpy"),
}


def _kernels() -> dict:
    """{family: (the wrapper whose ``launches`` counts its kernel, the
    serving predict)}."""
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk
    from traffic_classifier_sdn_tpu_torch.ops import knn_kernel as kk
    from traffic_classifier_sdn_tpu_torch.ops import rbf_kernel as rk

    return {
        "forest": (fk.forest_proba, fk.predict),
        "knn": (kk.topk_sim_idx, kk.predict),
        "svc": (rk.partial_decision, rk.predict),
    }


def _plain_labels(family: str, g, X):
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk

    if family == "forest":
        return fk.forest_proba_plain(g, X).argmax(-1)
    if family == "knn":
        return knn_plain_predict(g, X)
    return svc_plain_predict(g, X)


def _serve(argv: list) -> tuple[str, object, float]:
    """(stdout, summary, wall seconds) of one in-process CLI serve."""
    from traffic_classifier_sdn_tpu_torch import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        summary = cli.main(argv)
    return out.getvalue(), summary, time.perf_counter() - t0


def phase_serve(family: str, model: dict, g, device) -> int:
    """The port CLI's serve of ``family`` at capacity 65,536; returns its
    kernel's launches in that run."""
    import torch

    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.io import checkpoint

    subcommand, builder = SERVES[family]
    counters = {f: wrapper for f, (wrapper, _) in _kernels().items()}
    with tempfile.TemporaryDirectory() as ckpt:
        checkpoint.save_model(
            ckpt, family, getattr(interop, builder)(model, device),
            classes=CLASSES,
        )
        argv = [
            subcommand, "--source", "synthetic",
            "--synthetic-flows", str(CAPACITY), "--capacity", str(CAPACITY),
            "--max-ticks", "6", "--print-every", "2",
            "--native-checkpoint", ckpt, *SERIAL,
        ]
        for c in counters.values():  # count the main path's launches only
            c.launches = 0
        out, summary, wall = _serve(argv)
        launches = {f: c.launches for f, c in counters.items()}
    engine = summary.engine
    tables = parse_tables(out)
    tag = f"[serve {subcommand}]"
    print(f"{tag} {summary.ticks} ticks in {wall:.2f} s; per tick (s): "
          + ", ".join(f"{s:.3f}" for s in summary.tick_seconds)
          + "; of which ingest (parse, native engine, wire scatter): "
          + ", ".join(f"{s:.3f}" for s in summary.ingest_seconds)
          + f"; render ticks {summary.render_ticks}; label plans "
          f"{summary.render_plans}")
    if not engine.native or len(summary.render_plans) != len(tables):
        raise AssertionError(
            "the serve did not run at its defaults (native ingest, "
            "incremental labels)")
    if engine.num_flows() != CAPACITY:
        raise AssertionError(f"{engine.num_flows()} flows tracked, want {CAPACITY}")
    own = launches[family]
    if own != len(summary.render_ticks) or own == 0:
        raise AssertionError(
            f"{own} {family} kernel launches for {len(summary.render_ticks)} "
            "render ticks (want one each)"
        )
    others = {f: n for f, n in launches.items() if f != family and n}
    if others:
        raise AssertionError(f"the {family} serve launched other kernels: {others}")
    if len(tables) != len(summary.render_ticks) or any(
        len(t) != 64 for t in tables
    ):
        raise AssertionError(
            f"rendered tables have {[len(t) for t in tables]} rows, want 64 each"
        )
    plain = _plain_labels(family, g, engine.features()).cpu()
    wrong = [(s, lab) for s, lab in tables[-1] if CLASSES[plain[s]] != lab]
    if wrong:
        raise AssertionError(f"rendered labels differ from the plain version: {wrong[:5]}")
    shown = sorted({lab for _, lab in tables[-1]})
    if family != "forest" and len(shown) < 2:
        raise AssertionError(f"the last table shows one class only: {shown}")
    torch.cuda.synchronize()
    print(f"{tag} {engine.num_flows()} flows tracked, {own} kernel "
          f"launches over {len(tables)} render ticks, tables of "
          f"{[len(t) for t in tables]} rows, last table's labels equal the "
          f"plain version's (classes shown: {', '.join(shown)})")
    print(f"{tag} end of the last table:\n"
          + "\n".join(out.splitlines()[-6:]))
    render_breakdown(engine, family, g, device)
    return own


class _WatchedRead:
    """A dispatched read of the pipelined serve, watched: the kernel
    launches and seconds of its device-stage work (``rows()`` for a printed
    render, ``commit()`` for a coalesced one) go to ``log`` under its
    dispatch index."""

    def __init__(self, read, k: int, counter, log: list, before=None):
        self._read, self._k, self._counter, self._log = read, k, counter, log
        self._before = before
        self.n_flows = read.n_flows

    def _launches(self) -> int:
        return 0 if self._counter is None else self._counter.launches

    def _watch(self, what: str, fn):
        before, t0 = self._launches(), time.perf_counter()
        out = fn()
        self._log.append((what, self._k, self._launches() - before,
                          time.perf_counter() - t0))
        return out

    def commit(self):
        return self._watch("commit", self._read.commit)

    def rows(self):
        if self._before is not None:
            self._before(self._k)
        return self._watch("rows", self._read.rows)


@contextlib.contextmanager
def watched_dispatch(family: str, before=None):
    """While active, every render the pipelined serve dispatches records
    the feature matrix of the table it was dispatched against
    (``features``, by dispatch index: ``engine.features()`` is a fresh
    tensor, so later ticks do not change it) and its device-stage work
    (``log``, see ``_WatchedRead``; a family without a kernel logs no
    launches). ``before(k)``, if given, runs on the device stage just
    before render ``k``'s rows are taken."""
    from traffic_classifier_sdn_tpu_torch.serving import pipeline

    counter = _kernels().get(family, (None,))[0]
    features, log = [], []
    dispatch = pipeline.dispatch_read

    def watched(engine, *args, **kw):
        features.append(engine.features())
        read = dispatch(engine, *args, **kw)
        return _WatchedRead(read, len(features) - 1, counter, log, before)

    pipeline.dispatch_read = watched
    try:
        yield features, log
    finally:
        pipeline.dispatch_read = dispatch


def _check_dispatched(tag: str, tables: list, features: list, log: list,
                      plain, allowed=None, names=CLASSES,
                      rows: int | None = None) -> tuple[list[int], int]:
    """Every printed table's labels equal ``plain(X)`` on the features its
    render was dispatched against (and each table has ``rows`` rows, if
    given); a row where they differ must be in ``allowed(X, rows)`` (a
    bool mask) if that is given. Returns (the printed dispatches, the rows
    allowed to differ that did)."""
    printed = [k for what, k, *_ in log if what == "rows"]
    if len(printed) != len(tables):
        raise AssertionError(f"{tag} {len(tables)} tables printed, "
                             f"{len(printed)} renders ran")
    met = 0
    for table, k in zip(tables, printed):
        want = np.asarray(plain(features[k]))
        wrong = np.asarray([s for s, lab in table if names[want[s]] != lab],
                           np.int64)
        ok = (np.zeros(wrong.size, bool) if allowed is None or not wrong.size
              else allowed(features[k], wrong))
        if not ok.all() or (rows is not None and len(table) != rows):
            raise AssertionError(
                f"{tag} render {k + 1}: {len(table)} rows, labels differing "
                f"from the plain version's: {wrong[~ok][:5].tolist()}")
        met += int(wrong.size)
    return printed, met


def _check_printed(tag: str, tables: list, family: str, g, features: list,
                   log: list, rows: int | None = 64) -> list[int]:
    """Every printed table's labels equal the plain version's on the table
    its render was dispatched against; returns the printed dispatches."""
    return _check_dispatched(
        tag, tables, features, log,
        lambda X: _plain_labels(family, g, X).cpu(), rows=rows)[0]


def _per_render_launches(tag: str, summary, log: list) -> list[int]:
    """Kernel launches of each dispatched render (from the watched log),
    held to one for each render with a dirty row and none otherwise."""
    want = [int(kind != "none") for kind, _ in summary.render_plans]
    per_render = [0] * len(want)
    for _, k, n, _ in log:
        per_render[k] += n
    if per_render != want:
        raise AssertionError(f"{tag} launches per render {per_render}, want "
                             f"{want} (plans {summary.render_plans})")
    return per_render


def phase_default_serve(family: str, model: dict, g, device) -> int:
    """The port CLI's serve of ``family`` at capacity 65,536 with no flag:
    pipelined, the degrade ladder, host-mode incremental labels. Returns
    its kernel's launches."""
    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.io import checkpoint

    subcommand, carry = SERVES[family]
    counters = {f: wrapper for f, (wrapper, _) in _kernels().items()}
    tag = f"[default {subcommand}]"
    with tempfile.TemporaryDirectory() as ckpt:
        checkpoint.save_model(
            ckpt, family, getattr(interop, carry)(model, device),
            classes=CLASSES,
        )
        argv = [
            subcommand, "--source", "synthetic",
            "--synthetic-flows", str(CAPACITY), "--capacity", str(CAPACITY),
            "--max-ticks", "6", "--print-every", "2",
            "--native-checkpoint", ckpt,
        ]
        with watched_dispatch(family) as (features, log):
            for c in counters.values():  # count the main path's launches only
                c.launches = 0
            out, summary, wall = _serve(argv)
            launches = {f: c.launches for f, c in counters.items()}
    engine, st, pipe = summary.engine, summary.degrade, summary.pipeline
    tables = parse_tables(out)
    print(f"{tag} {summary.ticks} ticks in {wall:.2f} s; per tick on the "
          "host stage (s): "
          + ", ".join(f"{x:.3f}" for x in summary.tick_seconds)
          + "; of which ingest: "
          + ", ".join(f"{x:.3f}" for x in summary.ingest_seconds)
          + f"; render ticks {summary.render_ticks}; label plans "
          f"{summary.render_plans}")
    print(f"{tag} device stage per render (kind, dispatch, launches, s): "
          + ", ".join(f"({w}, {k + 1}, {n}, {x:.4f})" for w, k, n, x in log)
          + f"; ticks_coalesced {summary.ticks_coalesced}; host stage busy "
          f"{pipe['host_busy_s']:.3f} s, device stage busy "
          f"{pipe['device_busy_s']:.3f} s, overlap {pipe['overlap_s']:.3f} s")
    print(f"{tag} ladder {st}")
    if not engine.native or not summary.render_plans:
        raise AssertionError(f"{tag} not at the defaults (native ingest, "
                             "incremental labels)")
    if (st["state"] != "HEALTHY" or st["fallback_calls"]
            or st["degrade_transitions"] or st["fallback"] is None):
        raise AssertionError(f"{tag} the unarmed ladder left HEALTHY or "
                             f"called its fallback: {st}")
    if engine.num_flows() != CAPACITY:
        raise AssertionError(f"{tag} {engine.num_flows()} flows tracked")
    per_render = _per_render_launches(tag, summary, log)
    others = {f: n for f, n in launches.items() if f != family and n}
    if launches[family] != sum(per_render) or others:
        raise AssertionError(f"{tag} all launches {launches}, per render "
                             f"{per_render}")
    printed = _check_printed(tag, tables, family, g, features, log)
    if len(tables) + summary.ticks_coalesced != len(summary.render_ticks):
        raise AssertionError(f"{tag} {len(tables)} tables + "
                             f"{summary.ticks_coalesced} coalesced != "
                             f"{len(summary.render_ticks)} renders")
    print(f"{tag} {len(tables)} tables printed (renders {[k + 1 for k in printed]}), "
          "each one's labels equal the plain version's on the table it was "
          f"dispatched against; {launches[family]} kernel launches, one per "
          "render; the ladder stayed HEALTHY with no fallback call")
    return launches[family]


# Flows of each family's drill serve: the serve's own size where the host
# rung keeps a demoted render under the stall drill's 2 s bound (the native
# forest and KNN), 4,096 for SVC, whose host rung (the plain version on the
# CPU) takes about 1 s a render at 4,096 rows. One demoted SVC render at
# 65,536 rows is timed on its own (``demoted_render_at_size``).
DRILL_FLOWS = {"forest": CAPACITY, "knn": CAPACITY, "svc": 4096}


def phase_drills(family: str, model: dict, g, device) -> dict:
    """The ladder drills of ``family`` on the card: an armed dispatch error
    (demote, host-rung labels equal to the plain version's, re-promote
    after two clean probes; probes before them may fail only on parity),
    then an armed dispatch stall with a 1 s
    deadline (every render within 2 s), then an unarmed fault of the
    kernel's wrapper, which must end the serve instead of demoting.
    Returns the kernel's launches."""
    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.io import checkpoint
    from traffic_classifier_sdn_tpu_torch.utils import faults

    subcommand, carry = SERVES[family]
    counter = _kernels()[family][0]
    deadline = 1.0
    total = 0
    flows = DRILL_FLOWS[family]
    with tempfile.TemporaryDirectory() as ckpt:
        checkpoint.save_model(
            ckpt, family, getattr(interop, carry)(model, device),
            classes=CLASSES,
        )
        argv = [
            subcommand, "--source", "synthetic",
            "--synthetic-flows", str(flows),
            "--capacity", str(flows), "--max-ticks", "10",
            "--print-every", "1", "--probe-every", "0",
            "--probe-successes", "2", "--native-checkpoint", ckpt,
        ]
        for site, extra in (("degrade.dispatch_error", []),
                            ("degrade.dispatch_stall",
                             ["--device-deadline", str(deadline)])):
            tag = f"[drill {subcommand} {site} {flows} flows]"
            plan = faults.FaultPlan([faults.FaultRule(site, after=1)])
            counter.launches = 0
            with watched_dispatch(family) as (features, log), \
                    faults.installed(plan):
                out, summary, wall = _serve(argv + extra)
            total += counter.launches
            st = summary.degrade
            edges = summary.degrade_transitions
            print(f"{tag} fired at device calls {[h for _, h in plan.fires]}"
                  f"; transitions {edges}; final {st['state']}, "
                  f"{st['fallback_calls']} fallback calls "
                  f"({st['fallback']}), {st['device_calls']} device calls; "
                  "device stage per render (s): "
                  + ", ".join(f"{x:.4f}" for w, _, _, x in log if w == "rows"))
            reason = "deadline" if site.endswith("stall") else \
                "error:FaultInjected"
            # between the demotion and the promotion, probes may fail only
            # on parity: the host rung and the kernel order near-ties
            # differently (``near_ties``; ROADMAP Queue 3)
            retry = [("DEGRADED", "PROBING", "probe-due"),
                     ("PROBING", "DEGRADED", "probe-failed:parity-mismatch")]
            middle = edges[1:-2]
            if (edges[:1] != [("HEALTHY", "DEGRADED", reason)]
                    or edges[-2:] != [("DEGRADED", "PROBING", "probe-due"),
                                      ("PROBING", "HEALTHY", "promoted")]
                    or middle != retry * (len(middle) // 2)
                    or st["state"] != "HEALTHY"):
                raise AssertionError(f"{tag} transitions {edges}")
            if st["fallback_calls"] < 1 or len(plan.fires) != 1:
                raise AssertionError(f"{tag} {st}")
            _check_printed(tag, parse_tables(out), family, g, features, log,
                           rows=None)
            slow = [x for w, _, _, x in log if w == "rows" and x > 2 * deadline]
            if site.endswith("stall") and slow:
                raise AssertionError(f"{tag} renders took {slow} s, over twice "
                                     f"the {deadline} s deadline")
            print(f"{tag} demoted, served the host rung's labels (equal to "
                  "the plain version's on every printed table), and "
                  f"re-promoted after 2 clean probes in {wall:.2f} s; "
                  f"{len(middle) // 2} probes failed on parity")
        total += _drill_kernel_fault(family, argv + ["--max-ticks", "4"])
    demoted_render_at_size(family, model, g, device)
    return total


def _drill_kernel_fault(family: str, argv: list) -> int:
    """The no-flag serve with the kernel's wrapper raising from its second
    call on (an unarmed fault: no fault site): the serve must end with
    that error, the ladder must not demote. Returns the launches made."""
    import importlib

    subcommand = SERVES[family][0]
    tag = f"[drill {subcommand} kernel fault]"
    wrapper = _kernels()[family][0]
    mod = importlib.import_module(wrapper.__module__)
    calls = {"n": 0}

    def failing(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError("simulated kernel launch failure")
        return wrapper(*a, **kw)

    # the wrapper counts its launches on the module's name, now ``failing``
    failing.launches = 0
    err = io.StringIO()
    setattr(mod, wrapper.__name__, failing)
    try:
        with contextlib.redirect_stderr(err):
            _serve(argv)
    except RuntimeError as e:
        if "simulated kernel launch failure" not in str(e):
            raise
    else:
        raise AssertionError(f"{tag} the serve absorbed a kernel fault")
    finally:
        setattr(mod, wrapper.__name__, wrapper)
    if "DEGRADE:" in err.getvalue() or calls["n"] < 2:
        raise AssertionError(f"{tag} {calls['n']} wrapper calls; stderr: "
                             f"{err.getvalue()[-2000:]}")
    print(f"{tag} the serve ended with the wrapper's error at its call "
          f"{calls['n']}; the ladder did not demote")
    return failing.launches


def near_ties(family: str, model: dict, g, X, fb, rows: np.ndarray) -> np.ndarray:
    """Which of ``rows`` (where the host rung's labels differ from the
    plain version's) are near-ties that the two arithmetics may order
    differently:

    - forest: the host rung sums the trees' class distributions in
      float64, the kernel and its plain version in float32; a row is a
      near-tie when its top two float64 probabilities lie within
      ``T · 2⁻²³ · p_max`` (T trees, one float32 rounding per tree's
      addition on either side);
    - KNN: the host rung ranks float64 squared distances, the kernel the
      float32 similarity ``x·s − ½‖s‖²``; a near-tie when the k-th and
      (k+1)-th nearest distances lie within ``1e-6 · (‖x‖² + max ‖s‖²)``,
      the rounding of a 12-term float32 dot product at that scale;
    - SVC: the smallest |decision| within 1e-5 of the largest coefficient
      sum (the CPU and the card round ``exp`` differently; the parity
      tests' tolerance);
    - logreg, gnb, kmeans (``fb`` unused): each score is a float32 sum of
      12 terms, which the card and the CPU (or two libraries) add in their
      own orders, each within ``12 · 2⁻²⁴ · scale`` of the exact sum
      (``scale``: the sum of the terms' absolute values, ``family_scores``);
      a near-tie when the top two float64 scores lie within
      ``2 · 12 · 2⁻²⁴`` times the larger scale of the row."""
    from traffic_classifier_sdn_tpu_torch.ops import rbf_kernel as rk

    Xr = X[rows.tolist()]
    if family in FAMILY_SERVES:
        S, scale = family_scores(family, model, Xr.cpu().numpy())
        top = np.argsort(S, axis=1)[:, -2:]
        gap = np.take_along_axis(S, top[:, 1:], 1) - np.take_along_axis(
            S, top[:, :1], 1)
        return gap[:, 0] <= 24 * 2.0 ** -24 * scale.max(1)
    if family == "forest":
        p = np.sort(fb.scores(Xr.cpu().numpy()), axis=1)
        tol = len(model["values"]) * 2.0 ** -23 * p[:, -1]
        return p[:, -1] - p[:, -2] <= tol
    if family == "knn":
        fit = model["fit_X"].astype(np.float64)
        k = int(model["n_neighbors"])
        near = []
        for x in Xr.cpu().numpy().astype(np.float64):
            d = np.sort(((fit - x) ** 2).sum(1))
            near.append(d[k] - d[k - 1]
                        <= 1e-6 * (x @ x + (fit ** 2).sum(1).max()))
        return np.asarray(near, bool)
    D = rk.partial_decision_plain(g, Xr) + g.intercept[None, :]
    tol = 1e-5 * float(g.coef_t.abs().sum(0).max())
    return D.abs().min(1).values.cpu().numpy() <= tol


def family_scores(family: str, model: dict, X) -> tuple:
    """(scores, scale), (N, C) float64 each, of a logreg/gnb/kmeans
    importer dict on host rows X: the exact scores of the float32 model
    and the sum of the absolute values of each score's terms (non-finite
    rows give NaN or ±inf quietly)."""
    X = np.asarray(X, np.float32).astype(np.float64)
    with np.errstate(invalid="ignore", over="ignore"):
        return _family_scores(family, model, X)


def _family_scores(family: str, model: dict, X: np.ndarray) -> tuple:
    from traffic_classifier_sdn_tpu_torch.models import gnb

    if family == "logreg":
        coef = np.float32(model["coef"]).astype(np.float64)
        b = np.float32(model["intercept"]).astype(np.float64)
        return X @ coef.T + b, np.abs(X) @ np.abs(coef).T + np.abs(b)
    if family == "gnb":
        f = {k: np.float32(v).astype(np.float64)
             for k, v in gnb.fold(model).items()}
        q = ((X[:, None, :] - f["theta"][None]) ** 2
             * f["inv_var"][None]).sum(-1)
        const = f["log_const"][None, :]
        return const - 0.5 * q, np.where(np.isfinite(const),
                                         np.abs(const), 0.0) + 0.5 * q
    c = np.float32(model["cluster_centers"]).astype(np.float64)
    q = ((X[:, None, :] - c[None]) ** 2).sum(-1)
    return -q, q


def demoted_render_at_size(family: str, model: dict, g, device) -> float:
    """One call of ``family``'s host rung (``models.resolve_fallback``, what
    a demoted render runs) on the 65,536 rows of a synthetic table, timed,
    its labels held to the plain version's on the card: equal on every
    row but near-ties (``near_ties``). Returns the seconds."""
    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
    from traffic_classifier_sdn_tpu_torch.models import resolve_fallback

    subcommand, carry = SERVES[family]
    tag = f"[demoted {subcommand} {CAPACITY} rows]"
    fb = resolve_fallback(family, getattr(interop, carry)(model, device))
    X = ft.features12(synthetic_table(CAPACITY, 3, device))
    X_host = X.cpu().numpy()
    t0 = time.perf_counter()
    got = fb.predict(X_host)
    seconds = time.perf_counter() - t0
    want = _plain_labels(family, g, X).cpu().numpy()
    differ = np.flatnonzero(got != want)
    near = near_ties(family, model, g, X, fb, differ)
    if not near.all() or got.shape != want.shape:
        raise AssertionError(f"{tag} {fb.kind} labels differ from the plain "
                             f"version's on rows {differ[~near][:8].tolist()}"
                             ", which are not near-ties")
    print(f"{tag} the host rung ({fb.kind}) took {seconds:.4f} s for one "
          f"render's labels; they differ from the plain version's on "
          f"{differ.size} rows, each a near-tie")
    return seconds


def phase_warmup(model: dict, k, device) -> int:
    """The no-flag forest serve of 65,536 flows with and without
    ``--warmup``: what warmup does and costs, and each render's time on
    the device stage. Returns the forest kernel's launches."""
    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.io import checkpoint
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk

    tag = "[warmup Randomforest]"
    total = 0
    with tempfile.TemporaryDirectory() as ckpt:
        checkpoint.save_model(ckpt, "forest",
                              interop.forest_params_from_numpy(model, device),
                              classes=CLASSES)
        argv = ["Randomforest", "--source", "synthetic", "--synthetic-flows",
                str(CAPACITY), "--capacity", str(CAPACITY), "--max-ticks",
                "4", "--print-every", "1", "--native-checkpoint", ckpt]
        for warm in (False, True):
            fk.forest_proba.launches = 0
            with watched_dispatch("forest") as (features, log):
                out, summary, wall = _serve(argv + ["--warmup"] * warm)
            total += fk.forest_proba.launches
            _check_printed(tag, parse_tables(out), "forest", k, features, log)
            renders = [x for w, _, _, x in log if w == "rows"]
            what = "with --warmup" if warm else "without --warmup"
            st = summary.degrade
            if st["state"] != "HEALTHY" or st["fallback_calls"]:
                raise AssertionError(f"{tag} {what}: the unarmed ladder left "
                                     f"HEALTHY or called its fallback: {st}")
            if warm:
                w = summary.warmup
                print(f"{tag} warmup warmed {len(w['warmed'])} steps in "
                      f"{w['seconds']:.3f} s: {', '.join(w['warmed'])}")
                if not w["warmed"] or summary.degrade["device_calls"] <= len(
                        renders):
                    raise AssertionError(f"{tag} warmup {w}")
            print(f"{tag} {what}: host ticks (s) "
                  + ", ".join(f"{x:.4f}" for x in summary.tick_seconds)
                  + "; renders on the device stage (s) "
                  + ", ".join(f"{x:.4f}" for x in renders)
                  + f"; first render / median of the later ones "
                  f"{renders[0] / statistics.median(renders[1:]):.2f}")
    return total


BIG_FLOWS = 1 << 20
BIG_EMITTER = """\
import sys, time
sys.path.insert(0, sys.argv[1])
from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows
syn = SyntheticFlows(n_flows=int(sys.argv[2]))
out = sys.stdout.buffer
out.write(b"loading app simple_monitor_13.py\\n")
out.flush()
for _ in range(int(sys.argv[3])):
    blob = syn.tick_bytes()
    out.write(blob)
    out.flush()
    time.sleep(float(sys.argv[4]))
"""


def phase_big_serve(model: dict, k, device) -> int:
    """The no-flag forest serve of 2^20 flows, fed as raw pipe bytes through
    ``--source ryu`` by an emitter that generates four ticks in memory.
    Returns the forest kernel's launches."""
    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.io import checkpoint
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk

    tag = "[2^20 Randomforest]"
    ticks, pause = 4, 1.0
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, emitter = os.path.join(tmp, "ckpt"), os.path.join(tmp, "emit.py")
        checkpoint.save_model(ckpt, "forest",
                              interop.forest_params_from_numpy(model, device),
                              classes=CLASSES)
        with open(emitter, "w") as f:
            f.write(BIG_EMITTER)
        fk.forest_proba.launches = 0
        with watched_dispatch("forest") as (features, log):
            out, summary, wall = _serve([
                "Randomforest", "--source", "ryu", "--monitor-cmd",
                f"{sys.executable} {emitter} {root} {BIG_FLOWS} {ticks} "
                f"{pause}",
                "--capacity", str(BIG_FLOWS), "--print-every", "1",
                "--native-checkpoint", ckpt,
            ])
        launches = fk.forest_proba.launches
    engine, st, pipe = summary.engine, summary.degrade, summary.pipeline
    print(f"{tag} {summary.ticks} polls in {wall:.2f} s (emitter: {ticks} "
          f"ticks of {2 * BIG_FLOWS} lines, {pause} s apart); per poll on "
          "the host stage (s): "
          + ", ".join(f"{x:.3f}" for x in summary.tick_seconds)
          + "; of which ingest (raw bytes, native engine, wire scatter): "
          + ", ".join(f"{x:.3f}" for x in summary.ingest_seconds))
    print(f"{tag} label plans {summary.render_plans}; device stage per "
          "render (kind, dispatch, launches, s): "
          + ", ".join(f"({w}, {i + 1}, {n}, {x:.4f})" for w, i, n, x in log)
          + f"; ticks_coalesced {summary.ticks_coalesced}; host stage busy "
          f"{pipe['host_busy_s']:.3f} s, device stage busy "
          f"{pipe['device_busy_s']:.3f} s; ladder {st['state']}, "
          f"{st['fallback_calls']} fallback calls")
    if engine.num_flows() != BIG_FLOWS or engine.batcher.parsed != (
            ticks * 2 * BIG_FLOWS):
        raise AssertionError(f"{tag} {engine.num_flows()} flows, "
                             f"{engine.batcher.parsed} lines parsed")
    if st["state"] != "HEALTHY" or st["fallback_calls"]:
        raise AssertionError(f"{tag} the unarmed ladder left HEALTHY: {st}")
    tables = parse_tables(out)
    printed = _check_printed(tag, tables[-1:], "forest", k, features,
                             [e for e in log if e[0] == "rows"][-1:])
    print(f"{tag} {engine.num_flows()} flows tracked from "
          f"{engine.batcher.parsed} lines, {launches} forest launches, "
          f"{len(tables)} tables; the last (render {printed[0] + 1}) equals "
          "the plain version's labels")
    return launches


FANIN_SOURCES = 3
FANIN_TICKS = 8
FANIN_KILL_AFTER = 2  # ticks before source 1 is killed
# seconds from its death to its namespace's eviction: none, so the eviction
# lands in the tick that sees the death (or the first one after it with no
# render in flight) however fast the ticks run
FANIN_QUARANTINE = 0.0


@contextlib.contextmanager
def kill_after(tick: int, sid: int):
    """While active, every fan-in tier kills source ``sid`` (an unclean
    death: ``FanInIngest.kill_source``) once the serve has consumed
    ``tick`` of its ticks."""
    from traffic_classifier_sdn_tpu_torch.ingest import fanin

    ticks = fanin.FanInIngest.ticks

    def killing(self, *a, **kw):
        for i, batch in enumerate(ticks(self, *a, **kw)):
            yield batch
            if i + 1 == tick:
                self.kill_source(sid)

    fanin.FanInIngest.ticks = killing
    try:
        yield
    finally:
        fanin.FanInIngest.ticks = ticks


def phase_fanin(model: dict, k, device) -> int:
    """The no-flag forest serve through the fan-in tier: ``--sources 3
    --source synthetic --synthetic-flows 65536 --source-lockstep`` (21,845
    flows per namespace, raw bytes into the C++ engine under each source's
    id), source 1 killed after tick 2 with no quarantine. Exactly
    source 1's namespace is evicted, sources 0 and 2 render on, every
    printed table's labels equal the plain version's on the features its
    render was dispatched against, the roster ends HEALTHY, DEAD, HEALTHY
    and the ladder stays HEALTHY; no source's poll is dropped (the queue
    holds a poll of every flow). Returns the forest kernel's launches."""
    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.io import checkpoint
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk

    per = CAPACITY // FANIN_SOURCES
    tag = f"[fanin Randomforest {FANIN_SOURCES} x {per} flows]"
    counters = {f: wrapper for f, (wrapper, _) in _kernels().items()}
    with tempfile.TemporaryDirectory() as ckpt:
        checkpoint.save_model(ckpt, "forest",
                              interop.forest_params_from_numpy(model, device),
                              classes=CLASSES)
        argv = ["Randomforest", "--source", "synthetic", "--synthetic-flows",
                str(CAPACITY), "--sources", str(FANIN_SOURCES),
                "--source-lockstep", "--source-quarantine",
                str(FANIN_QUARANTINE), "--capacity", str(CAPACITY),
                "--max-ticks", str(FANIN_TICKS), "--print-every", "2",
                "--native-checkpoint", ckpt]
        with watched_dispatch("forest") as (features, log), \
                kill_after(FANIN_KILL_AFTER, 1):
            for c in counters.values():  # count this path's launches only
                c.launches = 0
            out, summary, wall = _serve(argv)
            launches = {f: c.launches for f, c in counters.items()}
    engine, st = summary.engine, summary.degrade
    tables = parse_tables(out)
    print(f"{tag} {summary.ticks} ticks in {wall:.2f} s; per tick on the "
          "host stage (s): "
          + ", ".join(f"{x:.3f}" for x in summary.tick_seconds)
          + "; of which ingest (3 raw batches, native engine, wire "
          "scatter): " + ", ".join(f"{x:.3f}" for x in summary.ingest_seconds)
          + f"; render ticks {summary.render_ticks}; label plans "
          f"{summary.render_plans}")
    print(f"{tag} evictions (tick, source, flows, s): "
          + ", ".join(f"({t}, {sid}, {n}, {x:.4f})"
                      for t, sid, n, x in summary.source_evictions)
          + "; roster " + "; ".join(
              f"{r['id']}: {r['state']} clean={r['clean']} ticks={r['ticks']}"
              f" records={r['records']} drops={r['drops']}"
              for r in summary.roster))
    if not engine.native:
        raise AssertionError(f"{tag} not on the native engine")
    evictions = [(sid, n) for _, sid, n, _ in summary.source_evictions]
    if evictions != [(1, per)]:
        raise AssertionError(f"{tag} evictions {evictions}, want [(1, {per})]")
    slots = {sid: int(engine.slots_for_source(sid).size)
             for sid in range(FANIN_SOURCES)}
    if slots != {0: per, 1: 0, 2: per} or engine.num_flows() != 2 * per:
        raise AssertionError(f"{tag} slots per namespace {slots}, "
                             f"{engine.num_flows()} flows")
    rows = {r["id"]: r for r in summary.roster}
    states = {sid: r["state"] for sid, r in rows.items()}
    ticks = {sid: r["ticks"] for sid, r in rows.items()}
    drops = {sid: r["drops"] for sid, r in rows.items()}
    if (states != {0: "HEALTHY", 1: "DEAD", 2: "HEALTHY"}
            or ticks != {0: summary.ticks, 1: FANIN_KILL_AFTER,
                         2: summary.ticks} or any(drops.values())):
        raise AssertionError(f"{tag} roster states {states}, ticks {ticks}, "
                             f"records dropped {drops}")
    if (st["state"] != "HEALTHY" or st["fallback_calls"]
            or st["degrade_transitions"]):
        raise AssertionError(f"{tag} the unarmed ladder left HEALTHY: {st}")
    evicted_at = summary.source_evictions[0][0]
    # a render dispatched in the eviction's own tick follows the eviction
    if not any(t >= evicted_at for t in summary.render_ticks):
        raise AssertionError(f"{tag} no render after the eviction at tick "
                             f"{evicted_at}")
    per_render = _per_render_launches(tag, summary, log)
    others = {f: n for f, n in launches.items() if f != "forest" and n}
    if launches["forest"] != sum(per_render) or others:
        raise AssertionError(f"{tag} all launches {launches}, per render "
                             f"{per_render}")
    printed = _check_printed(tag, tables, "forest", k, features, log)
    print(f"{tag} source 1's namespace ({per} flows) evicted at tick "
          f"{evicted_at}; sources 0 and 2 kept their {per} slots each and "
          f"rendered on ({len(tables)} tables, renders "
          f"{[i + 1 for i in printed]}, each one's labels equal the plain "
          "version's on the table it was dispatched against); "
          f"{launches['forest']} forest kernel launches; the ladder stayed "
          "HEALTHY")
    return launches["forest"]


# family → (CLI subcommand, interop builder, seeded importer-dict builder)
# ticks of the side serves (families, menus): 4, cut from 6 when the obs
# and checkpoint phases came (each 65,536-flow synthetic tick costs ~1.5 s
# of host time, most of it the source's record generation)
SIDE_TICKS = 4

FAMILY_SERVES = {
    "logreg": ("logistic", "logreg_params_from_numpy", random_logreg),
    "gnb": ("gaussiannb", "gnb_params_from_numpy", random_gnb),
    "kmeans": ("kmeans", "kmeans_params_from_numpy", random_kmeans),
}


def family_classes(family: str) -> tuple:
    """Label names a family's checkpoint stores: the six classes, or the
    reference k-means checkpoint's cluster map."""
    from traffic_classifier_sdn_tpu_torch.models import kmeans

    return kmeans.CLUSTER_LABELS_CHECKPOINT if family == "kmeans" else CLASSES


def _check_family_printed(tag: str, tables: list, family: str, model: dict,
                          cpu_model, features: list, log: list,
                          rows: int | None = 64) -> int:
    """Every printed table's labels equal the module's labels on the CPU
    for the features its render was dispatched against, except on
    near-ties (``near_ties``). Returns the near-tie rows met."""
    return _check_dispatched(
        tag, tables, features, log,
        lambda X: cpu_model.predict(X.cpu()).numpy(),
        allowed=lambda X, wrong: near_ties(family, model, None, X.cpu(),
                                           None, wrong),
        names=family_classes(family), rows=rows)[1]


def phase_families(models: dict, device) -> dict:
    """The no-flag serves of ``logistic``, ``gaussiannb`` and ``kmeans`` at
    65,536 synthetic flows (plain torch predicts on the card: the JAX
    package computes these families in XLA, so none has a kernel), each
    printed table's labels held to the module's labels on the CPU; each
    family's predict on the 65,536 served rows timed (CUDA-event median)
    and held to the CPU's labels but on near-ties; then one
    ``degrade.dispatch_error`` drill of ``gaussiannb``. Returns {family:
    predict ms}."""
    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.io import checkpoint

    counters = {f: wrapper for f, (wrapper, _) in _kernels().items()}
    times = {}
    for family, (subcommand, carry, _) in FAMILY_SERVES.items():
        model = models[family]
        tag = f"[families {subcommand}]"
        g = getattr(interop, carry)(model, device)
        cpu_model = getattr(interop, carry)(model, "cpu")
        with tempfile.TemporaryDirectory() as ckpt:
            checkpoint.save_model(ckpt, family, g,
                                  classes=family_classes(family))
            argv = [subcommand, "--source", "synthetic", "--synthetic-flows",
                    str(CAPACITY), "--capacity", str(CAPACITY),
                    "--max-ticks", str(SIDE_TICKS), "--print-every", "2",
                    "--native-checkpoint", ckpt]
            with watched_dispatch(family) as (features, log):
                for c in counters.values():
                    c.launches = 0
                out, summary, wall = _serve(argv)
                launches = {f: c.launches for f, c in counters.items()}
            engine, st = summary.engine, summary.degrade
            tables = parse_tables(out)
            print(f"{tag} {summary.ticks} ticks in {wall:.2f} s; per tick on "
                  "the host stage (s): "
                  + ", ".join(f"{x:.3f}" for x in summary.tick_seconds)
                  + "; renders on the device stage (s): "
                  + ", ".join(f"{x:.4f}" for w, _, _, x in log if w == "rows")
                  + f"; label plans {summary.render_plans}; ladder {st}")
            if (not engine.native or not summary.render_plans
                    or engine.num_flows() != CAPACITY):
                raise AssertionError(f"{tag} not at the defaults or "
                                     f"{engine.num_flows()} flows tracked")
            if (st["state"] != "HEALTHY" or st["fallback_calls"]
                    or st["fallback"] != "plain-cpu"):
                raise AssertionError(f"{tag} ladder {st}")
            if any(launches.values()):
                raise AssertionError(f"{tag} launched kernels: {launches}")
            ties = _check_family_printed(tag, tables, family, model,
                                         cpu_model, features, log)
            shown = sorted({lab for t in tables for _, lab in t})
            X = engine.features()
            # the table's most active rows may all fall in one class; the
            # whole table must not
            counts = np.bincount(g.predict(X).cpu().numpy(),
                                 minlength=len(family_classes(family)))
            if (counts > 0).sum() < 2:
                raise AssertionError(f"{tag} every row has one label: "
                                     f"{counts.tolist()}")
            times[family] = cuda_median_ms(lambda: g.predict(X), TIMED_RUNS)
            got = g.predict(X).cpu().numpy()
            want = cpu_model.predict(X.cpu()).numpy()
            differ = np.flatnonzero(got != want)
            near = near_ties(family, model, None, X, None, differ)
            if not near.all():
                raise AssertionError(f"{tag} card labels differ from the "
                                     "CPU's off near-ties at rows "
                                     f"{differ[~near][:8].tolist()}")
            print(f"{tag} {len(tables)} tables, each one's labels equal the "
                  f"CPU module's on its dispatched features ({ties} near-tie "
                  f"rows); classes shown {shown}, rows per class in the table "
                  f"{counts.tolist()}; predict on {CAPACITY} rows "
                  f"{times[family]:.4f} ms (CUDA-event median of "
                  f"{TIMED_RUNS}), card labels equal the CPU's on all but "
                  f"{differ.size} near-tie rows; no kernel launched")
            if family == "gnb":
                _drill_family(tag, family, model, cpu_model, ckpt)
    return times


def _drill_family(tag: str, family: str, model: dict, cpu_model,
                  ckpt: str) -> None:
    """The no-flag serve of 65,536 flows with ``degrade.dispatch_error``
    armed on the second device call (``--probe-every 0 --probe-successes
    2``, 10 ticks): the ladder demotes to the ``plain-cpu`` rung, every
    printed table's labels equal the CPU module's but on near-ties, and it
    re-promotes (probes before that may fail only on parity)."""
    from traffic_classifier_sdn_tpu_torch.utils import faults

    tag = f"{tag} drill degrade.dispatch_error"
    plan = faults.FaultPlan([faults.FaultRule("degrade.dispatch_error",
                                              after=1)])
    drill = [FAMILY_SERVES[family][0], "--source", "synthetic",
             "--synthetic-flows", str(CAPACITY), "--capacity", str(CAPACITY),
             "--max-ticks", "10", "--print-every", "1", "--probe-every", "0",
             "--probe-successes", "2", "--native-checkpoint", ckpt]
    with watched_dispatch(family) as (features, log), faults.installed(plan):
        out, summary, wall = _serve(drill)
    st, edges = summary.degrade, summary.degrade_transitions
    retry = [("DEGRADED", "PROBING", "probe-due"),
             ("PROBING", "DEGRADED", "probe-failed:parity-mismatch")]
    middle = edges[1:-2]
    if (edges[:1] != [("HEALTHY", "DEGRADED", "error:FaultInjected")]
            or edges[-2:] != [("DEGRADED", "PROBING", "probe-due"),
                              ("PROBING", "HEALTHY", "promoted")]
            or middle != retry * (len(middle) // 2)
            or st["state"] != "HEALTHY" or st["fallback"] != "plain-cpu"
            or st["fallback_calls"] < 1 or len(plan.fires) != 1):
        raise AssertionError(f"{tag} transitions {edges}; {st}")
    _check_family_printed(tag, parse_tables(out), family, model, cpu_model,
                          features, log, rows=None)
    print(f"{tag} transitions {edges}; {st['fallback_calls']} fallback calls "
          f"({st['fallback']}); device stage per render (s): "
          + ", ".join(f"{x:.4f}" for w, _, _, x in log if w == "rows")
          + "; host stage per tick (s): "
          + ", ".join(f"{x:.3f}" for x in summary.tick_seconds)
          + f"; demoted, served the CPU module's labels and re-promoted in "
          f"{wall:.2f} s; {len(middle) // 2} probes failed on parity")


# ---------------------------------------------------------------------------
# the serving menus, the controller and workload sources

MENU_VARS = ("TCSDN_KNN_TOPK", "TCSDN_SVC_KERNEL", "TCSDN_FOREST_KERNEL")
KNN_TIERS = ("sort", "pallas", "argmax", "hier", "hier512", "screened",
             "screened64")
IVF_CHUNK = 16384  # rows per IVF call: the (N, nprobe·L) candidate gather
HOST_RUNS = 3  # host (C++) calls timed per form


@contextlib.contextmanager
def serving_env(**values):
    """Set the serving menus' environment variables (``TCSDN_KNN_TOPK``
    and the others; a CLI's ``--knn-topk`` also sets it) for a block and
    restore all of them after it, so later phases serve the defaults."""
    saved = {v: os.environ.get(v) for v in MENU_VARS}
    for v in MENU_VARS:
        os.environ.pop(v, None)
    os.environ.update(values)
    try:
        yield
    finally:
        for v, old in saved.items():
            if old is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = old


def host_median_s(fn, runs: int = HOST_RUNS) -> float:
    """Median host seconds of ``runs`` calls of a host (C++) function."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def served_rows(device):
    """(65,536, 12) features of a synthetic table of 65,536 flows after 3
    ticks: the rows the serves label (all finite)."""
    import torch

    from traffic_classifier_sdn_tpu_torch.core import flow_table as ft

    X = ft.features12(synthetic_table(CAPACITY, 3, device))
    if not bool(torch.isfinite(X).all()):
        raise AssertionError("served rows hold a non-finite feature")
    return X


def phase_knn_tiers(model: dict, g, device) -> dict:
    """The ``--knn-topk`` tiers on 65,536 served rows: each exact tier's
    serving predict (``sort`` and ``pallas``: the kernel; ``argmax``,
    ``hier``, ``hier512``, ``screened``, ``screened64``: the torch tiers)
    with its neighbor indices bitwise equal to the kernel's
    (``knn_kernel.neighbor_idx``), each timed (CUDA-event median) beside
    the kernel; ``native`` (the C++ host search) with labels equal to the
    kernel's but on near-ties, timed on the host; and ``torch.matmul +
    torch.topk`` (context only: another rounding and tie order) warmed.
    Returns {tier: ms}."""
    import torch

    from traffic_classifier_sdn_tpu_torch import interop, models
    from traffic_classifier_sdn_tpu_torch.models import knn
    from traffic_classifier_sdn_tpu_torch.ops import knn_kernel as kk

    tag = "[knn-tiers]"
    X = served_rows(device)
    kp = interop.knn_params_from_numpy(model, device)
    want = kk.neighbor_idx(g, X)
    want_labels = kk.predict(g, X)
    kernel_ms = cuda_median_ms(lambda: kk.predict(g, X), TIMED_RUNS)
    sim = knn.dot_expansion_sim(X, g.fit_X, g.half_sq)
    times = {}
    for tier in KNN_TIERS:
        with serving_env(TCSDN_KNN_TOPK=tier):
            fn, p = models._build_serving_path("knn", kp)
        if tier in ("sort", "pallas"):
            idx = kk.neighbor_idx(p, X)
        else:
            idx = knn.neighbor_idx(sim, g.n_neighbors, tier)
        if not torch.equal(idx, want):
            bad = int((idx != want).any(1).sum())
            raise AssertionError(f"{tag} {tier}: {bad} rows' neighbor "
                                 "indices differ from the kernel's")
        if not torch.equal(fn(p, X).long(), want_labels.long()):
            raise AssertionError(f"{tag} {tier}: labels differ")
        times[tier] = cuda_median_ms(lambda: fn(p, X), 10, warmup=2)
    del sim
    with serving_env(TCSDN_KNN_TOPK="native"):
        fn, _ = models._build_serving_path("knn", kp)
    got = fn(None, X)
    times["native"] = host_median_s(lambda: fn(None, X)) * 1e3
    wl = want_labels.cpu().numpy()
    differ = np.flatnonzero(got != wl)
    near = near_ties("knn", model, g, X, None, differ)
    if not near.all():
        raise AssertionError(f"{tag} native labels differ from the kernel's "
                             f"off near-ties at {differ[~near][:8].tolist()}")
    fit_t = g.fit_X.t().contiguous()
    lib_ms = cuda_median_ms(
        lambda: torch.topk(torch.matmul(X, fit_t) - g.half_sq,
                           g.n_neighbors), TIMED_RUNS)
    print(f"{tag} {X.shape[0]} served rows, corpus {g.n_rows}, k = "
          f"{g.n_neighbors}: every exact tier's neighbor indices equal the "
          f"kernel's bitwise; native labels equal the kernel's but on "
          f"{differ.size} near-tie rows")
    print(f"{tag} predict ms (CUDA-event median; native: host median of "
          f"{HOST_RUNS}): kernel {kernel_ms:.4f}, "
          + ", ".join(f"{t} {ms:.4f}" for t, ms in times.items())
          + f"; context only (not the same rounding or tie order): "
          f"torch.matmul + torch.topk {lib_ms:.4f} ms warmed")
    return {"kernel": kernel_ms, **times, "matmul_topk": lib_ms}


def _ivf_chunks(fn, X):
    """``fn`` over ``IVF_CHUNK``-row slices of X, concatenated."""
    import torch

    return torch.cat([fn(X[i:i + IVF_CHUNK])
                      for i in range(0, X.shape[0], IVF_CHUNK)])


def ivf_recall(ivf, X, nprobe: int) -> float:
    """``recall_at_1`` over ``IVF_CHUNK``-row slices."""
    from traffic_classifier_sdn_tpu_torch.ops import knn_ivf

    hits = sum(knn_ivf.recall_at_1(ivf, X[i:i + IVF_CHUNK], nprobe)
               * X[i:i + IVF_CHUNK].shape[0]
               for i in range(0, X.shape[0], IVF_CHUNK))
    return hits / X.shape[0]


def phase_ivf(model: dict, g, device) -> dict:
    """The IVF tier: the port's quantizer fit on the corpus on the card
    (K = round(√4448) = 67 lists), then on 65,536 served rows: at nprobe
    = K the torch tier's labels and ``ivf_top1`` equal the exact tier's
    (the kernel's labels, ``exact_top1``) bitwise; recall@1 at nprobe 1,
    2 and 4; the tier's labels on the card equal its labels on the CPU on
    the same quantizer but on near-ties; the native mirror on the same
    partition equals the torch tier at nprobe = K but on near-ties; the
    build seconds and each form's predict ms at the default nprobe.
    Returns the numbers."""
    import torch

    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.native import knn as native_knn
    from traffic_classifier_sdn_tpu_torch.ops import knn_ivf
    from traffic_classifier_sdn_tpu_torch.ops import knn_kernel as kk

    tag = "[ivf]"
    X = served_rows(device)
    kp = interop.knn_params_from_numpy(model, device)
    sync = torch.cuda.synchronize if X.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    ivf = knn_ivf.build(kp)
    sync()
    build_s = time.perf_counter() - t0
    K = ivf.n_lists
    full = _ivf_chunks(lambda x: knn_ivf.predict(ivf, x, K), X)
    if not torch.equal(full.long(), kk.predict(g, X).long()):
        raise AssertionError(f"{tag} labels at nprobe = K differ from the "
                             "exact tier's")
    top1 = _ivf_chunks(lambda x: knn_ivf.ivf_top1(ivf, x, K), X)
    if not torch.equal(top1, knn_ivf.exact_top1(kp, X)):
        raise AssertionError(f"{tag} ivf_top1 at nprobe = K differs from "
                             "exact_top1")
    recall = {n: ivf_recall(ivf, X, n) for n in (1, 2, 4)}
    card = knn_ivf.predict_chunked(ivf, X).cpu().numpy()
    cpu_ivf = interop.ivf_params_from_numpy(
        interop.knn_params_from_numpy(model, "cpu"), ivf.centers.cpu(),
        ivf.list_idx.cpu(), ivf.nprobe)
    cpu = knn_ivf.predict_chunked(cpu_ivf, X.cpu()).numpy()
    differ = np.flatnonzero(card != cpu)
    near = near_ties("knn", model, g, X, None, differ)
    if not near.all():
        raise AssertionError(f"{tag} card and CPU labels differ off near-"
                             f"ties at {differ[~near][:8].tolist()}")
    ms = cuda_median_ms(lambda: knn_ivf.predict_chunked(ivf, X), 10,
                        warmup=2)
    hk = native_knn.NativeKnn({"fit_X": kp.fit_X.cpu().numpy(),
                               "y": kp.fit_y.cpu().numpy(),
                               "n_neighbors": kp.n_neighbors,
                               "classes": np.arange(kp.n_classes)})
    hk.build_ivf(ivf.centers.cpu().numpy(), knn_ivf.assignments_of(ivf))
    X_host = X.cpu().numpy()
    mirror = hk.predict_ivf(X_host, K)
    differ_n = np.flatnonzero(mirror != full.cpu().numpy())
    near = near_ties("knn", model, g, X, None, differ_n)
    if not near.all():
        raise AssertionError(f"{tag} the native mirror at nprobe = K differs "
                             f"off near-ties at {differ_n[~near][:8].tolist()}")
    native_ms = host_median_s(lambda: hk.predict_ivf(X_host, ivf.nprobe)) * 1e3
    sizes = (ivf.list_idx < kp.fit_X.shape[0]).sum(1)
    print(f"{tag} quantizer fit on the card in {build_s:.3f} s: K = {K} "
          f"lists of {int(sizes.min())}-{int(sizes.max())} corpus rows; at "
          f"nprobe = K labels and ivf_top1 equal the exact tier's bitwise on "
          f"{X.shape[0]} served rows")
    print(f"{tag} recall@1 " + ", ".join(
        f"nprobe {n}: {r:.6f}" for n, r in recall.items())
        + f"; card vs CPU labels at nprobe {ivf.nprobe}: {differ.size} "
        f"differ, all near-ties; native mirror vs torch tier at nprobe = K: "
        f"{differ_n.size} differ, all near-ties")
    print(f"{tag} predict at nprobe {ivf.nprobe} on {X.shape[0]} rows: torch "
          f"tier {ms:.4f} ms (CUDA-event median), native mirror "
          f"{native_ms:.3f} ms (host median of {HOST_RUNS})")
    return {"K": K, "build_s": build_s, "recall": recall, "ms": ms,
            "native_ms": native_ms}


U32 = 2.0 ** -24  # float32 unit roundoff


def dot_rule_rows(sp, X) -> np.ndarray:
    """Which rows' SVC labels two implementations of the float32 dot form
    (``SvcModel.predict_dot``: the card's matmuls and the CPU's) may
    disagree on. Against the exact decision ``D`` (float64 on the card:
    ``x − (s_hi + s_lo)`` squared and summed, exp, coefficients), each
    implementation's decision lies within

        B[p] = Σ_s |coef[p,s]|·(K⁺_s − K⁻_s)
               + (S + 1)·u·(Σ_s |coef[p,s]|·K⁺_s + |b_p|)

    where u = 2⁻²⁴, K± = exp(−γ·(d² ∓ E)·(1 ∓ u))·(1 ± 2u) (d² − E
    clamped at 0) bound its kernel values, and E = (3F + 8)·u·(‖x‖² +
    ‖s_hi‖²) bounds the dot expansion's d² error to first order: F
    rounded terms each in ‖x‖², ‖s‖² and x·s, and the few adds, clamp
    and lo corrections around them. Where every pair has |D[p]| > B[p],
    both implementations vote as sign(D) on every pair, so their labels
    agree; a row may differ only where some |D[p]| ≤ B[p]. Returns that
    mask, over 8,192-row slices."""
    import torch

    F = X.shape[1]
    sv = sp.sv_hi.double() + sp.sv_lo.double()
    s_sq = (sp.sv_hi.double() ** 2).sum(1)
    coef = sp.pair_coef.double()
    abs_coef = coef.abs()
    b = sp.intercept.double()
    gamma = float(sp.gamma)
    S = sv.shape[0]
    out = []
    for i in range(0, X.shape[0], 8192):
        x = X[i:i + 8192].double()
        d2 = torch.zeros((x.shape[0], S), dtype=torch.float64,
                         device=X.device)
        for f in range(F):
            d2 += (x[:, f, None] - sv[None, :, f]) ** 2
        E = (3 * F + 8) * U32 * ((x * x).sum(1)[:, None] + s_sq[None, :])
        k_hi = torch.exp(-gamma * torch.clamp(d2 - E, min=0.0)
                         * (1 - U32)) * (1 + 2 * U32)
        k_lo = torch.exp(-gamma * (d2 + E) * (1 + U32)) * (1 - 2 * U32)
        D = torch.exp(-gamma * d2) @ coef.t() + b
        B = ((k_hi - k_lo) @ abs_coef.t()
             + (S + 1) * U32 * (k_hi @ abs_coef.t() + b.abs()))
        out.append((D.abs() <= B).any(1))
    return torch.cat(out).cpu().numpy()


def phase_svc_dot(model: dict, g, device) -> dict:
    """``TCSDN_SVC_KERNEL=dot`` on 65,536 served rows on the card: its ms
    (CUDA-event median) beside the kernel's, its disagreements with the
    kernel (the difference form), and its labels held to the CPU's dot
    form on every row outside ``dot_rule_rows``. Returns the numbers."""
    import torch

    from traffic_classifier_sdn_tpu_torch import interop, models
    from traffic_classifier_sdn_tpu_torch.ops import rbf_kernel as rk

    tag = "[svc-dot]"
    X = served_rows(device)
    sp = interop.svc_params_from_numpy(model, device)
    with serving_env(TCSDN_SVC_KERNEL="dot"):
        fn, p = models._build_serving_path("svc", sp)
    card = fn(p, X).cpu().numpy()
    ms = cuda_median_ms(lambda: fn(p, X), 10, warmup=2)
    kernel_ms = cuda_median_ms(lambda: rk.predict(g, X), 10, warmup=2)
    vs_kernel = int((card != rk.predict(g, X).cpu().numpy()).sum())
    cpu = interop.svc_params_from_numpy(model, "cpu").predict_dot_chunked(
        X.cpu()).numpy()
    rule = dot_rule_rows(sp, X)
    differ = np.flatnonzero(card != cpu)
    if not rule[differ].all():
        raise AssertionError(f"{tag} card and CPU dot-form labels differ "
                             "outside the rule at rows "
                             f"{differ[~rule[differ]][:8].tolist()}")
    lib_ms = cuda_median_ms(
        lambda: torch.exp(-g.gamma * torch.cdist(X, g.sv_hi) ** 2) @ g.coef_t,
        TIMED_RUNS)
    print(f"{tag} {X.shape[0]} served rows, {sp.sv_hi.shape[0]} support "
          f"vectors: dot form {ms:.4f} ms, kernel {kernel_ms:.4f} ms "
          f"(CUDA-event medians); dot-form labels differ from the kernel's "
          f"on {vs_kernel} rows; card vs CPU dot form: {differ.size} rows "
          f"differ, all {int(rule.sum())} rows the rule allows "
          f"(dot_rule_rows) include them; context only (hi parts only, not "
          f"the same rounding): torch.cdist + exp + matmul {lib_ms:.4f} ms "
          "warmed")
    return {"ms": ms, "kernel_ms": kernel_ms, "vs_kernel": vs_kernel,
            "card_vs_cpu": int(differ.size), "rule_rows": int(rule.sum()),
            "cdist_exp_matmul": lib_ms}


@contextlib.contextmanager
def watched_ivf_build():
    """While active, every IVF bundle ``knn_ivf.build`` returns is kept in
    the yielded list (the quantizer a serve built)."""
    from traffic_classifier_sdn_tpu_torch.ops import knn_ivf

    built, real = [], knn_ivf.build

    def build(*a, **kw):
        built.append(real(*a, **kw))
        return built[-1]

    knn_ivf.build = build
    try:
        yield built
    finally:
        knn_ivf.build = real


def _menu_serve(tag: str, family: str, argv: list, env: dict,
                watch_ivf: bool = False):
    """One no-flag serve under ``env`` with its dispatched features, its
    kernel launches and, with ``watch_ivf``, the IVF bundles it built."""
    counters = {f: wrapper for f, (wrapper, _) in _kernels().items()}
    ivf_ctx = watched_ivf_build() if watch_ivf else contextlib.nullcontext([])
    with serving_env(**env), watched_dispatch(family) as (features, log), \
            ivf_ctx as built:
        for c in counters.values():
            c.launches = 0
        out, summary, wall = _serve(argv)
        launches = {f: c.launches for f, c in counters.items()}
    if not parse_tables(out):
        raise AssertionError(f"{tag} printed no table")
    print(f"{tag} {summary.ticks} ticks in {wall:.2f} s; host stage per "
          "tick (s): " + ", ".join(f"{x:.3f}" for x in summary.tick_seconds)
          + "; device stage per render (s): "
          + ", ".join(f"{x:.4f}" for w, _, _, x in log if w == "rows")
          + f"; label plans {summary.render_plans}; ladder "
          f"{summary.degrade}; kernel launches {launches}")
    return parse_tables(out), features, log, summary, launches, built


def phase_menu_serves(models: dict, ops: dict, device) -> dict:
    """The no-flag serves of the menus at 65,536 synthetic flows, each
    printed table's labels held to the tier's own function on the table
    its render was dispatched against: ``knearest --knn-topk hier`` (the
    torch tier, under the ladder; equal to the kernel's plain version,
    which it matches bitwise on finite rows), ``knearest --knn-topk ivf``
    (the native mirror of the quantizer the serve built, no ladder),
    ``svm`` with ``TCSDN_SVC_KERNEL=dot`` (``predict_dot`` on the card,
    but on ``dot_rule_rows``) and ``Randomforest`` with
    ``TCSDN_FOREST_KERNEL=native`` (the C++ walk, no ladder; and the
    kernel's plain version but on near-ties). Returns {serve: kernel
    launches}."""
    import torch

    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch import models as tmodels
    from traffic_classifier_sdn_tpu_torch.io import checkpoint
    from traffic_classifier_sdn_tpu_torch.models import resolve_fallback
    from traffic_classifier_sdn_tpu_torch.native import knn as native_knn
    from traffic_classifier_sdn_tpu_torch.ops import knn_ivf

    base = ["--source", "synthetic", "--synthetic-flows", str(CAPACITY),
            "--capacity", str(CAPACITY), "--max-ticks", str(SIDE_TICKS),
            "--print-every", "2"]
    found = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpts = {}
        for family, (_, carry) in SERVES.items():
            ckpts[family] = os.path.join(tmp, family)
            checkpoint.save_model(
                ckpts[family], family,
                getattr(interop, carry)(models[family], device),
                classes=CLASSES)
        kp = interop.knn_params_from_numpy(models["knn"], device)
        sp = interop.svc_params_from_numpy(models["svc"], device)

        tag = "[menus knearest --knn-topk hier]"
        tables, feats, log, summary, launches, _ = _menu_serve(
            tag, "knn", ["knearest", *base, "--knn-topk", "hier",
                         "--native-checkpoint", ckpts["knn"]], {})
        _check_dispatched(tag, tables, feats, log,
                      lambda X: knn_plain_predict(ops["knn"], X).cpu())
        _check_dispatched(tag, tables, feats, log, lambda X: kp.predict_chunked(
            X, top_k_impl="hier").cpu())
        if summary.degrade["state"] != "HEALTHY" or any(launches.values()):
            raise AssertionError(f"{tag} ladder {summary.degrade}, "
                                 f"launches {launches}")
        found["menus knearest hier"] = launches

        tag = "[menus knearest --knn-topk ivf]"
        tables, feats, log, summary, launches, built = _menu_serve(
            tag, "knn", ["knearest", *base, "--knn-topk", "ivf",
                         "--native-checkpoint", ckpts["knn"]], {},
            watch_ivf=True)
        if (summary.degrade is not None or len(built) != 1
                or not native_knn.available() or any(launches.values())):
            raise AssertionError(f"{tag} not the native mirror without the "
                                 f"ladder: {summary.degrade}, {len(built)} "
                                 f"builds, launches {launches}")
        ivf = built[0]
        hk = native_knn.NativeKnn({"fit_X": kp.fit_X.cpu().numpy(),
                                   "y": kp.fit_y.cpu().numpy(),
                                   "n_neighbors": kp.n_neighbors,
                                   "classes": np.arange(kp.n_classes)})
        hk.build_ivf(ivf.centers.cpu().numpy(), knn_ivf.assignments_of(ivf))
        _check_dispatched(tag, tables, feats, log, lambda X: hk.predict_ivf(
            X.cpu().numpy(), ivf.nprobe))
        found["menus knearest ivf"] = launches

        tag = "[menus svm TCSDN_SVC_KERNEL=dot]"
        tables, feats, log, summary, launches, _ = _menu_serve(
            tag, "svc", ["svm", *base, "--native-checkpoint", ckpts["svc"]],
            {"TCSDN_SVC_KERNEL": "dot"})
        _, met = _check_dispatched(
            tag, tables, feats, log,
            lambda X: sp.predict_dot_chunked(X).cpu(),
            allowed=lambda X, rows: dot_rule_rows(sp, X[torch.as_tensor(
                rows, device=X.device)]))
        if summary.degrade["state"] != "HEALTHY" or any(launches.values()):
            raise AssertionError(f"{tag} ladder {summary.degrade}, "
                                 f"launches {launches}")
        print(f"{tag} labels equal predict_dot's on the dispatched tables "
              f"but on {met} rows the dot rule allows")
        found["menus svm dot"] = launches

        tag = "[menus Randomforest TCSDN_FOREST_KERNEL=native]"
        tables, feats, log, summary, launches, _ = _menu_serve(
            tag, "forest", ["Randomforest", *base, "--native-checkpoint",
                            ckpts["forest"]], {"TCSDN_FOREST_KERNEL": "native"})
        fp = interop.forest_params_from_numpy(models["forest"], device)
        with serving_env(TCSDN_FOREST_KERNEL="native"):
            walk, _ = tmodels._build_serving_path("forest", fp)
        _check_dispatched(tag, tables, feats, log, lambda X: walk(None, X))
        fb = resolve_fallback("forest", fp)
        if fb.kind != "native-forest":
            raise AssertionError(f"{tag} g++ did not build the C++ walk")
        _, met = _check_dispatched(
            tag, tables, feats, log,
            lambda X: _plain_labels("forest", ops["forest"], X).cpu(),
            allowed=lambda X, rows: near_ties("forest", models["forest"],
                                              ops["forest"], X, fb, rows))
        if summary.degrade is not None or any(launches.values()):
            raise AssertionError(f"{tag} ladder {summary.degrade}, "
                                 f"launches {launches}")
        print(f"{tag} labels equal the C++ walk's on the dispatched tables, "
              f"and the kernel's plain version's but on {met} near-ties")
        found["menus Randomforest native"] = launches
    return found


CONTROLLER_PAIRS = 64  # host pairs the fake switch converses
CONTROLLER_TICKS = 6


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def watched_monitors():
    """While active, every monitor process a collector stops is kept in
    the yielded list (its ``Popen``), so its end can be checked."""
    from traffic_classifier_sdn_tpu_torch.ingest import collector

    procs, real = [], collector.SubprocessCollector._kill_group

    def kill_group(proc):
        procs.append(proc)
        real(proc)

    collector.SubprocessCollector._kill_group = staticmethod(kill_group)
    try:
        yield procs
    finally:
        collector.SubprocessCollector._kill_group = staticmethod(real)


def group_ended(pgid: int, timeout: float) -> bool:
    """Whether no process of group ``pgid`` is left, waiting up to
    ``timeout`` seconds (a child the group's leader left behind is reaped
    by init a moment after it ends)."""
    end = time.monotonic() + timeout
    while True:
        try:
            os.killpg(pgid, 0)
        except ProcessLookupError:
            return True
        if time.monotonic() > end:
            return False
        time.sleep(0.05)


def phase_controller(model: dict, k, device) -> int:
    """``Randomforest --source controller --of-port <free port>`` with no
    other flag: the serve spawns the port's own OpenFlow controller
    (``python -m traffic_classifier_sdn_tpu_torch.controller``, polling
    each second), ``tools/torch_fake_switch.py`` connects and converses
    64 host pairs, and 6 polls are served. Every printed table's labels
    equal the plain version's on its dispatched table, the 64
    conversations are tracked, and the controller ends on the serve's
    SIGTERM with no process of its group left. Returns the forest
    kernel's launches."""
    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.io import checkpoint

    tag = "[controller Randomforest]"
    port = free_port()
    switch = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "tools", "torch_fake_switch.py"),
         "--port", str(port), "--hosts", str(2 * CONTROLLER_PAIRS),
         "--duration", "300"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        with tempfile.TemporaryDirectory() as ckpt:
            checkpoint.save_model(
                ckpt, "forest",
                interop.forest_params_from_numpy(model, device),
                classes=CLASSES)
            argv = ["Randomforest", "--source", "controller", "--of-port",
                    str(port), "--max-ticks", str(CONTROLLER_TICKS),
                    "--print-every", "2", "--native-checkpoint", ckpt]
            with watched_monitors() as procs:
                tables, feats, log, summary, launches, _ = _menu_serve(
                    tag, "forest", argv, {})
    finally:
        switch.terminate()
        switch.wait(timeout=30)
    _check_dispatched(tag, tables, feats, log,
                  lambda X: _plain_labels("forest", k, X).cpu())
    engine = summary.engine
    if engine.num_flows() != CONTROLLER_PAIRS or summary.ticks != \
            CONTROLLER_TICKS:
        raise AssertionError(f"{tag} {engine.num_flows()} flows tracked in "
                             f"{summary.ticks} ticks")
    codes = []
    for proc in procs:
        try:
            codes.append(proc.wait(timeout=10))
        except subprocess.TimeoutExpired:
            proc.kill()
            raise AssertionError(f"{tag} the controller outlived the serve")
        if not group_ended(proc.pid, timeout=10.0):
            raise AssertionError(f"{tag} a process of the controller's "
                                 "group is left")
    if len(procs) != 1 or codes[0] not in (0, -15):
        raise AssertionError(f"{tag} controller processes ended with {codes}")
    print(f"{tag} {engine.num_flows()} conversations tracked from the port's "
          f"controller; {len(tables)} tables, labels equal the plain "
          f"version's on each dispatched table; {launches['forest']} forest "
          f"kernel launches; the controller ended with {codes[0]} (the "
          "serve's SIGTERM), no process of its group left")
    return launches["forest"]


WORKLOAD_FLOWS = 20480  # 4,096 conversations per class of 5
WORKLOAD_TICKS = 6


def phase_workload(model: dict, k, device) -> int:
    """``Randomforest --source workload --data-dir <tmp>`` with no other
    flag on seeded training CSVs in the reference layout
    (``reference_csvs``): 20,480 conversations, 4,096 per class, 6
    ticks. Every printed table's labels equal the plain version's on its
    dispatched table; the tick seconds and the per-class label counts
    against the generator's ground truth are printed (the forest is
    seeded, not trained on these rows: no accuracy is asked of it).
    Returns the forest kernel's launches."""
    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.ingest.workload import (
        ClassWorkload,
        class_delta_pools,
    )
    from traffic_classifier_sdn_tpu_torch.io import checkpoint

    tag = "[workload Randomforest]"
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "datasets")
        os.mkdir(data)
        reference_csvs(data)
        ckpt = os.path.join(tmp, "ckpt")
        checkpoint.save_model(
            ckpt, "forest", interop.forest_params_from_numpy(model, device),
            classes=CLASSES)
        argv = ["Randomforest", "--source", "workload", "--data-dir", data,
                "--synthetic-flows", str(WORKLOAD_FLOWS), "--max-ticks",
                str(WORKLOAD_TICKS), "--print-every", "2",
                "--native-checkpoint", ckpt]
        tables, feats, log, summary, launches, _ = _menu_serve(
            tag, "forest", argv, {})
        pools = class_delta_pools(data)
    _check_dispatched(tag, tables, feats, log,
                  lambda X: _plain_labels("forest", k, X).cpu())
    engine = summary.engine
    wl = ClassWorkload(pools, flows_per_class=WORKLOAD_FLOWS // len(pools))
    if engine.num_flows() != len(wl.labels):
        raise AssertionError(f"{tag} {engine.num_flows()} flows tracked, "
                             f"{len(wl.labels)} generated")
    flow_of = {mac: i for i in range(len(wl.labels))
               for mac in wl.flow_macs(i)}
    labels = _plain_labels("forest", k, engine.features()).cpu().numpy()
    counts = {c: np.zeros(len(CLASSES), np.int64) for c in wl.classes}
    for slot, (src, _) in engine.slot_metadata().items():
        counts[wl.labels[flow_of[src]]][labels[slot]] += 1
    print(f"{tag} {engine.num_flows()} conversations in {summary.ticks} "
          f"ticks; tick seconds "
          + ", ".join(f"{x:.3f}" for x in summary.tick_seconds)
          + f"; {len(tables)} tables, labels equal the plain version's; "
          f"{launches['forest']} forest kernel launches")
    print(f"{tag} labels per class (columns {', '.join(CLASSES)}) by the "
          "generator's ground truth: " + "; ".join(
              f"{c} {v.tolist()}" for c, v in counts.items()))
    return launches["forest"]


# the per-class training CSVs of the reference repository's datasets/
# (6_quake_training_data.csv is absent there): file name, delimiter
REFERENCE_CSVS = {
    "dns": ("dns_training_data.csv", "\t"),
    "game": ("game_training_data.csv", ","),
    "ping": ("ping_training_data.csv", "\t"),
    "telnet": ("telnet_training_data.csv", "\t"),
    "voice": ("voice_training_data.csv", "\t"),
}


def reference_csvs(path: str, rows: int = 256, seed: int = SEED) -> dict:
    """Write seeded training CSVs in the reference layout (header: the 16
    feature columns and ``Traffic Type``; game comma-delimited, the rest
    tab-delimited) into ``path``, for ``--source workload``. Class c's
    per-second packet deltas are gamma draws at 4^c times the first
    class's rate and its bytes per packet 40 + 10c, forward and reverse
    (reverse at half the packets), the cumulative and rate columns
    following from them. Returns {class: rows}."""
    from traffic_classifier_sdn_tpu_torch.core.features import (
        CSV_COLUMNS_16,
        LABEL_COLUMN,
    )

    rng = np.random.RandomState(seed)
    out = {}
    for c, (name, (fname, delim)) in enumerate(REFERENCE_CSVS.items()):
        pkts = rng.gamma(4.0, 2.0 * 4.0 ** c, rows).round()
        per_pkt = 40.0 + 10.0 * c
        cols = []
        for share in (1.0, 0.5):  # forward, reverse
            dp = (pkts * share).round()
            db = (dp * per_pkt).round()
            cp, cb = np.cumsum(dp), np.cumsum(db)
            t = np.arange(1, rows + 1, dtype=np.float64)
            cols += [cp, cb, dp, db, dp, cp / t, db, cb / t]
        table = np.stack(cols, 1)
        with open(os.path.join(path, fname), "w") as f:
            f.write(delim.join(CSV_COLUMNS_16 + (LABEL_COLUMN,)) + "\n")
            for r in table:
                f.write(delim.join(f"{v:g}" for v in r) + f"{delim}{name}\n")
        out[name] = table
    return out


def churn_capture(path: str, n_flows: int,
                  schedule=CHURN_SCHEDULE) -> list[int]:
    """Writes a replay capture of ``SyntheticFlows(n_flows)`` whose k-th
    tick has churn ``schedule[k]``: that share of the conversations
    reports, both directions. A tick at churn 0 holds one line of a
    conversation outside the population instead: a serve at capacity
    ``n_flows`` drops it (the table is full), so that tick dirties no row.
    Returns the conversations reporting in each tick."""
    from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows

    syn = SyntheticFlows(n_flows=n_flows)
    reporting = []
    with open(path, "wb") as f:
        for churn in schedule:
            syn.churn = churn
            t = syn.t
            blob = syn.tick_bytes()
            reporting.append(blob.count(b"\n") // 2)
            if not blob:
                blob = (f"data\t{t}\t1\t1\t{syn._mac(n_flows, 0)}\t"
                        f"{syn._mac(n_flows, 1)}\t2\t1\t100\n").encode()
            f.write(blob)
    return reporting


DRIFT_FACTOR = 10.0  # packet-rate factor of the drifted population
NOVEL_FACTOR = 200.0  # packet-rate factor of the novel conversations


class DriftStream:
    """A drifting telemetry stream: ``SyntheticFlows(n_flows)``, every
    conversation reporting every tick, whose packet rates (both
    directions) ``shift()`` multiplies by ``DRIFT_FACTOR``; and
    ``novel_flows`` more conversations (seed 1, MACs above the population)
    at ``NOVEL_FACTOR`` times their own seeded rates — traffic of no class
    the serve has seen — reporting in the ticks asked for."""

    def __init__(self, n_flows: int, novel_flows: int = 0):
        from traffic_classifier_sdn_tpu_torch.ingest.replay import (
            SyntheticFlows,
        )

        self.syn = SyntheticFlows(n_flows=n_flows)
        self.novel = None
        if novel_flows:
            self.novel = SyntheticFlows(n_flows=novel_flows, seed=1,
                                        mac_base=n_flows)
            self.novel.pps_fwd *= NOVEL_FACTOR
            self.novel.pps_rev *= NOVEL_FACTOR

    def shift(self, factor: float = DRIFT_FACTOR) -> None:
        self.syn.pps_fwd *= factor
        self.syn.pps_rev *= factor

    def tick_bytes(self, novel: bool = False) -> bytes:
        blob = self.syn.tick_bytes()
        if novel and self.novel is not None:
            self.novel.t = self.syn.t - 1  # the same poll time
            blob += self.novel.tick_bytes()
        return blob


def drift_ticks(n_flows: int, ticks: int, shift_at: int,
                novel_at: int | None = None, novel_flows: int = 0):
    """Yields the wire bytes of each tick of a ``DriftStream``: shifted
    from the 0-based tick ``shift_at`` on, its novel conversations
    reporting from tick ``novel_at`` on."""
    stream = DriftStream(n_flows, novel_flows)
    for k in range(ticks):
        if k == shift_at:
            stream.shift()
        yield stream.tick_bytes(novel=novel_at is not None and k >= novel_at)


def drift_capture(path: str, n_flows: int, ticks: int, shift_at: int,
                  **kw) -> None:
    """Writes ``drift_ticks`` as a replay capture."""
    with open(path, "wb") as f:
        for blob in drift_ticks(n_flows, ticks, shift_at, **kw):
            f.write(blob)


def _check_tables(tag: str, tables: list, plain: list) -> None:
    """Every rendered table's labels equal the plain version's labels on
    the table it rendered."""
    for k, (table, want) in enumerate(zip(tables, plain, strict=True)):
        wrong = [(s, lab) for s, lab in table if CLASSES[want[s]] != lab]
        if wrong or len(table) != 64:
            raise AssertionError(
                f"{tag} table {k + 1}: {len(table)} rows, labels differing "
                f"from the plain version's: {wrong[:5]}")


def phase_incremental_serve(model: dict, k, device) -> int:
    """The forest serve through incremental labels on ``churn_capture``;
    returns the forest kernel's launches in that run."""
    from traffic_classifier_sdn_tpu_torch import cli, interop
    from traffic_classifier_sdn_tpu_torch.io import checkpoint
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk

    tag = "[incremental Randomforest]"
    counters = {f: wrapper for f, (wrapper, _) in _kernels().items()}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, capture = os.path.join(tmp, "ckpt"), os.path.join(tmp, "capture")
        checkpoint.save_model(ckpt, "forest",
                              interop.forest_params_from_numpy(model, device),
                              classes=CLASSES)
        reporting = churn_capture(capture, CAPACITY)
        common = ["Randomforest", "--source", "replay", "--capture", capture,
                  "--capacity", str(CAPACITY), "--print-every", "1",
                  "--native-checkpoint", ckpt, *SERIAL]
        plain, per_render = [], []
        render = cli._print_table

        def render_checked(engine, *args, **kw):
            # the plain version's labels on the table about to render, and
            # the kernel launches of this render tick's labels
            plain.append(fk.forest_proba_plain(k, engine.features())
                         .argmax(-1).cpu())
            before = fk.forest_proba.launches
            plan = render(engine, *args, **kw)
            per_render.append(fk.forest_proba.launches - before)
            return plan

        cli._print_table = render_checked
        try:
            for c in counters.values():  # count the main path's launches only
                c.launches = 0
            out, summary, wall = _serve(
                common + ["--native-ingest", "on", "--incremental", "auto"])
            launches = {f: c.launches for f, c in counters.items()}
        finally:
            cli._print_table = render
        ref_out, ref_summary, ref_wall = _serve(
            common + ["--native-ingest", "off", "--incremental", "off"])
    plans = summary.render_plans
    print(f"{tag} conversations reporting per tick {reporting}; "
          f"{summary.ticks} ticks in {wall:.2f} s, per tick (s): "
          + ", ".join(f"{s:.3f}" for s in summary.tick_seconds)
          + "; of which ingest: "
          + ", ".join(f"{s:.3f}" for s in summary.ingest_seconds))
    print(f"{tag} label plan per render tick (kind, dirty rows): {plans}; "
          f"forest kernel launches per render tick: {per_render}")
    print(f"{tag} the same capture with --incremental off --native-ingest "
          f"off: {ref_wall:.2f} s, per tick (s): "
          + ", ".join(f"{s:.3f}" for s in ref_summary.tick_seconds))
    kinds = [kind for kind, _ in plans]
    if kinds != ["full", "full", "subset", "none", "subset", "full"]:
        raise AssertionError(f"{tag} label plans {kinds}")
    if not summary.engine.native or ref_summary.engine.native:
        raise AssertionError(f"{tag} --native-ingest was not honoured")
    if per_render != [int(n > 0) for _, n in plans]:
        raise AssertionError(
            f"{tag} forest launches per render tick {per_render}, want one "
            "on each tick with a dirty row and none on the others")
    others = {f: n for f, n in launches.items() if f != "forest" and n}
    if launches["forest"] != sum(per_render) or others:
        raise AssertionError(f"{tag} kernel launches {launches}")
    _check_tables(tag, parse_tables(out), plain)
    if out != ref_out:
        raise AssertionError(f"{tag} stdout differs from --incremental off "
                             "--native-ingest off")
    if summary.engine.num_flows() != CAPACITY or summary.engine.dropped != 1:
        raise AssertionError(
            f"{tag} {summary.engine.num_flows()} flows tracked, "
            f"{summary.engine.dropped} dropped (want {CAPACITY} and 1)")
    print(f"{tag} every table's labels equal the plain version's; stdout "
          f"byte-identical to --incremental off --native-ingest off "
          f"({len(parse_tables(out))} tables)")
    return launches["forest"]


EMITTER = """\
import sys, time
ticks = {}
for line in open(sys.argv[1], "rb"):
    ticks.setdefault(line.split(b"\\t", 2)[1], []).append(line)
out = sys.stdout.buffer
out.write(b"loading app simple_monitor_13.py\\n")
for lines in ticks.values():
    out.write(b"".join(lines))
    out.flush()
    time.sleep(float(sys.argv[2]))
"""


def phase_ryu_serve(model: dict, k, device) -> int:
    """The forest serve on ``--source ryu``: a monitor command that prints
    ``churn_capture``'s ticks to its stdout, paced ``pause`` s apart, read
    as raw pipe bytes by the native engine. Returns the forest kernel's
    launches."""
    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.io import checkpoint
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk

    tag = "[ryu Randomforest]"
    pause = 1.0
    counters = {f: wrapper for f, (wrapper, _) in _kernels().items()}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, capture = os.path.join(tmp, "ckpt"), os.path.join(tmp, "capture")
        emitter = os.path.join(tmp, "emitter.py")
        checkpoint.save_model(ckpt, "forest",
                              interop.forest_params_from_numpy(model, device),
                              classes=CLASSES)
        reporting = churn_capture(capture, CAPACITY)
        with open(emitter, "w") as f:
            f.write(EMITTER)
        lines = sum(2 * n or 1 for n in reporting)
        for c in counters.values():
            c.launches = 0
        out, summary, wall = _serve([
            "Randomforest", "--source", "ryu", "--monitor-cmd",
            f"{sys.executable} {emitter} {capture} {pause}",
            "--native-ingest", "on", "--capacity", str(CAPACITY),
            "--print-every", "1", "--native-checkpoint", ckpt, *SERIAL,
        ])
        launches = {f: c.launches for f, c in counters.items()}
    engine = summary.engine
    tables = parse_tables(out)
    plans = summary.render_plans
    print(f"{tag} {summary.ticks} polls in {wall:.2f} s (ticks paced "
          f"{pause} s apart); per poll (s): "
          + ", ".join(f"{s:.3f}" for s in summary.tick_seconds)
          + "; of which ingest (raw bytes into the native engine, wire "
          "scatter): " + ", ".join(f"{s:.3f}" for s in summary.ingest_seconds))
    print(f"{tag} label plan per render tick: {plans}; launches {launches}")
    if not engine.native or engine.batcher.parsed != lines:
        raise AssertionError(
            f"{tag} native={engine.native}, {engine.batcher.parsed} lines "
            f"parsed, want {lines}")
    if engine.num_flows() != CAPACITY or engine.dropped != 1:
        raise AssertionError(f"{tag} {engine.num_flows()} flows tracked, "
                             f"{engine.dropped} dropped")
    want = sum(1 for _, n in plans if n)
    others = {f: n for f, n in launches.items() if f != "forest" and n}
    if launches["forest"] != want or want == 0 or others:
        raise AssertionError(f"{tag} kernel launches {launches}, want {want} "
                             "forest launches (render ticks with a dirty row)")
    plain = fk.forest_proba_plain(k, engine.features()).argmax(-1).cpu()
    _check_tables(tag, tables[-1:], [plain])
    print(f"{tag} {engine.num_flows()} flows tracked from "
          f"{engine.batcher.parsed} parsed lines, {launches['forest']} "
          f"forest launches over {len(tables)} render ticks, last table's "
          "labels equal the plain version's")
    return launches["forest"]


def phase_dirty_buckets(k, device) -> list[dict]:
    """The forest kernel at every dirty bucket of incremental labels at
    capacity 65,536, on the first rows of a served table: bitwise equal to
    its plain version, with single-call and back-to-back times."""
    from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk
    from traffic_classifier_sdn_tpu_torch.serving.incremental import (
        dirty_buckets,
    )

    X_cap = ft.features12(synthetic_table(CAPACITY, 3, device))
    out = []
    for b in dirty_buckets(CAPACITY):
        X = X_cap[:b].contiguous()
        err = _forest_equal(k, X, f"dirty bucket {b}")
        ms = cuda_median_ms(lambda: fk.forest_proba(k, X), TIMED_RUNS)
        b2b = cuda_back_to_back_ms(lambda: fk.forest_proba(k, X))
        bound_ms, bound_by = forest_bound(k, X, node_visits(k, X))
        R = fk.launch_shape(b, k)[0]
        print(f"[kernels] forest_proba dirty bucket {b}: bitwise equal, "
              f"kernel {ms:.4f} ms (back to back {b2b:.4f}), bound "
              f"{bound_ms:.5f} ms ({bound_by}), {R} rows per tile, "
              f"{fk.blocks(b, R)} blocks")
        out.append({"rows": b, "max_abs_err": err, "ms": ms,
                    "back_to_back_ms": b2b, "bound_ms": bound_ms,
                    "bound_by": bound_by})
    return out


def phase_ingest_breakdown(k, device) -> None:
    """Host seconds per tick of ``SyntheticFlows(65536)`` (131,072 records)
    through each ingest spine, and the device time of each step of the
    incremental label plan at 0, 1, 20 and 100 % churn."""
    import torch

    from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
    from traffic_classifier_sdn_tpu_torch.ingest.batcher import FlowStateEngine
    from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk
    from traffic_classifier_sdn_tpu_torch.serving.incremental import (
        IncrementalLabels,
    )

    tag = "[breakdown ingest]"
    ticks = 3
    syn_r, syn_b = SyntheticFlows(CAPACITY), SyntheticFlows(CAPACITY)
    records = [syn_r.tick() for _ in range(ticks)]
    blobs = [syn_b.tick_bytes() for _ in range(ticks)]  # the same telemetry
    spines = {
        "Python spine, ingest(records)": (False, records, "ingest"),
        "native spine, ingest(records)": (True, records, "ingest"),
        "native spine, ingest_bytes(raw)": (True, blobs, "ingest_bytes"),
    }
    features = []
    for name, (native, batches, method) in spines.items():
        eng = FlowStateEngine(CAPACITY, device=device, native=native)
        secs = []
        for batch in batches:
            t0 = time.perf_counter()
            eng.mark_tick()
            getattr(eng, method)(batch)
            eng.step()
            torch.cuda.synchronize(device)
            secs.append(time.perf_counter() - t0)
        features.append(eng.features())
        print(f"{tag} {name}: {len(batch)} "
              f"{'bytes' if method == 'ingest_bytes' else 'records'} a tick; "
              "host s per tick (create, update, update): "
              + ", ".join(f"{s:.4f}" for s in secs))
    if not all(torch.equal(f.view(torch.int32), features[0].view(torch.int32))
               for f in features):
        raise AssertionError(f"{tag} the three spines built different tables")

    tag = "[breakdown incremental]"
    eng = FlowStateEngine(CAPACITY, device=device, native=True,
                          track_dirty=True)
    syn = SyntheticFlows(CAPACITY)
    inc = IncrementalLabels(eng, fk.predict, k)
    for _ in range(2):
        eng.ingest_bytes(syn.tick_bytes())
        eng.step()
    inc.labels()  # the first render predicts the whole table
    for churn in (0.0, 0.01, 0.2, 1.0):
        syn.churn = churn
        eng.mark_tick()
        eng.ingest_bytes(syn.tick_bytes())
        eng.step()
        mask = eng.dirty.clone()
        n = int(ft.dirty_count(mask))
        bucket = next((b for b in inc.buckets if n <= b), None)
        steps = {"count": lambda: ft.dirty_count(mask)}
        if n and bucket:
            idx = ft.compact_dirty(mask, bucket)
            Xd = ft.features12_at(eng.table, idx)
            labels = fk.predict(k, Xd)
            cache = inc._cache.clone()
            steps.update({
                "compact": lambda: ft.compact_dirty(mask, bucket),
                "gather": lambda: ft.features12_at(eng.table, idx),
                f"predict ({bucket} rows)": lambda: fk.predict(k, Xd),
                "merge": lambda: ft.merge_labels(cache, idx, labels),
            })
        elif n:
            X = ft.features12(eng.table)
            steps.update({
                "features12": lambda: ft.features12(eng.table),
                f"predict ({CAPACITY} rows)": lambda: fk.predict(k, X),
            })
        ms = {name: cuda_median_ms(fn, TIMED_RUNS) for name, fn in steps.items()}
        host = []
        for _ in range(10):
            eng.dirty.copy_(mask)
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            inc.labels()
            torch.cuda.synchronize(device)
            host.append((time.perf_counter() - t0) * 1e3)
        full = cuda_median_ms(
            lambda: fk.predict(k, ft.features12(eng.table)), TIMED_RUNS)
        print(f"{tag} churn {churn:.0%}: {n} dirty rows; device ms "
              + ", ".join(f"{name} {t:.4f}" for name, t in ms.items())
              + f" (sum {sum(ms.values()):.4f}); the whole label step "
              f"(host clock, with its one sync) {statistics.median(host):.4f} "
              f"ms; full re-predict (features12 + predict) {full:.4f} ms")


def render_breakdown(engine, family: str, g, device) -> None:
    """Device time of each step of a render tick on the served table (CUDA
    event medians), the host side of the render, and the wire scatter of
    one synthetic tick — where a tick's time goes outside Python ingest."""
    import torch

    from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
    from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows

    table, n = engine.table, engine.table.capacity
    predict = _kernels()[family][1]
    X = ft.features12(table)
    labels = predict(g, X)
    tag = f"[breakdown {SERVES[family][0]}]"
    steps = {
        "features12": lambda: ft.features12(table),
        f"{family} predict (kernel + labels)": lambda: predict(g, X),
        "top_active_render (64 of the table)": lambda: ft.top_active_render(
            table, labels, 64, engine.tick_floor),
    }
    if family == "forest":  # the ingest side is the same for every family
        syn = SyntheticFlows(n_flows=n)
        tick_wire(syn, True)
        wire_np = tick_wire(syn, False)
        wire = ft.wire_tensor(wire_np, device)
        steps[f"wire to device ({wire_np.shape[0]} x {wire_np.shape[1]})"] = (
            lambda: ft.wire_tensor(wire_np, device))
        steps[f"apply_wire ({wire_np.shape[0]} rows)"] = (
            lambda: ft.apply_wire(table, wire))
    for name, fn in steps.items():
        print(f"{tag} {name}: {cuda_median_ms(fn, TIMED_RUNS):.4f} ms")
    t0 = time.perf_counter()
    for _ in range(10):
        engine.render_sample(labels, 64)
    torch.cuda.synchronize(device)
    print(f"{tag} render_sample host round trip (ranking, 64 rows to "
          f"the host): {(time.perf_counter() - t0) * 100:.4f} ms")


INSTANCES: dict = {}  # ptxas_instances of this run's build

OBS_TICKS = 6
OBS_PRINT_EVERY = 2
# seconds a held source waits for the signal that ends its serve
SOURCE_HOLD_S = 120.0
OBS_STAGES = ("poll", "parse", "scatter", "predict", "render")
# what the no-flag serve writes into global_metrics (ROADMAP Queue 1
# item 3a): counters, gauges and histograms a scrape must carry
OBS_SERIES = {
    "counter": ("ticks", "records"),
    "gauge": ("flows_dropped", "native_parse_errors", "degrade_state",
              "dirty_rows", "queue_depth", "obs_port"),
    "summary": ("ingest_s", "predict_s", "stage_overlap_s", "stage_tick_s",
                "stage_host_s", "stage_dispatch_s", "stage_device_s",
                "stage_compact_s", "e2e_emit_to_render_s", "wf_render_s"),
}


@contextlib.contextmanager
def held_source(ticks: int):
    """While active, a serve's synthetic source delivers ``ticks`` ticks
    and then has nothing more to say (a monitor between polls): its next
    tick waits, for a signal to end the serve, at most ``SOURCE_HOLD_S``
    seconds. Yields an event set when it starts to wait: the serve has
    finished its last tick, the ``--metrics-every`` report included."""
    import threading

    from traffic_classifier_sdn_tpu_torch.ingest import replay

    tick = replay.SyntheticFlows.tick
    waiting = threading.Event()

    def held(self):
        n = getattr(self, "_held_ticks", 0)
        if n >= ticks:
            waiting.set()
            end = time.monotonic() + SOURCE_HOLD_S
            while time.monotonic() < end:
                time.sleep(0.01)
            raise AssertionError("no signal ended the held serve")
        self._held_ticks = n + 1
        return tick(self)

    replay.SyntheticFlows.tick = held
    try:
        yield waiting
    finally:
        replay.SyntheticFlows.tick = tick


def _get(port: int, path: str):
    """(status, body) of one GET on the serve's obs port."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class ObsWatch:
    """A thread beside an in-process serve: it scrapes ``/metrics`` every
    ``every`` seconds while the serve runs, and once ``settled(metrics)``
    holds (read from the serve's ``global_metrics``) it scrapes
    ``/metrics``, ``/healthz`` and ``/events`` a last time and sends the
    process SIGTERM, which ends the serve."""

    def __init__(self, settled, every: float = 0.05):
        import threading

        from traffic_classifier_sdn_tpu_torch.utils.metrics import (
            global_metrics,
        )

        self.m = global_metrics
        self.settled, self.every = settled, every
        self.scrapes: list[tuple[float, str]] = []  # (ticks, text)
        self.final: dict = {}
        self.error: str | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def __enter__(self):
        self.m.reset()  # no earlier serve's obs_port
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._thread.join(timeout=30)
        return False

    def _run(self):
        import signal

        end = time.monotonic() + SOURCE_HOLD_S
        try:
            while time.monotonic() < end:
                port = int(self.m.gauges.get("obs_port", 0))
                if port:
                    ticks = self.m.counters.get("ticks", 0)
                    status, body = _get(port, "/metrics")
                    if status != 200:
                        raise AssertionError(f"/metrics answered {status}")
                    self.scrapes.append((ticks, body.decode()))
                    if self.settled(self.m):
                        # the serve is live, its source held
                        for path in ("/metrics", "/healthz", "/events?n=64"):
                            self.final[path] = _get(port, path)
                        self.scrapes.append(
                            (self.m.counters.get("ticks", 0),
                             self.final["/metrics"][1].decode()))
                        break
                time.sleep(self.every)
            else:
                self.error = "the serve never settled"
        except Exception as e:  # noqa: BLE001 — reported by the phase
            self.error = f"{type(e).__name__}: {e}"
        signal.raise_signal(signal.SIGTERM)


def _serve_until_signal(argv: list) -> tuple[str, str, int, float]:
    """(stdout, stderr, exit status, wall seconds) of an in-process serve
    that a signal ends."""
    from traffic_classifier_sdn_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            cli.main(argv)
        except SystemExit as e:
            code = e.code
    return out.getvalue(), err.getvalue(), code, time.perf_counter() - t0


def frames(text: str) -> list[str]:
    """The printed tables of a serve's stdout, each with its trailing
    lines (``... showing``)."""
    lines = text.splitlines(True)
    starts = [i for i in range(len(lines) - 1)
              if lines[i].startswith("+") and "Flow ID" in lines[i + 1]]
    return ["".join(lines[a:b])
            for a, b in zip(starts, starts[1:] + [len(lines)])]


def subsequence(got: str, want: str) -> bool:
    """The subsequence rule of the pipelined serve: ``got``'s tables are
    ``want``'s in order, some missing (coalesced), and the last is the
    same."""
    g, w = frames(got), frames(want)
    it = iter(w)
    return bool(g) and g[-1] == w[-1] and all(any(f == x for x in it)
                                              for f in g)


def _renders_done(m, renders: int) -> bool:
    h = m.histograms.get("stage_render_s")
    done = (h.count if h is not None else 0) + m.counters.get(
        "ticks_coalesced", 0)
    return m.counters.get("ticks", 0) >= renders and done >= renders


def _dump_events(obs_dir: str, reason: str) -> list[dict]:
    names = [n for n in os.listdir(obs_dir)
             if n.startswith("flightrec-") and n.endswith(f"-{reason}.jsonl")]
    if len(names) != 1:
        raise AssertionError(f"flight-recorder dumps in {obs_dir}: "
                             f"{sorted(os.listdir(obs_dir))}")
    with open(os.path.join(obs_dir, names[0])) as f:
        return [json.loads(line) for line in f]


def provenance_cost_s(ticks: int = 2000) -> float:
    """Host seconds a tick of latency provenance costs the serve loop:
    the stamp, ``begin_tick``, the parse and scatter marks, the seal, the
    device mark and the fold of one batch, averaged over ``ticks``."""
    from traffic_classifier_sdn_tpu_torch.ingest.batcher import batch_emit_ts
    from traffic_classifier_sdn_tpu_torch.ingest.protocol import (
        TelemetryRecord,
        stamp_records,
    )
    from traffic_classifier_sdn_tpu_torch.obs import LatencyProvenance
    from traffic_classifier_sdn_tpu_torch.utils.metrics import Metrics

    lat = LatencyProvenance(metrics=Metrics())
    batch = [TelemetryRecord(time=1, datapath="1", in_port="1", eth_src="a",
                             eth_dst="b", out_port="2", packets=1, bytes=1)]
    t0 = time.perf_counter()
    for _ in range(ticks):
        object.__setattr__(batch[0], "emit_ts", None)
        stamp_records(batch[:1])
        lat.begin_tick([(0, batch_emit_ts(batch), None, None, CAPACITY)])
        lat.mark_parse()
        lat.mark_scatter()
        seal = lat.seal()
        lat.mark_device(seal)
        lat.render_visible(seal)
    return (time.perf_counter() - t0) / ticks


def phase_obs(model: dict, k, device) -> int:
    """The metrics and observability plane on the no-flag forest serve of
    65,536 flows: ``/metrics`` scraped while it ticks, ``/healthz``,
    ``/events``, the ``--metrics-every`` report, the budget guard of a
    snapshot due every tick, the SIGTERM post-mortem, stdout against the
    same serve with the obs surfaces off, host tick p50 with latency
    provenance on and off, and a dispatch-error drill whose rung /healthz
    shows. Returns the forest kernel's launches."""
    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.io import checkpoint
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk
    from traffic_classifier_sdn_tpu_torch.utils import faults

    tag = "[obs Randomforest]"
    renders = OBS_TICKS // OBS_PRINT_EVERY
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, obs_dir = os.path.join(tmp, "ckpt"), os.path.join(tmp, "obs")
        checkpoint.save_model(ckpt, "forest",
                              interop.forest_params_from_numpy(model, device),
                              classes=CLASSES)
        base = ["Randomforest", "--source", "synthetic", "--synthetic-flows",
                str(CAPACITY), "--capacity", str(CAPACITY), "--print-every",
                str(OBS_PRINT_EVERY), "--native-checkpoint", ckpt]
        fk.forest_proba.launches = 0
        with watched_dispatch("forest") as (features, log), \
                held_source(OBS_TICKS) as held, \
                ObsWatch(lambda m: held.is_set()
                         and _renders_done(m, renders)) as watch:
            out, err, code, wall = _serve_until_signal(base + [
                "--metrics-every", "2", "--obs-port", "0",
                "--obs-dir", obs_dir, "--serve-checkpoint-every", "1",
                "--serve-checkpoint-dir", os.path.join(tmp, "rot")])
        launches = fk.forest_proba.launches
        counters = dict(watch.m.counters)
        coalesced = int(counters.get("ticks_coalesced", 0))
        save_s = list(watch.m.histograms["checkpoint_save_s"]._samples)
        if watch.error or code != 143:
            raise AssertionError(f"{tag} exit {code}, watcher: {watch.error}"
                                 f"; stderr tail: {err[-2000:]}")
        full = [t for _, t in watch.scrapes
                if all(f"# TYPE tcsdn_stage_{s}_s summary" in t
                       for s in OBS_STAGES)]
        status, body = watch.final["/metrics"]
        text = body.decode()
        missing = [f"{kind} {n}" for kind, names in OBS_SERIES.items()
                   for n in names if f"# TYPE tcsdn_{n} {kind}" not in text]
        missing += [s for s in (*OBS_STAGES, "snapshot")
                    if f"# TYPE tcsdn_stage_{s}_s summary" not in text]
        if status != 200 or missing or len(full) < 2:
            raise AssertionError(f"{tag} /metrics {status}, missing "
                                 f"{missing}, {len(full)} full scrapes of "
                                 f"{len(watch.scrapes)}")
        status, body = watch.final["/healthz"]
        health = json.loads(body)
        if (status != 200 or not health["healthy"]
                or health["degrade"]["state"] != "HEALTHY"
                or health["label_cache"]["mode"] != "host"
                or not health["latency"]["observed"]):
            raise AssertionError(f"{tag} /healthz {status} {health}")
        status, body = watch.final["/events?n=64"]
        events = json.loads(body)
        if status != 200 or not events:
            raise AssertionError(f"{tag} /events {status}: {events}")
        dump = _dump_events(obs_dir, "sigterm")
        if dump[-1]["kind"] != "signal.sigterm":
            raise AssertionError(f"{tag} the dump ends with {dump[-1]}")
        reports = [ln for ln in err.splitlines() if ln.startswith("metrics ")]
        _check_printed(tag, parse_tables(out), "forest", k, features, log)
        if launches < 1 or len(reports) != OBS_TICKS // 2:
            raise AssertionError(f"{tag} {launches} launches, "
                                 f"{len(reports)} metrics lines")
        scraped_ticks = sorted({t for t, _ in watch.scrapes})
        series = sorted(re.findall(r"^# TYPE tcsdn_(\S+) (\S+)$", text,
                                   re.M))
        print(f"{tag} {OBS_TICKS} ticks, then SIGTERM (exit {code}) after "
              f"{wall:.2f} s; {len(watch.scrapes)} /metrics scrapes during "
              f"the serve at ticks {scraped_ticks}, {len(full)} with every "
              f"stage summary; {len(series)} series: "
              + ", ".join(f"{n} ({kind})" for n, kind in series))
        print(f"{tag} a snapshot due every tick under the default budget "
              f"(0.2 of the loop's time): "
              f"{int(counters.get('checkpoint_saves', 0))} saves ("
              + ", ".join(f"{x:.4f}" for x in save_s) + " s), "
              f"{int(counters.get('checkpoint_skipped', 0))} skipped of "
              f"{OBS_TICKS} ticks")
        if not counters.get("checkpoint_saves"):
            raise AssertionError(f"{tag} no snapshot under the budget")
        print(f"{tag} /healthz 200: degrade {health['degrade']['state']}, "
              f"label_cache {health['label_cache']}, latency "
              f"{health['latency']}; /events {len(events)} events; the "
              f"sigterm dump holds {len(dump) - 1} events, the last "
              f"{dump[-1]['kind']}; {launches} forest launches")
        e2e = re.findall(r'^tcsdn_(stage_\w+|e2e_emit_to_render_s)'
                         r'\{quantile="0.5"\} (\S+)$', text, re.M)
        print(f"{tag} p50 (s) on the card's serve: "
              + ", ".join(f"{n} {v}" for n, v in e2e))
        # the same serve with the obs surfaces off, twice each with
        # latency provenance on (the default) and off
        offs, ticks = [], {"on": [], "off": []}
        for lat in ("on", "off"):
            fk.forest_proba.launches = 0
            o, summary, _ = _serve(base + ["--max-ticks", str(OBS_TICKS),
                                           "--latency-provenance", lat])
            launches += fk.forest_proba.launches
            ticks[lat] += summary.tick_seconds
            offs.append((o, summary.ticks_coalesced))
        plain_out, plain_coalesced = offs[0]
        short, long_ = sorted(((out, coalesced), (plain_out, plain_coalesced)),
                              key=lambda x: len(frames(x[0])))
        if (not subsequence(short[0], long_[0])
                or len(frames(long_[0])) - len(frames(short[0]))
                != abs(coalesced - plain_coalesced)):
            raise AssertionError(f"{tag} stdout with the obs surfaces on "
                                 "and off breaks the subsequence rule")
        p50 = {lat: statistics.median(x) for lat, x in ticks.items()}
        plane_s = provenance_cost_s()
        print(f"{tag} stdout equal with the obs plane on and off "
              f"(subsequence rule; {coalesced} and {plain_coalesced} "
              f"coalesced); host tick p50 with latency provenance on "
              f"{p50['on']:.4f} s, off {p50['off']:.4f} s "
              f"({(p50['on'] / p50['off'] - 1) * 100:+.2f} %, "
              f"{len(ticks['on'])} ticks each; the JAX bench bounds stamping "
              f"at 3 %); the plane's own host work a tick {plane_s * 1e6:.1f} "
              f"us ({plane_s / p50['off'] * 100:.4f} % of the tick p50)")
        # a dispatch-error drill with the obs port: every device call from
        # the second fails and no probe is due, so the serve stays demoted
        drill_dir = os.path.join(tmp, "drill")
        plan = faults.FaultPlan([faults.FaultRule(
            "degrade.dispatch_error", after=1, times=None)])
        fk.forest_proba.launches = 0
        with held_source(4) as held, faults.installed(plan), \
                ObsWatch(lambda m: held.is_set() and _renders_done(m, 4)
                         and m.gauges.get("degrade_state", 0) != 0) as watch:
            out, err, code, wall = _serve_until_signal(base + [
                "--print-every", "1", "--probe-every", "600", "--obs-port",
                "0", "--obs-dir", drill_dir])
        launches += fk.forest_proba.launches
        status, body = watch.final.get("/healthz", (None, b"{}"))
        health = json.loads(body)
        edges = [(e["frm"], e["to"], e["reason"])
                 for e in _dump_events(drill_dir, "sigterm")
                 if e["kind"] == "degrade.transition"]
        if (watch.error or code != 143 or status != 200
                or health["degrade"]["state"] != "DEGRADED"
                or not health["degraded"]
                or edges != [("HEALTHY", "DEGRADED", "error:FaultInjected")]):
            raise AssertionError(f"{tag} drill: exit {code}, watcher "
                                 f"{watch.error}, /healthz {status} "
                                 f"{health}, transitions {edges}")
        print(f"{tag} dispatch-error drill: /healthz 200 with rung "
              f"{health['degrade']['rung']} (fallback "
              f"{health['degrade']['fallback']}, {len(plan.fires)} fires); "
              f"the sigterm dump holds the transition {edges[0]}")
    return launches


CKPT_TICKS = 6
CKPT_STOP = 4  # the serve checkpointed every 2 ticks stops here
CKPT_BIG_FLOWS = 1 << 20


def _capture(path: str, n_flows: int, ticks: int) -> None:
    """``ticks`` ticks of ``SyntheticFlows(n_flows)`` as a monitor capture."""
    from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows

    syn = SyntheticFlows(n_flows=n_flows)
    with open(path, "wb") as f:
        for _ in range(ticks):
            f.write(syn.tick_bytes())


def _split(path: str, first: int) -> tuple[str, str]:
    """The capture's first ``first`` ticks and the rest, as two files."""
    head, tail = f"{path}.head{first}", f"{path}.tail{first}"
    with open(path, "rb") as f, open(head, "wb") as h, open(tail, "wb") as t:
        seen = []
        for line in f:
            stamp = line.split(b"\t", 2)[1]
            if stamp not in seen:
                seen.append(stamp)
            (h if len(seen) <= first else t).write(line)
    return head, tail


@contextlib.contextmanager
def rendered_features():
    """While active, each serial render of the CLI records the feature
    matrix of the table it renders."""
    from traffic_classifier_sdn_tpu_torch import cli

    render, seen = cli._print_table, []

    def recording(engine, *args, **kw):
        seen.append(engine.features())
        return render(engine, *args, **kw)

    cli._print_table = recording
    try:
        yield seen
    finally:
        cli._print_table = render


def _check_rendered(tag: str, out: str, features: list, k) -> None:
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk

    tables = parse_tables(out)
    if len(tables) != len(features):
        raise AssertionError(f"{tag} {len(tables)} tables, {len(features)} "
                             "renders")
    for table, X in zip(tables, features):
        plain = fk.forest_proba_plain(k, X).argmax(-1).cpu()
        wrong = [s for s, lab in table if CLASSES[plain[s]] != lab]
        if wrong:
            raise AssertionError(f"{tag} labels differ from the plain "
                                 f"version's at slots {wrong[:5]}")


def _device_sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def _same_state(a, b) -> bool:
    """Every table leaf bitwise, and the index, of two engines (the
    native index compared as its bulk export: fingerprints, occupancy,
    frontier, free stack and the metadata cells)."""
    from traffic_classifier_sdn_tpu_torch.io import serving_checkpoint as sc

    for name in sc._TABLE_LEAVES:
        x, y = sc._fetch_leaf(a.table, name), sc._fetch_leaf(b.table, name)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            return False
    if a.native != b.native:
        return False
    if not a.native:
        ia, ib = a.index, b.index
        return (ia.slot_to_key, ia.slot_meta, ia.free, ia.next_slot) == (
            ib.slot_to_key, ib.slot_meta, ib.free, ib.next_slot)
    ea, eb = a.batcher.export_index(), b.batcher.export_index()
    slots = np.nonzero(ea[1])[0]
    return (all(np.array_equal(x, y) for x, y in zip(ea, eb))
            and all(np.array_equal(x, y) for x, y in zip(
                a.batcher.export_meta(slots), b.batcher.export_meta(slots))))


def phase_checkpoint(model: dict, k, device) -> int:
    """Crash-safe serving checkpoints on the card: continuation of a
    stopped serve, rollback past a truncated newest member, the card/CPU
    round trip, and the save and restore time and size at 65,536 and 2^20
    flows. Returns the forest kernel's launches."""
    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.ingest.batcher import (
        FlowStateEngine,
    )
    from traffic_classifier_sdn_tpu_torch.io import checkpoint
    from traffic_classifier_sdn_tpu_torch.io import serving_checkpoint as sc
    from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk
    from traffic_classifier_sdn_tpu_torch.utils.metrics import global_metrics

    tag = "[checkpoint Randomforest]"
    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, rot = os.path.join(tmp, "ckpt"), os.path.join(tmp, "rot")
        capture = os.path.join(tmp, "capture")
        checkpoint.save_model(ckpt, "forest",
                              interop.forest_params_from_numpy(model, device),
                              classes=CLASSES)
        _capture(capture, CAPACITY, CKPT_TICKS)
        head, tail = _split(capture, CKPT_STOP)
        _, tail3 = _split(capture, 2)
        base = ["Randomforest", "--source", "replay", "--capacity",
                str(CAPACITY), "--print-every", "2", "--pipeline", "off",
                "--native-checkpoint", ckpt]

        def serve(*extra):
            nonlocal launches
            fk.forest_proba.launches = 0
            err = io.StringIO()
            with rendered_features() as seen, \
                    contextlib.redirect_stderr(err):
                out, summary, wall = _serve(base + list(extra))
            launches += fk.forest_proba.launches
            return out, summary, wall, seen, err.getvalue()

        full, *_ = serve("--capture", capture)
        head_out, stopped, _, _, _ = serve(
            "--capture", head, "--serve-checkpoint-every", "2",
            "--serve-checkpoint-dir", rot, "--serve-checkpoint-budget", "0")
        saves = global_metrics.histograms["checkpoint_save_s"]
        nbytes = global_metrics.counters["checkpoint_bytes"] / saves.count
        members = [t for t, _ in sc.list_checkpoints(rot)]
        out, resumed, _, seen, err = serve(
            "--capture", tail, "--restore-serve-state", rot)
        after = fk.forest_proba.launches
        if (members != [4, 2] or head_out + out != full
                or f"restored {CAPACITY} tracked flows" not in err
                or after < 1):
            raise AssertionError(
                f"{tag} members {members}; restored stdout equal to the "
                f"uninterrupted serve's: {head_out + out == full}; "
                f"stderr {err[-500:]}")
        _check_rendered(tag, out, seen, k)
        print(f"{tag} serve stopped after tick {CKPT_STOP} (members "
              f"{members}), restored: ticks 5-6 print the uninterrupted "
              f"serve's stdout byte for byte ({len(frames(full))} tables "
              f"in all), labels equal the plain version's on the restored "
              f"table; the render after the restore launched the forest "
              f"kernel {after} time(s)")
        # rollback: the newest member truncated
        newest = sc.checkpoint_path(rot, 4)
        with open(newest, "rb") as f:
            blob = f.read()
        with open(newest, "wb") as f:
            f.write(blob[: len(blob) // 2])
        obs_dir = os.path.join(tmp, "obs")
        out, rolled, _, seen, err = serve(
            "--capture", tail3, "--restore-serve-state", rot,
            "--obs-dir", obs_dir, "--obs-dump-on-exit")
        events = _dump_events(obs_dir, "on-demand")
        back = [e for e in events if e["kind"] == "checkpoint.rollback"]
        restored = [e["path"] for e in events
                    if e["kind"] == "checkpoint.restore"]
        if (not back or back[0]["rejected"] != newest
                or restored != [sc.checkpoint_path(rot, 2)]
                or frames(head_out)[0] + out != full):
            raise AssertionError(f"{tag} rollback: {back} {restored}")
        _check_rendered(tag, out, seen, k)
        print(f"{tag} newest member truncated to {len(blob) // 2} of "
              f"{len(blob)} bytes: the restore rolled back to "
              f"{os.path.basename(restored[0])} (rejected "
              f"{os.path.basename(newest)}: {back[0]['error']}) and ticks "
              "3-6 print the uninterrupted serve's stdout byte for byte")
        # the card/CPU round trip, every leaf and the index bitwise
        member = sc.checkpoint_path(rot, 2)
        t0 = time.perf_counter()
        card = sc.restore(member, device=device)
        _device_sync(device)
        restore_s = time.perf_counter() - t0
        cpu = sc.restore(member, device="cpu")
        back_path = os.path.join(tmp, "from-cpu.npz")
        sc.save(cpu, back_path)
        again = sc.restore(back_path, device=device)
        if not (_same_state(card, cpu) and _same_state(again, card)
                and card.table.in_use.device.type == device.type
                and not cpu.table.in_use.is_cuda):
            raise AssertionError(f"{tag} card/CPU round trip differs")
        print(f"{tag} a member saved on the card restores on the CPU and the "
              "CPU's save restores on the card, every leaf and the index "
              f"bitwise; {CAPACITY} flows: save {saves.mean:.4f} s "
              f"(median of {saves.count}: {saves.percentile(50):.4f} s), "
              f"{nbytes:.0f} bytes, restore {restore_s:.4f} s")
        # 2^20 flows: one save and one restore, timed
        eng = FlowStateEngine(CKPT_BIG_FLOWS, device=device, native=True)
        syn = SyntheticFlows(n_flows=CKPT_BIG_FLOWS)
        for _ in range(2):
            eng.mark_tick()
            eng.ingest_bytes(syn.tick_bytes())
            eng.step()
        _device_sync(device)
        big = os.path.join(tmp, "big.npz")
        t0 = time.perf_counter()
        big_bytes = sc.save(eng, big)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        big_restored = sc.restore(big, device=device)
        _device_sync(device)
        big_restore_s = time.perf_counter() - t0
        if (big_restored.num_flows() != CKPT_BIG_FLOWS
                or not _same_state(big_restored, eng)):
            raise AssertionError(f"{tag} the 2^20-flow restore differs")
        print(f"{tag} {CKPT_BIG_FLOWS} flows: save {save_s:.3f} s, "
              f"{big_bytes} bytes ({big_bytes / CKPT_BIG_FLOWS:.1f} B a "
              f"flow), restore {big_restore_s:.3f} s, every leaf and the "
              "index bitwise")
    return launches


DRIFT_NOVEL = 4096  # novel conversations, reporting after the promotion
DRIFT_BASE = CAPACITY - DRIFT_NOVEL  # conversations of the drifting stream
DRIFT_SHIFT_AT = 6  # the 0-based tick from which the rates are shifted
DRIFT_PAUSE = 0.5  # s between the emitter's ticks
DRIFT_MAX_TICKS = 90  # the emitter's cap if nothing promotes
DRIFT_AFTER_TICKS = 4  # ticks emitted once the promotion (or rollback) landed
# the stated probe-agreement floor: a refit of the random 100-tree teacher
# on one window reproduces about four in five of its labels on the next
# (PERF.md), never all of them
DRIFT_PARITY = 0.6
DRIFT_FLAGS = ("--drift", "auto", "--drift-window", "2", "--drift-trips",
               "2", "--drift-probe-successes", "2", "--drift-parity",
               str(DRIFT_PARITY), "--openset", "auto")
# the open-set gate's calibration rows, in drifting populations: the
# first three ticks fill them (the first holds fewer active rows). A flow's
# first poll yields degenerate features (one sample, no deltas yet), so a
# gate armed on the first tick alone rejects every later, ordinary row
OPENSET_CAL_TICKS = 2
OPENSET_TIE_RTOL = 1e-5  # float32 scores against the float64 threshold
PLAIN_SLICE = 4096  # rows per call of a depth-10 forest's plain version
DRIFT_EMITTER = """\
import os, sys, time
sys.path.insert(0, sys.argv[1])
from chip_smoke import DriftStream
base, novel, flag = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
shift_at, pause, cap, after = (int(sys.argv[5]), float(sys.argv[6]),
                               int(sys.argv[7]), int(sys.argv[8]))
stream = DriftStream(base, novel)
out = sys.stdout.buffer
out.write(b"loading app simple_monitor_13.py\\n")
left = None
for k in range(cap):
    if k == shift_at:
        stream.shift()
    if left is None and os.path.exists(flag):
        left = after
    out.write(stream.tick_bytes(novel=left is not None))
    out.flush()
    if left is not None:
        left -= 1
        if left == 0:
            break
    time.sleep(pause)
"""


def plain_forest_proba(k, X):
    """The forest's plain-version probabilities in ``PLAIN_SLICE``-row
    calls (its GEMM form holds (rows, trees · internal nodes) matrices,
    which a depth-10 forest makes large); every step of it is exact per
    row, so the slices change no bit."""
    import torch

    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk

    return torch.cat([fk.forest_proba_plain(k, X[i:i + PLAIN_SLICE])
                      for i in range(0, X.shape[0], PLAIN_SLICE)])


def openset_relabel(labels: np.ndarray, X: np.ndarray, ref: dict | None,
                    unknown: int) -> np.ndarray:
    """``labels`` with the open-set gate's float64 host rule applied for
    the armed reference ``ref`` (None: calibrating, nothing rejected)."""
    from traffic_classifier_sdn_tpu_torch.serving.openset import (
        openset_scores,
    )

    if ref is None:
        return labels
    X = np.asarray(X, np.float64)
    scores = openset_scores(X, ref["openset_mean"], ref["openset_inv_std"])
    rej = X.any(axis=1) & (scores > float(ref["openset_threshold"]))
    return np.where(rej, unknown, labels)


@contextlib.contextmanager
def watched_drift():
    """While active, the drift loop's objects a serve builds are kept
    (``seen["gate"]``, ``["controller"]``, ``["openset"]``), and every
    refit is timed: ``seen["fits"]`` holds ``(seconds, params, end)`` per
    ``retrain.fit_family`` call, ``end`` on the monotonic clock."""
    from traffic_classifier_sdn_tpu_torch.serving import drift, openset
    from traffic_classifier_sdn_tpu_torch.serving import retrain

    seen: dict = {"fits": []}
    patched = []

    def keep(cls, name):
        init = cls.__init__

        def wrapped(self, *a, **kw):
            init(self, *a, **kw)
            seen[name] = self

        patched.append((cls, init))
        cls.__init__ = wrapped

    keep(drift.DriftGate, "gate")
    keep(drift.DriftController, "controller")
    keep(openset.OpenSetGate, "openset")
    fit = retrain.fit_family

    def timed(*a, **kw):
        import torch

        t0 = time.perf_counter()
        params = fit(*a, **kw)
        if next(params.buffers()).is_cuda:
            torch.cuda.synchronize()
        seen["fits"].append((time.perf_counter() - t0, params,
                             time.monotonic()))
        return params

    retrain.fit_family = timed
    try:
        yield seen
    finally:
        retrain.fit_family = fit
        for cls, init in patched:
            cls.__init__ = init


def _drift_serve(tag: str, ckpt: str, tmp: str, novel: int, counter: str,
                 plan=None):
    """One no-flag forest serve of the drifting stream (``--source ryu``
    over ``DRIFT_EMITTER``) with ``DRIFT_FLAGS`` and ``--obs-port 0``. A
    watcher touches the emitter's flag once the ``counter`` metric
    (``promotions`` or ``rollbacks``) counts one, and scrapes ``/healthz``
    meanwhile. Returns (stdout, summary, wall s, features, log, per-render
    state, seen, watcher record)."""
    import threading

    from traffic_classifier_sdn_tpu_torch.utils import faults
    from traffic_classifier_sdn_tpu_torch.utils.metrics import global_metrics

    root = os.path.dirname(os.path.abspath(__file__))
    emitter = os.path.join(tmp, "drift_emit.py")
    flag = os.path.join(tmp, f"{counter}.flag")
    with open(emitter, "w") as f:
        f.write(DRIFT_EMITTER)
    states: dict = {}
    watch: dict = {"healthz": None, "flagged_at": None}
    done = threading.Event()

    with watched_drift() as seen:
        def before(k):
            # what render k serves with: the swapped model or the boot one,
            # and the open-set gate's armed reference
            states[k] = (seen["gate"].swapped,
                         seen["openset"].reference_arrays())

        def watcher():
            while not done.is_set():
                if (watch["flagged_at"] is None
                        and global_metrics.counters.get(counter, 0)):
                    watch["flagged_at"] = len(log)
                    watch["flagged_t"] = time.monotonic()
                    open(flag, "w").close()
                port = int(global_metrics.gauges.get("obs_port", 0))
                if port:
                    try:
                        status, body = _get(port, "/healthz")
                    except OSError:  # the serve's plane stopping under it
                        status, body = 0, b"{}"
                    body = json.loads(body)
                    if status == 200 and "drift" in body:
                        watch["healthz"] = body
                done.wait(0.1)

        with watched_dispatch("forest", before) as (features, log):
            thread = threading.Thread(target=watcher, daemon=True)
            ctx = (faults.installed(plan) if plan is not None
                   else contextlib.nullcontext())
            try:
                with ctx:
                    thread.start()
                    out, summary, wall = _serve([
                        "Randomforest", "--source", "ryu", "--monitor-cmd",
                        f"{sys.executable} {emitter} {root} {DRIFT_BASE} "
                        f"{novel} {flag} {DRIFT_SHIFT_AT} {DRIFT_PAUSE} "
                        f"{DRIFT_MAX_TICKS} {DRIFT_AFTER_TICKS}",
                        "--capacity", str(CAPACITY), "--print-every", "1",
                        "--native-checkpoint", ckpt,
                        "--drift-dir", os.path.join(tmp, f"rotation-{counter}"),
                        "--obs-port", "0", *DRIFT_FLAGS,
                        "--openset-calibration-rows",
                        str(OPENSET_CAL_TICKS * DRIFT_BASE),
                    ])
            finally:
                done.set()
                thread.join(timeout=10)
    if watch["flagged_at"] is None:
        events = [e for e in seen["controller"]._recorder.tail()
                  if e["kind"].startswith(("drift.", "openset.calibrated"))]
        print(f"{tag} events: {events[-40:]}; open-set {summary.openset}")
        raise AssertionError(f"{tag} no {counter[:-1]} in "
                             f"{DRIFT_MAX_TICKS} ticks: {summary.drift}")
    print(f"{tag} {summary.ticks} polls in {wall:.2f} s (ticks paced "
          f"{DRIFT_PAUSE} s apart, rates x{DRIFT_FACTOR} from tick "
          f"{DRIFT_SHIFT_AT + 1}); host stage per tick (s): "
          + ", ".join(f"{x:.3f}" for x in summary.tick_seconds))
    return out, summary, wall, features, log, states, seen, watch


def _check_drift_tables(tag: str, tables: list, features: list, log: list,
                        states: dict, ops: dict) -> tuple[int, int]:
    """Every printed table's labels: the plain forest's (the boot stacks
    before the swap, the promoted ones after) on the table its render was
    dispatched against, with the open-set relabel of the reference armed
    at that render. Returns (tables after the swap, unknown rows shown)."""
    printed = [k for what, k, *_ in log if what == "rows"]
    if len(printed) != len(tables):
        raise AssertionError(f"{tag} {len(tables)} tables printed, "
                             f"{len(printed)} renders ran")
    names = CLASSES + ("unknown",)
    after = unknown = 0
    for table, k in zip(tables, printed):
        swapped, ref = states[k]
        X = features[k]
        want = plain_forest_proba(ops[swapped], X).argmax(-1).cpu().numpy()
        want = openset_relabel(want, X.cpu().numpy(), ref, len(CLASSES))
        wrong = [(s, lab) for s, lab in table if names[want[s]] != lab]
        # the first polls' rows are not active yet (one sample, no deltas):
        # their tables may hold fewer rows
        if wrong or (swapped and len(table) != 64):
            raise AssertionError(f"{tag} render {k + 1} ({len(table)} rows, "
                                 f"swapped {swapped}): labels differing from "
                                 f"the plain forest's: {wrong[:5]}")
        after += int(swapped)
        unknown += sum(1 for _, lab in table if lab == "unknown")
    return after, unknown


def phase_drift(model: dict, k, device) -> int:
    """The drift loop and open-set rejection on the flagship serve: the
    seeded 100-tree forest, no flag turned off, ``DRIFT_FLAGS``, 65,536
    flows (``DRIFT_BASE`` drifting conversations, then ``DRIFT_NOVEL``
    novel ones) as raw pipe bytes. Checks: PROMOTED, the refit on the card
    under ``--retrain-deadline``, every table against the plain forest of
    its model with the open-set relabel, the promoted forest's kernel
    bitwise at 65,536 rows, the gate's card labels against the float64
    scores, the novel window's rejections, and a ``promote.swap`` drill
    that rolls back with the boot model on every table. Returns the forest
    kernel's launches in the promotion serve and the promoted forest's
    kernel numbers."""
    import torch

    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.io import checkpoint
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk
    from traffic_classifier_sdn_tpu_torch.serving import openset as tos
    from traffic_classifier_sdn_tpu_torch.serving import retrain
    from traffic_classifier_sdn_tpu_torch.utils import faults

    tag = "[drift Randomforest]"
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        checkpoint.save_model(ckpt, "forest",
                              interop.forest_params_from_numpy(model, device),
                              classes=CLASSES)
        fk.forest_proba.launches = 0
        out, summary, wall, features, log, states, seen, watch = \
            _drift_serve(tag, ckpt, tmp, DRIFT_NOVEL, "promotions")
        launches = fk.forest_proba.launches
        st, ost = summary.drift, summary.openset
        fits = [f for f in seen["fits"] if f[2] <= watch["flagged_t"]]
        fit_s, params, _ = fits[-1]
        deadline = 300.0  # --retrain-deadline's default
        print(f"{tag} drift {st['state']}: {st['retrain_runs']} refit(s), "
              f"{st['promotions']} promotion(s), {st['rollbacks']} "
              f"rollbacks; the promoted refit took {fit_s:.3f} s on the card "
              f"(deadline {deadline} s); PROMOTED at render "
              f"{watch['flagged_at']}")
        if st["promotions"] != 1 or not st["swapped"]:
            raise AssertionError(f"{tag} not promoted: {st}")
        if not 0 < fit_s < deadline or not all(
                b.device.type == device.type for b in params.buffers()):
            raise AssertionError(f"{tag} the refit took {fit_s} s or left "
                                 "the card")
        probes = [e for e in seen["controller"]._recorder.tail()
                  if e["kind"] == "drift.probe"]
        print(f"{tag} drift.probe events (parity floor {DRIFT_PARITY}): "
              + ", ".join(f"{e['detail']} ok={e['ok']}" for e in probes))
        if not probes or not probes[-1]["ok"]:
            raise AssertionError(f"{tag} probes {probes}")
        pk = fk.compile_forest(params.node_arrays(), n_features=N_FEATURES,
                               device=device)
        print(f"{tag} promoted forest: {params.left.shape[0]} trees, "
              f"{pk.n_internal} internal + {pk.n_leaves} leaf slots, "
              f"{pk.blob_words * 4} bytes a tree, trees per stage "
              f"{pk.per_chunk}")
        after, unknown = _check_drift_tables(
            tag, parse_tables(out), features, log, states,
            {False: k, True: pk})
        if after == 0:
            raise AssertionError(f"{tag} no table printed after the swap")
        # the promoted forest's kernel against its plain version
        X = features[-1]
        got = fk.forest_proba(pk, X)
        want = plain_forest_proba(pk, X)
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"{tag} promoted kernel differs, {err}")
        ms = cuda_median_ms(lambda: fk.forest_proba(pk, X), 10)
        boot_ms = cuda_median_ms(lambda: fk.forest_proba(k, X), 10)
        plain_ms = cuda_median_ms(lambda: plain_forest_proba(pk, X), 2, 1)
        promoted = {"rows": int(X.shape[0]), "ms": round(ms, 4),
                    "plain_ms": round(plain_ms, 4),
                    "boot_ms": round(boot_ms, 4), "max_abs_err": err,
                    "trees": int(params.left.shape[0]),
                    "internal": pk.n_internal, "leaves": pk.n_leaves,
                    "fit_s": round(fit_s, 3)}
        print(f"{tag} promoted forest kernel bitwise equal to its plain "
              f"version at {X.shape[0]} rows: {ms:.4f} ms (plain "
              f"{plain_ms:.2f} ms; the boot forest {boot_ms:.4f} ms on the "
              "same rows)")
        # the gate's card path (float32 torch) against float64 scores
        ref = states[max(states)][1]
        gate = tos.OpenSetGate(lambda _p, Xc: fk.predict(pk, Xc),
                               n_classes=N_CLASSES, reference=ref)
        card = gate(None, X).cpu().numpy()
        Xh = X.cpu().numpy().astype(np.float64)
        scores = tos.openset_scores(Xh, ref["openset_mean"],
                                    ref["openset_inv_std"])
        thr = float(ref["openset_threshold"])
        ties = np.abs(scores - thr) <= OPENSET_TIE_RTOL * thr
        mean32, inv32, _ = gate.device_stats(X.device)
        s32 = tos.openset_scores_f32(X, mean32, inv32).cpu().numpy()
        active = Xh.any(axis=1)
        rel = float(np.max(np.abs(s32[active] - scores[active])
                           / np.maximum(scores[active], 1e-30)))
        host = openset_relabel(want.argmax(-1).cpu().numpy(), Xh, ref,
                               N_CLASSES)
        bad = np.nonzero((card != host) & ~ties)[0]
        if bad.size:
            raise AssertionError(f"{tag} card open-set labels differ on "
                                 f"rows {bad[:5].tolist()}")
        # the novel window: the novel conversations' rows in the last table
        novel_rows = [s for s, (src, _) in
                      summary.engine.slot_metadata().items()
                      if int(src.replace(":", ""), 16) // 2 >= DRIFT_BASE]
        rejected = int((host[novel_rows] == N_CLASSES).sum())
        print(f"{tag} open-set {ost['state']} at threshold "
              f"{ost['threshold']}: card labels equal the float64 rule on "
              f"{X.shape[0] - int(ties.sum())} rows ({int(ties.sum())} "
              f"within {OPENSET_TIE_RTOL} of the threshold; the card's "
              f"float32 scores are within {rel:.3g} relative of the float64 "
              f"ones on active rows); novel window: "
              f"{rejected} of {len(novel_rows)} novel conversations' rows "
              f"unknown, {ost['last_rejected']} rows rejected in the last "
              f"tick, {unknown} unknown rows in the printed tables, "
              f"{ost['rejections']} rejections in all")
        if len(novel_rows) != DRIFT_NOVEL or rejected < DRIFT_NOVEL // 2:
            raise AssertionError(f"{tag} novel rows {len(novel_rows)}, "
                                 f"{rejected} rejected")
        health = watch["healthz"]
        if health is None or "openset" not in health:
            raise AssertionError(f"{tag} /healthz without drift/openset")
        print(f"{tag} /healthz drift: {json.dumps(health['drift'])}")
        print(f"{tag} /healthz openset: {json.dumps(health['openset'])}")
        print(f"{tag} {launches} forest launches: {len(probes)} parity "
              f"probes of the candidate and the renders' ({len(features)} "
              f"dispatched, {len(parse_tables(out))} printed, "
              f"{summary.ticks_coalesced} coalesced, label plans "
              f"{summary.render_plans})")

        # the drill: every promotion's swap fails, the boot model serves
        dtag = "[drift drill promote.swap]"
        plan = faults.FaultPlan([faults.FaultRule("promote.swap",
                                                  times=None)])
        dout, dsum, _, dfeat, dlog, dstates, _, _ = _drift_serve(
            dtag, ckpt, tmp, 0, "rollbacks", plan)
        dst = dsum.drift
        if (dst["rollbacks"] != 1 or dst["promotions"] or dst["swapped"]
                or not plan.fires):
            raise AssertionError(f"{dtag} {dst}")
        if any(swapped for swapped, _ in dstates.values()):
            raise AssertionError(f"{dtag} a render served a swapped model")
        rotation = os.path.join(tmp, "rotation-rollbacks")
        latest = retrain.resolve_latest(rotation, device="cpu")
        dtables = parse_tables(dout)
        _check_drift_tables(dtag, dtables, dfeat, dlog, dstates,
                            {False: k})
        print(f"{dtag} ROLLED_BACK after {dst['retrain_runs']} refit(s); "
              f"the rotation resolves to {os.path.basename(latest)}; all "
              f"{len(dtables)} tables equal the boot forest's labels (with "
              "the open-set relabel)")
        if os.path.basename(latest) != "model-000000000":
            raise AssertionError(f"{dtag} rotation resolves to {latest}")
    return launches, promoted


KERNEL_ROWS = {
    "forest": ("forest_proba", "forest_proba.cu",
               "traffic_classifier_sdn_tpu/ops/pallas_forest.py:241"),
    "knn": ("knn_topk", "knn_topk.cu",
            "traffic_classifier_sdn_tpu/ops/pallas_knn.py:116"),
    "svc": ("rbf_decision", "rbf_decision.cu",
            "traffic_classifier_sdn_tpu/ops/pallas_rbf.py:90"),
}


def kernel_entries(results: dict, launches: dict, paths: dict | None = None,
                   buckets: list | None = None, menus: dict | None = None,
                   promoted: dict | None = None) -> list[dict]:
    """The ``{"kernels": [...]}`` entries: each kernel's numbers at the
    main path's 65,536 rows, its launches in the serve, every size under
    ``by_rows``, its launches on each path driven (``paths``: {path:
    {family: launches}}), for the forest each dirty bucket (``buckets``)
    and, under ``menus`` ({family: {...}}), the serving-menu forms timed
    beside the kernel (``phase_knn_tiers``, ``phase_ivf``,
    ``phase_svc_dot``); for the forest, ``promoted``: the drift loop's
    retrained forest through the same kernel (``phase_drift``)."""
    kernels = []
    for family, (name, source, replaces) in KERNEL_ROWS.items():
        by_rows = results[family]
        main_path = by_rows[CAPACITY]
        extra = {"launches_by_path": {
            path: n[family] for path, n in (paths or {}).items()
        }}
        if family == "forest" and buckets:
            extra["by_dirty_bucket"] = buckets
        if menus and family in menus:
            extra["menus"] = menus[family]
        if family == "forest" and promoted:
            extra["promoted"] = promoted
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"traffic_classifier_sdn_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches[family],
            "max_abs_err": max(r["max_abs_err"] for r in by_rows.values()),
            "ms": main_path["ms"],
            "back_to_back_ms": main_path["back_to_back_ms"],
            "plain_ms": main_path["plain_ms"],
            "bound_ms": main_path["bound_ms"],
            "bound_by": main_path["bound_by"],
            "library_ms": None,
            "rows": CAPACITY,
            "by_rows": [by_rows[n] for n in SHAPES],
            **extra,
        })
    return kernels


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    try:
        import traffic_classifier_sdn_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the root of a checkout of the repo "
              "(traffic_classifier_sdn_tpu_torch not found)", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    smi = phase_environment()
    device = torch.device("cuda")
    INSTANCES.update(phase_build())
    models, ops, results = phase_kernels(device)
    buckets = phase_dirty_buckets(ops["forest"], device)
    serial = {
        family: phase_serve(family, models[family], ops[family], device)
        for family in SERVES
    }
    # the main path: the three serves with no flag
    launches = {
        family: phase_default_serve(family, models[family], ops[family],
                                    device)
        for family in SERVES
    }
    paths = {}
    for prefix, counts in (("serve", serial), ("default", launches)):
        for f, n in counts.items():
            paths[f"{prefix} {SERVES[f][0]}"] = {
                g: int(f == g) * n for g in SERVES}
    for f in SERVES:
        n = phase_drills(f, models[f], ops[f], device)
        paths[f"drills {SERVES[f][0]}"] = {g: int(f == g) * n for g in SERVES}
    paths["warmup Randomforest"] = {
        "forest": phase_warmup(models["forest"], ops["forest"], device),
        "knn": 0, "svc": 0}
    paths["incremental Randomforest"] = {
        "forest": phase_incremental_serve(models["forest"], ops["forest"],
                                          device),
        "knn": 0, "svc": 0}
    paths["ryu Randomforest"] = {
        "forest": phase_ryu_serve(models["forest"], ops["forest"], device),
        "knn": 0, "svc": 0}
    paths["2^20 Randomforest"] = {
        "forest": phase_big_serve(models["forest"], ops["forest"], device),
        "knn": 0, "svc": 0}
    paths["fanin Randomforest"] = {
        "forest": phase_fanin(models["forest"], ops["forest"], device),
        "knn": 0, "svc": 0}
    phase_families(models, device)
    paths["families"] = {"forest": 0, "knn": 0, "svc": 0}
    menus = {
        "knn": {"tiers_ms": phase_knn_tiers(models["knn"], ops["knn"], device),
                "ivf": phase_ivf(models["knn"], ops["knn"], device)},
        "svc": {"dot_form": phase_svc_dot(models["svc"], ops["svc"], device)},
    }
    paths.update(phase_menu_serves(models, ops, device))
    for name, phase in (("controller", phase_controller),
                        ("workload", phase_workload)):
        paths[f"{name} Randomforest"] = {
            "forest": phase(models["forest"], ops["forest"], device),
            "knn": 0, "svc": 0}
    for name, phase in (("obs", phase_obs), ("checkpoint", phase_checkpoint)):
        paths[f"{name} Randomforest"] = {
            "forest": phase(models["forest"], ops["forest"], device),
            "knn": 0, "svc": 0}
    n, promoted = phase_drift(models["forest"], ops["forest"], device)
    paths["drift Randomforest"] = {"forest": n, "knn": 0, "svc": 0}
    phase_ingest_breakdown(ops["forest"], device)
    kernels = kernel_entries(results, launches, paths, buckets, menus,
                             promoted)
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
