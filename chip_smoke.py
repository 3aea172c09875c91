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

    def __init__(self, read, k: int, counter, log: list):
        self._read, self._k, self._counter, self._log = read, k, counter, log
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
        return self._watch("rows", self._read.rows)


@contextlib.contextmanager
def watched_dispatch(family: str):
    """While active, every render the pipelined serve dispatches records
    the feature matrix of the table it was dispatched against
    (``features``, by dispatch index: ``engine.features()`` is a fresh
    tensor, so later ticks do not change it) and its device-stage work
    (``log``, see ``_WatchedRead``; a family without a kernel logs no
    launches)."""
    from traffic_classifier_sdn_tpu_torch.serving import pipeline

    counter = _kernels().get(family, (None,))[0]
    features, log = [], []
    dispatch = pipeline.dispatch_read

    def watched(engine, *args, **kw):
        features.append(engine.features())
        read = dispatch(engine, *args, **kw)
        return _WatchedRead(read, len(features) - 1, counter, log)

    pipeline.dispatch_read = watched
    try:
        yield features, log
    finally:
        pipeline.dispatch_read = dispatch


def _check_printed(tag: str, tables: list, family: str, g, features: list,
                   log: list, rows: int | None = 64) -> list[int]:
    """Every printed table's labels equal the plain version's on the table
    its render was dispatched against; returns the printed dispatches."""
    printed = [k for what, k, *_ in log if what == "rows"]
    if len(printed) != len(tables):
        raise AssertionError(f"{tag} {len(tables)} tables printed, "
                             f"{len(printed)} renders ran")
    for table, k in zip(tables, printed):
        want = _plain_labels(family, g, features[k]).cpu()
        wrong = [(s, lab) for s, lab in table if CLASSES[want[s]] != lab]
        if wrong or (rows is not None and len(table) != rows):
            raise AssertionError(
                f"{tag} render {k + 1}: {len(table)} rows, labels differing "
                f"from the plain version's: {wrong[:5]}")
    return printed


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
    names = family_classes(family)
    printed = [k for what, k, *_ in log if what == "rows"]
    if len(printed) != len(tables):
        raise AssertionError(f"{tag} {len(tables)} tables printed, "
                             f"{len(printed)} renders ran")
    ties = 0
    for table, k in zip(tables, printed):
        X = features[k].cpu()
        want = cpu_model.predict(X).numpy()
        wrong = np.asarray([s for s, lab in table if names[want[s]] != lab],
                           np.int64)
        near = near_ties(family, model, None, X, None, wrong)
        ties += int(near.sum())
        if not near.all() or (rows is not None and len(table) != rows):
            raise AssertionError(
                f"{tag} render {k + 1}: {len(table)} rows, labels differing "
                f"from the CPU's off near-ties at {wrong[~near][:5].tolist()}")
    return ties


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
                    "--max-ticks", "6", "--print-every", "2",
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

KERNEL_ROWS = {
    "forest": ("forest_proba", "forest_proba.cu",
               "traffic_classifier_sdn_tpu/ops/pallas_forest.py:241"),
    "knn": ("knn_topk", "knn_topk.cu",
            "traffic_classifier_sdn_tpu/ops/pallas_knn.py:116"),
    "svc": ("rbf_decision", "rbf_decision.cu",
            "traffic_classifier_sdn_tpu/ops/pallas_rbf.py:90"),
}


def kernel_entries(results: dict, launches: dict, paths: dict | None = None,
                   buckets: list | None = None) -> list[dict]:
    """The ``{"kernels": [...]}`` entries: each kernel's numbers at the
    main path's 65,536 rows, its launches in the serve, every size under
    ``by_rows``, its launches on each path driven (``paths``: {path:
    {family: launches}}) and, for the forest, each dirty bucket
    (``buckets``)."""
    kernels = []
    for family, (name, source, replaces) in KERNEL_ROWS.items():
        by_rows = results[family]
        main_path = by_rows[CAPACITY]
        extra = {"launches_by_path": {
            path: n[family] for path, n in (paths or {}).items()
        }}
        if family == "forest" and buckets:
            extra["by_dirty_bucket"] = buckets
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
    phase_ingest_breakdown(ops["forest"], device)
    kernels = kernel_entries(results, launches, paths, buckets)
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
