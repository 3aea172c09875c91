#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``). Phases, one after another; any failure raises and
the script exits non-zero:

1. environment — the card's name and power limit, torch/CUDA versions,
   the TF32 settings;
2. build — every CUDA kernel of the port, from ``csrc/``, all ``nvcc``
   processes started together;
3. kernels against their plain versions on the card — the forest kernel
   on a seeded forest of the reference checkpoint's shape (100 trees,
   node counts 25-101, depth <= 14, 6 classes, 12 features), with X from
   ``features12`` of synthetic flow tables at N = 777, 65,536 and
   1,048,576: probabilities bitwise equal, labels equal, CUDA-event
   median times, and the bound (least time the card could take);
4. serve — the port CLI in-process (``Randomforest --source synthetic
   --synthetic-flows 65536 --capacity 65536 --max-ticks 6 --print-every
   2``) on that forest: 65,536 flows tracked, one kernel launch per render
   tick, 64 rows per rendered table, and the last table's labels equal to
   the plain version's labels on the same table;
5. summary — a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` name and
   power-limit line, and as the last line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

It exits non-zero without printing a result when no CUDA device is
visible, and imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
N_TREES = 100
N_CLASSES = 6
N_FEATURES = 12
NODE_COUNT = (25, 101)  # reference checkpoint: node_count min/max
MAX_DEPTH = 14  # reference checkpoint: max_depth max
CAPACITY = 65536
SHAPES = (777, 65536, 1 << 20)
TIMED_RUNS = 30
CLASSES = ("dns", "game", "ping", "quake", "telnet", "voice")
# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s and
# non-tensor-core float32 operations/s.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12


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
    operation count of the forest kernel), counted with torch ops."""
    import torch

    T, D = k.n_trees, k.n_internal
    nodes = k.nodes.view(T, D, 4)
    trees = torch.arange(T, device=X.device)[None, :]
    total = 0
    for i in range(0, X.shape[0], 1 << 17):
        x = X[i: i + (1 << 17)]
        code = torch.zeros((x.shape[0], T), dtype=torch.int64, device=X.device)
        active = torch.ones_like(code, dtype=torch.bool)
        while bool(active.any()):
            nd = nodes[trees, code.clamp_min(0)]  # (n, T, 4)
            xv = torch.gather(x, 1, nd[..., 0].long())
            nxt = torch.where(
                xv <= nd[..., 1].view(torch.float32), nd[..., 2], nd[..., 3]
            ).long()
            total += int(active.sum())
            code = torch.where(active, nxt, code)
            active &= code >= 0
    return total


def forest_bound(k, X, visits: int) -> tuple[float, str]:
    """(ms, "bytes"|"operations"): the larger of the bytes the function
    must move (X in, (N, C) out, node records and leaf values once) over
    the HBM rate, and its operations (one compare per node visit, C adds
    per tree per row) over the card's float32 rate."""
    N = X.shape[0]
    nbytes = (
        X.numel() * 4 + N * k.n_classes * 4
        + k.nodes.numel() * 4 + k.leaf_values.numel() * 4
    )
    ops = visits + N * k.n_trees * k.n_classes
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


def phase_build() -> None:
    from traffic_classifier_sdn_tpu_torch.ops import cuda_build, forest_kernel

    t0 = time.perf_counter()
    logs = cuda_build.build([forest_kernel.KERNEL])
    print(f"[build] {len(logs)} kernel(s) in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def phase_kernels(device):
    import torch

    from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk

    t0 = time.perf_counter()
    tables = {n: synthetic_table(n, 3, device) for n in (CAPACITY, SHAPES[-1])}
    X_cap = ft.features12(tables[CAPACITY])
    sample = X_cap[torch.randperm(
        CAPACITY, generator=torch.Generator().manual_seed(SEED)
    )[:4096].to(device)].cpu().numpy()
    forest = random_forest(SEED, sample)
    k = fk.compile_forest(forest, n_features=N_FEATURES, device=device)
    print(f"[kernels] forest: {k.n_trees} trees, {k.n_internal} node "
          f"records and {k.n_leaves} leaf slots per tree, depth "
          f"{forest['max_depth']}; tables built in "
          f"{time.perf_counter() - t0:.2f} s")
    results = {}
    for N in SHAPES:
        X = X_cap[:N] if N <= CAPACITY else ft.features12(tables[N])
        got = fk.forest_proba(k, X)
        want = fk.forest_proba_plain(k, X)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(
                f"forest kernel != plain version at N={N}: max |diff| {err}"
            )
        if not torch.equal(got.argmax(-1), want.argmax(-1)):
            raise AssertionError(f"forest kernel labels differ at N={N}")
        visits = node_visits(k, X)
        bound_ms, bound_by = forest_bound(k, X, visits)
        ms = cuda_median_ms(lambda X=X: fk.forest_proba(k, X), TIMED_RUNS)
        plain_ms = cuda_median_ms(
            lambda X=X: fk.forest_proba_plain(k, X), TIMED_RUNS
        )
        results[N] = {
            "rows": N, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "mean_visits_per_tree": visits / (N * k.n_trees),
        }
        print(f"[kernels] forest_proba N={N}: bitwise equal, kernel "
              f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}), {visits / (N * k.n_trees):.2f} visits/tree")
    del tables
    return forest, k, results


def phase_serve(forest, k, device) -> int:
    import torch

    from traffic_classifier_sdn_tpu_torch import cli, interop
    from traffic_classifier_sdn_tpu_torch.io import checkpoint
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk

    with tempfile.TemporaryDirectory() as ckpt:
        checkpoint.save_model(
            ckpt, "forest", interop.forest_params_from_numpy(forest),
            classes=CLASSES,
        )
        argv = [
            "Randomforest", "--source", "synthetic",
            "--synthetic-flows", str(CAPACITY), "--capacity", str(CAPACITY),
            "--max-ticks", "6", "--print-every", "2",
            "--native-checkpoint", ckpt,
        ]
        out = io.StringIO()
        fk.forest_proba.launches = 0  # count the main path's launches only
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            summary = cli.main(argv)
        wall = time.perf_counter() - t0
        launches = fk.forest_proba.launches
    engine = summary.engine
    tables = parse_tables(out.getvalue())
    print(f"[serve] {summary.ticks} ticks in {wall:.2f} s; per tick (s): "
          + ", ".join(f"{s:.3f}" for s in summary.tick_seconds)
          + "; of which ingest (parse, batcher, wire scatter): "
          + ", ".join(f"{s:.3f}" for s in summary.ingest_seconds)
          + f"; render ticks {summary.render_ticks}")
    if engine.num_flows() != CAPACITY:
        raise AssertionError(f"{engine.num_flows()} flows tracked, want {CAPACITY}")
    if launches != len(summary.render_ticks) or launches == 0:
        raise AssertionError(
            f"{launches} kernel launches for {len(summary.render_ticks)} "
            "render ticks (want one each)"
        )
    if len(tables) != len(summary.render_ticks) or any(
        len(t) != 64 for t in tables
    ):
        raise AssertionError(
            f"rendered tables have {[len(t) for t in tables]} rows, want 64 each"
        )
    plain = fk.forest_proba_plain(k, engine.features()).argmax(-1).cpu()
    wrong = [(s, lab) for s, lab in tables[-1] if CLASSES[plain[s]] != lab]
    if wrong:
        raise AssertionError(f"rendered labels differ from the plain version: {wrong[:5]}")
    torch.cuda.synchronize()
    print(f"[serve] {engine.num_flows()} flows tracked, {launches} kernel "
          f"launches over {len(tables)} render ticks, tables of "
          f"{[len(t) for t in tables]} rows, last table's labels equal the "
          "plain version's")
    print("[serve] end of the last table:\n"
          + "\n".join(out.getvalue().splitlines()[-6:]))
    render_breakdown(engine, k, device)
    return launches


def render_breakdown(engine, k, device) -> None:
    """Device time of each step of a render tick on the served table (CUDA
    event medians), the host side of the render, and the wire scatter of
    one synthetic tick — where a tick's time goes outside Python ingest."""
    import torch

    from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
    from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk

    table, n = engine.table, engine.table.capacity
    X = ft.features12(table)
    labels = fk.predict(k, X)
    syn = SyntheticFlows(n_flows=n)
    tick_wire(syn, True)
    wire_np = tick_wire(syn, False)
    wire = ft.wire_tensor(wire_np, device)
    steps = {
        "features12": lambda: ft.features12(table),
        "forest predict (kernel + argmax)": lambda: fk.predict(k, X),
        "top_active_render (64 of the table)": lambda: ft.top_active_render(
            table, labels, 64, engine.tick_floor),
        f"wire to device ({wire_np.shape[0]} x {wire_np.shape[1]})":
            lambda: ft.wire_tensor(wire_np, device),
        f"apply_wire ({wire_np.shape[0]} rows)":
            lambda: ft.apply_wire(table, wire),
    }
    for name, fn in steps.items():
        print(f"[breakdown] {name}: {cuda_median_ms(fn, TIMED_RUNS):.4f} ms")
    t0 = time.perf_counter()
    for _ in range(10):
        engine.render_sample(labels, 64)
    torch.cuda.synchronize(device)
    print(f"[breakdown] render_sample host round trip (ranking, 64 rows to "
          f"the host): {(time.perf_counter() - t0) * 100:.4f} ms")


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
    phase_build()
    forest, k, results = phase_kernels(device)
    launches = phase_serve(forest, k, device)
    main_path = results[CAPACITY]
    kernel = {
        "name": "forest_proba",
        "route": "cuda",
        "source": "traffic_classifier_sdn_tpu_torch/csrc/forest_proba.cu",
        "replaces": "traffic_classifier_sdn_tpu/ops/pallas_forest.py:241",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in results.values()),
        "ms": main_path["ms"],
        "plain_ms": main_path["plain_ms"],
        "bound_ms": main_path["bound_ms"],
        "bound_by": main_path["bound_by"],
        "library_ms": None,
        "rows": CAPACITY,
        "by_rows": [results[n] for n in SHAPES],
    }
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [kernel]}))
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
