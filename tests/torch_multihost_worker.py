"""One rank of the port's two-rank multi-host run: the twin of
``tests/multihost_worker.py``, over ``torch.distributed`` (gloo).

Each rank joins the group through ``parallel/mesh.py:init_distributed``,
lists ``--shards-per-rank`` shards on its one device (the port's
counterpart of JAX's two virtual CPU devices a process), and runs JAX's
four checks on the global mesh, every shard owned by one rank:

1. a batch-sharded logreg predict (``parallel/predict.data_parallel``);
2. a cross-process sum of the row count (``mesh.shard_sum``, the psum);
3. the corpus-sharded KNN with the all_gather merge
   (``knn_sharded.sharded_predict``, and ``fused_predict``, whose local
   stage is the KNN kernel);
4. the sharded serving table (``table_sharded.ShardedFlowEngine``): the
   same records ingested on every rank, the render merged across ranks;

and every other function the JAX package runs under ``shard_map``:

5. the KNN ring and tournament merges (``mesh.permute`` hops), with the
   torch and the kernel local stage, each call's bytes and ms recorded;
6. the tree-sharded forest, gather and GEMM forms, over the state axis;
7. the SV-sharded SVC, torch and kernel (RBF) local stages;
8. ``train/distributed.py``'s four fits over the data axis (the SVC's
   pairs over the state axis) and a Lloyd run from given centers, each
   fit's seconds and the forest's draws made on this rank recorded;
9. the data-parallel Adam step (``train/logreg.make_sgd(mesh=...)``) over
   the data axis on the fit rows, ``SGD_STEPS`` steps, each step's loss
   and the state after the last.

Each result is held to a single-device reference computed locally where
the sharded function equals it bitwise, as JAX's worker does, then
written to ``--out``; the caller holds every rank's results bitwise to
the one-process mesh of the same shard count (``run_checks`` on a mesh of
one process). The inputs are JAX's worker's, seeded, with seeded models
and fit rows beside them (``seeded_inputs``), or a directory that
``save_inputs`` wrote (``--inputs``: chip_smoke.py's multihost phase at
full size). ``--fit-draws`` hands the forest fit recorded draws (an npz
of ``w<t>`` and ``s<t>_<level>`` arrays), as the CPU test does with
JAX's.

Usage::

    torch_multihost_worker.py <init_method or host:port> <process_id>
        <num_processes> [--device cpu|cuda] [--shards-per-rank 2]
        [--out results.npz] [--inputs DIR] [--fit-draws FILE]
        [--timeout S]

It runs on the card unless ``--device cpu`` is given, and prints
``MULTIHOST OK pid={i} devices={n}`` when every check passed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# before torch starts: gloo finds its interface from the host name, which
# a machine with no network may not resolve; the tests run many ranks at
# once
os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
os.environ.setdefault("OMP_NUM_THREADS", "1")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

IDLE_SECONDS = 3600  # JAX's worker's eviction horizon: nothing is idle


def _records(n: int) -> list:
    from traffic_classifier_sdn_tpu_torch.ingest.protocol import (
        TelemetryRecord,
    )

    return [
        TelemetryRecord(
            time=2, datapath="1", in_port=1, eth_src=f"s{i:02d}",
            eth_dst=f"d{i:02d}", out_port=2, packets=10 + i,
            bytes=1000 + 137 * i,
        )
        for i in range(n)
    ]


def fit_blobs(seed: int, n: int, n_classes: int, spread: float = 0.35):
    """(X float32 (n, 12), y int32) of ``tests/test_torch_train.blobs``:
    per-class gamma centers with multiplicative noise."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, n_classes, n)
    centers = rng.gamma(2.0, 300.0, (n_classes, 12))
    X = np.abs(centers[y] * (1 + spread * rng.randn(n, 12)))
    return X.astype(np.float32), y.astype(np.int32)


def seeded_inputs(n_devices: int) -> dict:
    """JAX's worker's inputs, drawn in its order from ``RandomState(0)``:
    X (64, 12), the logreg parameters, a KNN corpus of 8 rows a device
    (k = 5, queries X[:16]), and a table of ``3 * n_devices`` records in
    one tick at time 2, labelled by ``label_fn``, 5 render rows. Beside
    them, on X: a seeded 13-tree forest and 1,200-SV SVC
    (``chip_smoke.random_forest``/``random_svc``, seed 1), and the fits'
    rows: 101 rows of 4 blobs (seed 6; not a multiple of the shards, so
    padding and trimming run), 64 held-out rows (seed 7) and small fit
    settings."""
    import chip_smoke

    rng = np.random.RandomState(0)
    X = np.abs(rng.gamma(1.5, 200.0, (64, 12))).astype(np.float32)
    logreg = {"coef": rng.randn(6, 12).astype(np.float32),
              "intercept": rng.randn(6).astype(np.float32)}
    knn = {"fit_X": rng.rand(8 * n_devices, 12) * 100.0,
           "y": rng.randint(0, 6, 8 * n_devices).astype(np.int32),
           "n_neighbors": 5, "classes": np.arange(6)}
    forest = chip_smoke.random_forest(1, X, n_trees=13, node_count=(15, 63),
                                      max_depth=6)
    X_fit, y_fit = fit_blobs(6, 101, 4)
    X_test, y_test = fit_blobs(7, 64, 4)
    return {"X": X, "logreg": logreg, "knn": knn, "knn_queries": X[:16],
            "forest": None, "capacity": 8 * n_devices, "table_rows": 5,
            "native": False, "incremental": False,
            "ticks": [_records(3 * n_devices)],
            "state_forest": forest,
            "svc": chip_smoke.random_svc(1, X, n_sv=1200),
            "fit": {"X": X_fit, "y": y_fit, "X_test": X_test,
                    "y_test": y_test, "n_classes": 4, "draws": None,
                    "kw": {"kmeans": {"k": 4, "n_init": 2, "n_iter": 10,
                                      "seed": 5},
                           "forest": {"n_trees": 3, "max_depth": 4,
                                      "n_bins": 16, "seed": 2},
                           "svc": {"n_iters": 100}}}}


def save_inputs(path: str, X, models: dict, ticks: list, capacity: int,
                table_rows: int, fit: dict) -> None:
    """Write the inputs of a full-size run to the directory ``path``:
    queries ``X`` (of every state-sharded predict), the importer dicts of
    ``models`` (``logreg``, ``knn``, ``forest``: the table's predict and
    the tree-sharded forest, ``svc``), the table's capture as one file
    of raw telemetry bytes a tick (``ticks``: their paths), served by the
    native engine with incremental labels and the forest's kernel as the
    predict, and the fits' rows (``fit``: ``X``, ``y``, ``X_test``,
    ``y_test`` arrays, ``n_classes`` and the per-family ``kw``)."""
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "X.npy"), np.asarray(X, np.float32))
    for name in ("logreg", "knn", "forest", "svc"):
        np.savez(os.path.join(path, f"{name}.npz"), **models[name])
    np.savez(os.path.join(path, "fit.npz"),
             **{k: fit[k] for k in ("X", "y", "X_test", "y_test")})
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"ticks": list(ticks), "capacity": capacity,
                   "table_rows": table_rows, "n_classes": fit["n_classes"],
                   "fit_kw": fit["kw"]}, f)


def load_inputs(path: str) -> dict:
    """The inputs ``save_inputs`` wrote."""
    def arrays(name):
        with np.load(os.path.join(path, f"{name}.npz")) as z:
            return {k: z[k] for k in z.files}

    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    ticks = []
    for p in meta["ticks"]:
        with open(p, "rb") as f:
            ticks.append(f.read())
    X = np.load(os.path.join(path, "X.npy"))
    knn = arrays("knn")
    knn["n_neighbors"] = int(knn["n_neighbors"])
    forest = arrays("forest")
    return {"X": X, "logreg": arrays("logreg"), "knn": knn,
            "knn_queries": X, "forest": forest,
            "capacity": meta["capacity"], "table_rows": meta["table_rows"],
            "native": True, "incremental": True, "ticks": ticks,
            "state_forest": forest, "svc": arrays("svc"),
            "fit": {**arrays("fit"), "n_classes": meta["n_classes"],
                    "kw": meta["fit_kw"], "draws": None}}


def save_draws(path: str, draws: list) -> None:
    """Recorded forest draws, ``[(weights, [scores per level]), ...]`` a
    tree, to the npz ``--fit-draws`` reads."""
    arrays = {}
    for t, (w, scores) in enumerate(draws):
        arrays[f"w{t}"] = np.asarray(w, np.float32)
        for d, sc in enumerate(scores):
            arrays[f"s{t}_{d}"] = np.asarray(sc, np.float32)
    np.savez(path, **arrays)


def load_draws(path: str) -> list:
    """The draws ``save_draws`` wrote."""
    with np.load(path) as z:
        n_trees = sum(1 for k in z.files if k.startswith("w"))
        return [(z[f"w{t}"], [z[f"s{t}_{d}"] for d in range(sum(
            1 for k in z.files if k.startswith(f"s{t}_")))])
                for t in range(n_trees)]


def label_fn(_p, Xt):
    """JAX's worker's table predict: the row sum, truncated, mod 6."""
    import torch

    return (torch.sum(Xt, dim=1).to(torch.int32) % 6).to(torch.int32)


def _table_predict(inp: dict, device):
    """``(predict_fn, params)`` of the table: the forest kernel's predict
    on a full-size run, else ``label_fn``."""
    if inp["forest"] is None:
        return label_fn, None
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk

    return fk.predict, fk.compile_forest(inp["forest"], n_features=12,
                                         device=device)


def _feed(eng, tick) -> None:
    eng.mark_tick()
    if isinstance(tick, bytes):
        eng.ingest_bytes(tick)
    else:
        eng.ingest(tick)


MERGE_CALLS = 3  # fused calls of each ring and tournament merge timed


def hop_blocks(owners: list, rank: int) -> dict:
    """The (N, k) blocks ``rank`` sends, and receives, in one call of
    each point-to-point merge over state shards owned by ``owners`` (a
    rank per shard): the ring's D − 1 hops i → i+1 and the tournament's
    rounds i^d → i, counting only the hops that cross ranks."""
    n = len(owners)
    ring = (n - 1) * sum(owners[i] == rank != owners[(i + 1) % n]
                         for i in range(n))
    tournament, d = 0, 1
    while d < n:
        tournament += sum(owners[i ^ d] == rank != owners[i]
                          for i in range(n))
        d <<= 1
    return {"ring": ring, "tournament": tournament}


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _exchanged(fn, device) -> tuple:
    """``fn()`` and what it moved: ``(result, {"bytes_sent",
    "bytes_received", "exchange_ms", "ms", "calls"})`` from
    ``mesh.EXCHANGE_STATS`` and the host clock, the device synced."""
    from traffic_classifier_sdn_tpu_torch.parallel import mesh as meshlib

    stats = meshlib.EXCHANGE_STATS
    before = dict(stats)
    t0 = time.perf_counter()
    got = fn()
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    return got, {"bytes_sent": stats["bytes_sent"] - before["bytes_sent"],
                 "bytes_received": (stats["bytes_received"]
                                    - before["bytes_received"]),
                 "exchange_ms": (stats["seconds"] - before["seconds"]) * 1e3,
                 "calls": stats["calls"] - before["calls"], "ms": ms}


def _knn_merges(inp: dict, smesh, device, out: dict, timings: dict) -> None:
    """The ring and tournament merges, torch and kernel local stages; for
    each fused merge ``MERGE_CALLS`` calls, their exchange bytes and ms
    and the KNN kernel's launches."""
    import torch

    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.ops import knn_kernel as kk
    from traffic_classifier_sdn_tpu_torch.parallel import knn_sharded as ksh
    from traffic_classifier_sdn_tpu_torch.parallel import mesh as meshlib

    dpad = ksh.pad_corpus(dict(inp["knn"]), smesh.shape[meshlib.STATE_AXIS])
    kp = interop.knn_params_from_numpy(dpad, device)
    mask = dpad.get("pad_mask")
    Xq = torch.from_numpy(inp["knn_queries"]).to(device)
    for merge in ("ring", "tournament"):
        build = getattr(ksh, f"{merge}_predict")
        out[f"knn_{merge}_labels"] = build(
            smesh, kp, pad_mask=mask)(Xq).cpu().numpy()
        fn = ksh.fused_predict(smesh, kp, pad_mask=mask, merge=merge)
        n0 = kk.topk_sim_idx.launches
        calls = [_exchanged(lambda: fn(Xq).cpu().numpy(), device)
                 for _ in range(MERGE_CALLS)]
        for got, _ in calls[1:]:
            if not np.array_equal(got, calls[0][0]):
                raise AssertionError(f"fused {merge}: calls disagree")
        out[f"knn_fused_{merge}_labels"] = calls[0][0]
        timings["merges"][merge] = {
            "calls": [c[1] for c in calls],
            "launches": kk.topk_sim_idx.launches - n0,
            "rows": int(Xq.shape[0]), "k": int(kp.n_neighbors)}


def _state_sharded(inp: dict, smesh, device, out: dict,
                   timings: dict) -> None:
    """The tree-sharded forest (gather and GEMM forms) and the SV-sharded
    SVC (torch and RBF kernel local stages) over the state axis, on the
    queries ``X``; the RBF kernel's launches in the fused call."""
    import torch

    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.ops import rbf_kernel as rk
    from traffic_classifier_sdn_tpu_torch.parallel import forest_sharded as fsh
    from traffic_classifier_sdn_tpu_torch.parallel import mesh as meshlib
    from traffic_classifier_sdn_tpu_torch.parallel import svc_sharded as ssh

    n_state = smesh.shape[meshlib.STATE_AXIS]
    X = torch.from_numpy(inp["X"]).to(device)
    dpad = fsh.pad_trees(dict(inp["state_forest"]), n_state)
    fp = interop.forest_params_from_numpy(dpad, device)
    out["forest_proba"] = fsh.sharded_proba(
        smesh, fp, dpad.get("n_real_trees"))(X).cpu().numpy()
    out["forest_gemm_proba"] = fsh.gemm_sharded_proba(
        smesh, dpad)(X).cpu().numpy()
    sv = dict(inp["svc"])
    lab, dec = ssh.sharded_decision(smesh, interop.svc_params_from_numpy(
        ssh.pad_support(sv, n_state), device))(X)
    out["svc_labels"], out["svc_decisions"] = (lab.cpu().numpy(),
                                               dec.cpu().numpy())
    fn = ssh.fused_decision(smesh, interop.svc_params_from_numpy(sv, device))
    n0 = rk.partial_decision.launches
    (lab, dec), stats = _exchanged(lambda: fn(X), device)
    timings["svc_fused"] = {**stats,
                            "launches": rk.partial_decision.launches - n0}
    out["svc_fused_labels"], out["svc_fused_decisions"] = (
        lab.cpu().numpy(), dec.cpu().numpy())


def _fits(inp: dict, dmesh, smesh, device, out: dict, timings: dict) -> None:
    """``train/distributed.py``'s four fits on the whole fit rows (every
    rank passes them all): gnb, kmeans and the forest over ``dmesh``, the
    SVC's pairs over ``smesh``; a Lloyd run from the first k rows over
    ``dmesh``. Records each fit's seconds and how many trees' draws this
    rank made (``tree_draws`` calls; recorded draws when the inputs carry
    them)."""
    import torch

    from traffic_classifier_sdn_tpu_torch.parallel import mesh as meshlib
    from traffic_classifier_sdn_tpu_torch.train import distributed as tdist
    from traffic_classifier_sdn_tpu_torch.train import forest as tforest
    from traffic_classifier_sdn_tpu_torch.train import kmeans as tkmeans

    fit, kw = inp["fit"], inp["fit"]["kw"]
    X, y, C = fit["X"], fit["y"], int(fit["n_classes"])
    fit_s = timings["fit_s"]

    def timed(name, call):
        t0 = time.perf_counter()
        model = call()
        _sync(device)
        fit_s[name] = time.perf_counter() - t0
        return model

    g = timed("gnb", lambda: tdist.fit_gnb(dmesh, X, y, C,
                                           **kw.get("gnb", {})))
    for k in ("theta", "inv_var", "log_const"):
        out[f"fit_gnb_{k}"] = getattr(g, k).cpu().numpy()
    km, inertia = timed("kmeans", lambda: tdist.fit_kmeans(
        dmesh, X, **kw["kmeans"]))
    Xd = torch.from_numpy(X).to(device)
    out["fit_kmeans_centers"] = km.centers.cpu().numpy()
    out["fit_kmeans_inertia"] = np.asarray(inertia)
    out["fit_kmeans_labels"] = km.predict(Xd).cpu().numpy()
    n_data = dmesh.shape[meshlib.DATA_AXIS]
    Xt = Xd[: X.shape[0] - X.shape[0] % n_data]
    k = int(kw["kmeans"]["k"])
    centers, _ = tkmeans._lloyd(meshlib.batch_sharded(dmesh, Xt), Xt[:k],
                                int(kw["kmeans"]["n_iter"]), dmesh)
    out["kmeans_lloyd_labels"] = tkmeans._assign(Xt, centers)[0].cpu().numpy()

    draws, real = fit.get("draws"), tforest.tree_draws
    made = []

    def tree_draws(gen, tree, *a, device, **kwargs):
        made.append(tree)
        if draws is None:
            return real(gen, tree, *a, device=device, **kwargs)
        w, scores = draws[tree]
        return (torch.from_numpy(np.asarray(w)).to(device),
                [torch.from_numpy(np.asarray(sc)).to(device)
                 for sc in scores])

    tforest.tree_draws = tree_draws
    try:
        forest = timed("forest", lambda: tdist.fit_forest(
            dmesh, X, y, C, **kw["forest"]))
    finally:
        tforest.tree_draws = real
    timings["tree_draws"] = len(made)
    for k in ("left", "right", "feature", "threshold", "values"):
        out[f"fit_forest_{k}"] = getattr(forest, k).cpu().numpy()
    svc = timed("svc", lambda: tdist.fit_svc(smesh, X, y, C,
                                             **kw.get("svc", {})))
    Xte = torch.from_numpy(np.asarray(fit["X_test"], np.float32)).to(device)
    out["fit_svc_decisions"] = svc.decision_ovo(Xte).cpu().numpy()
    out["fit_svc_labels"] = svc.predict(Xte).cpu().numpy()


SGD_STEPS = 3  # steps of the data-parallel Adam step
SGD_LEAVES = ("coef", "intercept", "count", "mu_coef", "mu_intercept",
              "nu_coef", "nu_intercept")  # SGDState.leaves() order


def _sgd(inp: dict, dmesh, device, out: dict, timings: dict) -> None:
    """``SGD_STEPS`` data-parallel Adam steps (lr 1e-2) over ``dmesh`` on
    the fit rows trimmed to a multiple of the data shards (every rank
    passes them all): each step's loss and the state's leaves after the
    last; the steps' seconds in ``timings["sgd_s"]``."""
    import torch

    from traffic_classifier_sdn_tpu_torch.parallel import mesh as meshlib
    from traffic_classifier_sdn_tpu_torch.train import logreg as tlogreg

    fit = inp["fit"]
    n = fit["X"].shape[0] - fit["X"].shape[0] % dmesh.shape[meshlib.DATA_AXIS]
    X = torch.from_numpy(np.asarray(fit["X"][:n], np.float32)).to(device)
    y = torch.from_numpy(np.asarray(fit["y"][:n], np.int64)).to(device)
    init, step = tlogreg.make_sgd(1e-2, mesh=dmesh)
    state = init(int(fit["n_classes"]), X.shape[1])
    losses = []
    t0 = time.perf_counter()
    for _ in range(SGD_STEPS):
        state, loss = step(state, X, y)
        losses.append(loss.cpu().numpy())
    timings["sgd_s"] = time.perf_counter() - t0
    out["sgd_loss"] = np.stack(losses)
    for name, leaf in zip(SGD_LEAVES, state.leaves()):
        out[f"sgd_{name}"] = leaf.cpu().numpy()


def run_checks(inp: dict, dmesh, smesh, device) -> tuple[dict, dict]:
    """Every check on a data mesh ``dmesh`` and a state mesh ``smesh``
    (one process's, or spanning the group): ``(results, timings)``.
    Results are numpy arrays, the same on every rank; timings are this
    process's host ms and exchanges per table tick, per ring and
    tournament call, of the fused SVC call, and the fits' seconds."""
    import torch

    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.parallel import knn_sharded as ksh
    from traffic_classifier_sdn_tpu_torch.parallel import mesh as meshlib
    from traffic_classifier_sdn_tpu_torch.parallel import predict as ppred
    from traffic_classifier_sdn_tpu_torch.parallel import table_sharded as tsh

    out: dict = {}
    X = torch.from_numpy(inp["X"]).to(device)
    lr = interop.logreg_params_from_numpy(inp["logreg"], device)
    out["logreg_labels"] = ppred.data_parallel(
        dmesh, lambda p, x: p.predict(x))(lr, X).cpu().numpy()

    # the psum: each owned shard's row count, summed over every shard
    xs = ppred.shard_batch(dmesh, X)
    ones = [None if x is None
            else torch.ones_like(x[:, 0], dtype=torch.int64).sum()
            for x in xs]
    out["row_count"] = np.asarray(
        meshlib.shard_sum(ones, dmesh).cpu().numpy())

    n_state = smesh.shape[meshlib.STATE_AXIS]
    dpad = ksh.pad_corpus(dict(inp["knn"]), n_state)
    kp = interop.knn_params_from_numpy(dpad, device)
    Xq = torch.from_numpy(inp["knn_queries"]).to(device)
    mask = dpad.get("pad_mask")
    out["knn_labels"] = ksh.sharded_predict(
        smesh, kp, pad_mask=mask)(Xq).cpu().numpy()
    out["knn_fused_labels"] = ksh.fused_predict(
        smesh, kp, pad_mask=mask)(Xq).cpu().numpy()
    timings: dict = {"host_ms": [], "exchange_bytes": [], "exchange_ms": [],
                     "merges": {}, "fit_s": {}}
    _knn_merges(inp, smesh, device, out, timings)
    _state_sharded(inp, smesh, device, out, timings)
    _fits(inp, dmesh, smesh, device, out, timings)
    _sgd(inp, dmesh, device, out, timings)

    predict_fn, params = _table_predict(inp, device)
    eng = tsh.ShardedFlowEngine(
        dmesh, inp["capacity"], table_rows=inp["table_rows"],
        native=inp["native"], incremental=inp["incremental"])
    eng.install_predict(predict_fn, params)
    rows, counts, evicted = [], [], []
    stats = meshlib.EXCHANGE_STATS
    for tick in inp["ticks"]:
        b0 = stats["bytes_sent"] + stats["bytes_received"]
        s0 = stats["seconds"]
        t0 = time.perf_counter()
        _feed(eng, tick)
        got, ev = eng.tick_render(now=eng.last_time,
                                  idle_seconds=IDLE_SECONDS)
        timings["host_ms"].append((time.perf_counter() - t0) * 1e3)
        timings["exchange_bytes"].append(
            stats["bytes_sent"] + stats["bytes_received"] - b0)
        timings["exchange_ms"].append((stats["seconds"] - s0) * 1e3)
        rows.extend(got)
        counts.append(len(got))
        evicted.append(ev)
    out["render_rows"] = np.asarray(rows, np.int64).reshape(-1, 4)
    out["render_counts"] = np.asarray(counts, np.int64)
    out["evicted"] = np.asarray(evicted, np.int64)
    out["num_flows"] = np.asarray(eng.num_flows(), np.int64)
    return out, timings


def single_device(inp: dict, device) -> dict:
    """The single-device references of JAX's worker, in the port: the
    un-sharded logreg and KNN predicts and a ``FlowStateEngine`` fed the
    same ticks, rendered by ``render_sample`` under the same predict."""
    import torch

    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
    from traffic_classifier_sdn_tpu_torch.ingest.batcher import (
        FlowStateEngine,
    )

    X = torch.from_numpy(inp["X"]).to(device)
    lr = interop.logreg_params_from_numpy(inp["logreg"], device)
    kp = interop.knn_params_from_numpy(inp["knn"], device)
    Xq = torch.from_numpy(inp["knn_queries"]).to(device)
    predict_fn, params = _table_predict(inp, device)
    single = FlowStateEngine(capacity=inp["capacity"], device=device,
                             native=inp["native"])
    rows, evicted = [], []
    for tick in inp["ticks"]:
        _feed(single, tick)
        single.step()
        labels = predict_fn(params, ft.features12(single.table))
        rows.extend(single.render_sample(labels, inp["table_rows"]))
        evicted.append(single.evict_idle(single.last_time, IDLE_SECONDS))
    return {
        "logreg_labels": lr.predict(X).cpu().numpy(),
        "row_count": np.asarray(X.shape[0]),
        "knn_labels": kp.predict(Xq).cpu().numpy(),
        "render_rows": np.asarray(rows, np.int64).reshape(-1, 4),
        "evicted": np.asarray(evicted, np.int64),
    }


KNN_FORMS = ("knn_labels", "knn_fused_labels", "knn_ring_labels",
             "knn_fused_ring_labels", "knn_tournament_labels",
             "knn_fused_tournament_labels")


def check_against(got: dict, want: dict, tag: str) -> None:
    """Every result of ``want`` equal to ``got``'s, bitwise (every KNN
    form, ``KNN_FORMS``, to ``want["knn_labels"]``)."""
    for key, ref in want.items():
        names = KNN_FORMS if key == "knn_labels" else (key,)
        for name in names:
            a = got[name]
            if (a.dtype, a.shape) != (ref.dtype, ref.shape) \
                    or not np.array_equal(a, ref):
                raise AssertionError(f"{tag}: {name} differs from the "
                                     f"single-device reference")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("init", help="init_method URL, or host:port")
    ap.add_argument("process_id", type=int)
    ap.add_argument("num_processes", type=int)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--shards-per-rank", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--inputs", default=None)
    ap.add_argument("--fit-draws", default=None,
                    help="npz of recorded forest draws (save_draws)")
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="s a rank waits for a peer before it fails")
    args = ap.parse_args(argv)
    os.environ["TCSDN_SHARDS_PER_DEVICE"] = str(args.shards_per_rank)

    import torch

    torch.set_num_threads(1)
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk
    from traffic_classifier_sdn_tpu_torch.ops import knn_kernel as kk
    from traffic_classifier_sdn_tpu_torch.ops import rbf_kernel as rk
    from traffic_classifier_sdn_tpu_torch.parallel import mesh as meshlib

    pid, nproc = args.process_id, args.num_processes
    kw = {"num_processes": nproc, "process_id": pid,
          "initialization_timeout": args.timeout, "device": args.device}
    t0 = time.perf_counter()
    if "://" in args.init:
        meshlib.init_distributed(init_method=args.init, **kw)
    else:
        meshlib.init_distributed(args.init, **kw)
    rendezvous_s = time.perf_counter() - t0
    try:
        local = meshlib.local_devices()
        dmesh = meshlib.make_mesh(n_state=1)
        n_devices = dmesh.shape[meshlib.DATA_AXIS]
        assert len(local) == args.shards_per_rank, local
        assert n_devices == args.shards_per_rank * nproc, (n_devices, nproc)
        smesh = meshlib.make_mesh(n_data=1, n_state=n_devices)
        device = local[0]
        inp = (load_inputs(args.inputs) if args.inputs
               else seeded_inputs(n_devices))
        if args.fit_draws:
            inp["fit"]["draws"] = load_draws(args.fit_draws)
        fk.forest_proba.launches = 0
        kk.topk_sim_idx.launches = 0
        rk.partial_decision.launches = 0
        got, timings = run_checks(inp, dmesh, smesh, device)
        launches = {"forest": fk.forest_proba.launches,
                    "knn": kk.topk_sim_idx.launches,
                    "svc": rk.partial_decision.launches}
        check_against(got, single_device(inp, device), f"rank {pid}")
        if args.out:
            np.savez(args.out, **got, meta=np.asarray(json.dumps({
                "pid": pid, "devices": n_devices,
                "local_shards": dmesh.local_shards(meshlib.DATA_AXIS),
                "rendezvous_s": rendezvous_s, "launches": launches,
                **timings})))
        print(f"MULTIHOST OK pid={pid} devices={n_devices}", flush=True)
    finally:
        meshlib.shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
