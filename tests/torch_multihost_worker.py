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
   same records ingested on every rank, the render merged across ranks.

Each result is held to a single-device reference computed locally, as
JAX's worker does, then written to ``--out``; the caller holds every
rank's results bitwise to the one-process mesh of the same shard count
(``run_checks`` on a mesh of one process). The inputs are JAX's worker's,
seeded (``seeded_inputs``), or a directory that ``save_inputs`` wrote
(``--inputs``: chip_smoke.py's multihost phase at full size).

Usage::

    torch_multihost_worker.py <init_method or host:port> <process_id>
        <num_processes> [--device cpu|cuda] [--shards-per-rank 2]
        [--out results.npz] [--inputs DIR] [--timeout S]

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


def seeded_inputs(n_devices: int) -> dict:
    """JAX's worker's inputs, drawn in its order from ``RandomState(0)``:
    X (64, 12), the logreg parameters, a KNN corpus of 8 rows a device
    (k = 5, queries X[:16]), and a table of ``3 * n_devices`` records in
    one tick at time 2, labelled by ``label_fn``, 5 render rows."""
    rng = np.random.RandomState(0)
    X = np.abs(rng.gamma(1.5, 200.0, (64, 12))).astype(np.float32)
    logreg = {"coef": rng.randn(6, 12).astype(np.float32),
              "intercept": rng.randn(6).astype(np.float32)}
    knn = {"fit_X": rng.rand(8 * n_devices, 12) * 100.0,
           "y": rng.randint(0, 6, 8 * n_devices).astype(np.int32),
           "n_neighbors": 5, "classes": np.arange(6)}
    return {"X": X, "logreg": logreg, "knn": knn, "knn_queries": X[:16],
            "forest": None, "capacity": 8 * n_devices, "table_rows": 5,
            "native": False, "incremental": False,
            "ticks": [_records(3 * n_devices)]}


def save_inputs(path: str, X, logreg: dict, knn: dict, forest: dict,
                ticks: list, capacity: int, table_rows: int) -> None:
    """Write the inputs of a full-size run to the directory ``path``:
    queries ``X`` (logreg and KNN), the importer dicts of the three
    models, and the table's capture as one file of raw telemetry bytes a
    tick (``ticks``: their paths), served by the native engine with
    incremental labels and the forest's kernel as the predict."""
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "X.npy"), np.asarray(X, np.float32))
    for name, d in (("logreg", logreg), ("knn", knn), ("forest", forest)):
        np.savez(os.path.join(path, f"{name}.npz"), **d)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"ticks": list(ticks), "capacity": capacity,
                   "table_rows": table_rows}, f)


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
    return {"X": X, "logreg": arrays("logreg"), "knn": knn,
            "knn_queries": X, "forest": arrays("forest"),
            "capacity": meta["capacity"], "table_rows": meta["table_rows"],
            "native": True, "incremental": True, "ticks": ticks}


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


def run_checks(inp: dict, dmesh, smesh, device) -> tuple[dict, dict]:
    """The four checks on a data mesh ``dmesh`` and a state mesh
    ``smesh`` (one process's, or spanning the group): ``(results,
    timings)``. Results are numpy arrays, the same on every rank; timings
    are this process's host ms and exchanges per table tick."""
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

    predict_fn, params = _table_predict(inp, device)
    eng = tsh.ShardedFlowEngine(
        dmesh, inp["capacity"], table_rows=inp["table_rows"],
        native=inp["native"], incremental=inp["incremental"])
    eng.install_predict(predict_fn, params)
    rows, counts, evicted = [], [], []
    timings = {"host_ms": [], "exchange_bytes": [], "exchange_ms": []}
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


def check_against(got: dict, want: dict, tag: str) -> None:
    """Every result of ``want`` equal to ``got``'s, bitwise
    (``knn_fused_labels`` to ``want["knn_labels"]``)."""
    for key, ref in want.items():
        names = (key, "knn_fused_labels") if key == "knn_labels" else (key,)
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
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="s a rank waits for a peer before it fails")
    args = ap.parse_args(argv)
    os.environ["TCSDN_SHARDS_PER_DEVICE"] = str(args.shards_per_rank)

    import torch

    torch.set_num_threads(1)
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk
    from traffic_classifier_sdn_tpu_torch.ops import knn_kernel as kk
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
        fk.forest_proba.launches = 0
        kk.topk_sim_idx.launches = 0
        got, timings = run_checks(inp, dmesh, smesh, device)
        launches = {"forest": fk.forest_proba.launches,
                    "knn": kk.topk_sim_idx.launches}
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
