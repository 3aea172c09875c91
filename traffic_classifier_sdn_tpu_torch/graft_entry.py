"""The twin in the port of the repository's entry module,
``__graft_entry__.py``: its ``entry()`` and ``dryrun_multichip(n)``, on
the port's modules and the card.

``entry(device=None)`` returns ``(fn, args)``: the flagship forward step,
the random forest through the port's forest kernel
(``csrc/forest_proba.cu`` via ops/forest_kernel.py; its plain version on
the CPU), on 256 rows drawn as the JAX entry draws them. The model
follows the JAX entry's rule: ``$TCSDN_MODELS_DIR/RandomForestClassifier``
read through io/sklearn_import.py when it exists (the port's CLI rule:
``models`` when the variable is unset), else the synthesized stump
ensemble ``_synth_forest``, a copy of the JAX entry's.

``dryrun_multichip(n_devices, device=None)`` runs one step of the whole
distributed repertoire in one process, on a ``(n/2) × 2`` mesh of
``n_devices`` slots of ``device`` (default: the card; one device fills
every slot, as ``make_mesh`` allows), with the JAX dryrun's draws in its
order, so each step's inputs equal JAX's:

1. the data-parallel Adam step (``train/logreg.make_sgd(mesh=...)``);
1b. the data-parallel forest fit (``train/distributed.fit_forest``);
2. the state-sharded KNN: the all_gather, ring and tournament merges of
   the torch local stage, then ``fused_predict`` (the KNN kernel once per
   state shard) under each merge;
3. the tree-sharded forest, gather and GEMM forms (torch, as JAX's run in
   XLA);
3b. the batch-sharded forest over the data axis
   (``parallel/predict.data_parallel``): JAX's two v2 GEMM layouts, which
   the port serves with its forest kernel (``models.FOREST_KERNEL_LAYOUTS``),
   so the kernel launches once per data shard for each;
4. the SV-sharded SVC, torch local stage and ``fused_decision`` (the RBF
   kernel once per state shard);
5. the GNB and k-means fits on rows that do not divide over the data axis;
6. one tick of the sharded serving table over an ``n × 1`` mesh.

It returns None, as JAX's does. ``_dryrun_steps(mesh, rng)`` runs the same
steps on a given mesh and returns each step's inputs and outputs as numpy
arrays, which the tests and ``chip_smoke.py`` hold.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .device import resolve_device


def _synth_forest(n_trees: int = 8, n_classes: int = 6) -> dict:
    """Depth-1 stump ensemble with valid node arrays (3 nodes per tree):
    the JAX entry's, drawn from its own ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    left = np.tile(np.array([1, -1, -1], np.int32), (n_trees, 1))
    right = np.tile(np.array([2, -1, -1], np.int32), (n_trees, 1))
    feature = np.zeros((n_trees, 3), np.int32)
    feature[:, 0] = rng.randint(0, 12, n_trees)
    threshold = np.zeros((n_trees, 3), np.float64)
    threshold[:, 0] = rng.rand(n_trees) * 100
    values = rng.rand(n_trees, 3, n_classes) + 0.1
    return {
        "left": left, "right": right, "feature": feature,
        "threshold": threshold, "values": values, "max_depth": 1,
        "classes": np.arange(n_classes),
    }


def reference_forest_path() -> str:
    """Where the entry looks for the reference forest pickle:
    ``$TCSDN_MODELS_DIR/RandomForestClassifier``, read at call time."""
    return os.path.join(os.environ.get("TCSDN_MODELS_DIR", "models"),
                        "RandomForestClassifier")


def entry(device=None):
    """``(fn, example_args)``: the flagship forward step, ``fn(*args)``
    giving (256,) int32 labels. The forest kernel's predict on ``device``
    (default CUDA, see device.py) over the reference forest when its pickle
    exists, else over ``_synth_forest()``."""
    from .io import sklearn_import
    from .ops import forest_kernel

    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    X = torch.from_numpy(rng.rand(256, 12).astype(np.float32) * 1000.0)
    path = reference_forest_path()
    d = (sklearn_import.import_forest(path) if os.path.exists(path)
         else _synth_forest())
    k = forest_kernel.compile_forest(d, n_features=12, device=dev)
    return forest_kernel.predict, (k, X.to(dev))


def dryrun_mesh(n_devices: int, device=None):
    """The dryrun's mesh: ``(n/2) × 2`` slots of ``device`` (default
    CUDA), both axes populated when ``n_devices`` is even and above 1, as
    in the JAX dryrun; else ``n × 1``."""
    from .parallel import mesh as meshlib

    dev = resolve_device(device)
    n_state = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    return meshlib.make_mesh(n_data=n_devices // n_state, n_state=n_state,
                             devices=[dev] * n_devices)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One step of the full distributed repertoire over ``n_devices``
    slots of ``device`` (module docstring); raises if a step fails."""
    _dryrun_steps(dryrun_mesh(n_devices, device), np.random.RandomState(0))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _on(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _queries(rng, dev, n: int = 32) -> tuple:
    X = rng.rand(n, 12).astype(np.float32)
    return X, _on(X, dev)


def _dryrun_steps(mesh, rng) -> dict:
    """The dryrun's steps on ``mesh`` (one process), drawing from ``rng``
    in the JAX dryrun's order: ``{step: {name: numpy array or number}}``
    holding each step's inputs and outputs."""
    from . import interop
    from .ingest.protocol import TelemetryRecord
    from .ops import forest_kernel
    from .parallel import forest_sharded as fsh
    from .parallel import knn_sharded as ksh
    from .parallel import mesh as meshlib
    from .parallel import predict as ppred
    from .parallel import svc_sharded as ssh
    from .parallel import table_sharded as tsh
    from .train import distributed as dtrain
    from .train import logreg as logreg_train

    n_devices = mesh.devices.size
    n_state = mesh.shape[meshlib.STATE_AXIS]
    dev = mesh.axis_devices(meshlib.DATA_AXIS)[0]
    out: dict = {}

    # --- 1. the data-parallel training step (dp over 'data') -------------
    init, train_step = logreg_train.make_sgd(learning_rate=1e-2, mesh=mesh)
    state = init(n_classes=6, n_features=12)
    B = 16 * n_devices
    X = rng.rand(B, 12).astype(np.float32)
    y = rng.randint(0, 6, B).astype(np.int32)
    state, loss = train_step(state, _on(X, dev), _on(y.astype(np.int64), dev))
    out["sgd"] = {"X": X, "y": y, "loss": float(loss),
                  "leaves": [_host(a) for a in state.leaves()]}

    # --- 1b. the data-parallel forest fit ----------------------------------
    Xf = rng.rand(8 * n_devices, 12).astype(np.float32) * 100
    yf = rng.randint(0, 6, 8 * n_devices).astype(np.int32)
    fm = dtrain.fit_forest(mesh, Xf, yf, n_classes=6, n_trees=2,
                           max_depth=3, n_bins=8)
    out["forest_fit"] = {"X": Xf, "y": yf, **{
        k: _host(getattr(fm, k))
        for k in ("left", "right", "feature", "threshold", "values")}}

    # --- 2. the state-sharded KNN: every merge, torch and kernel stages ----
    S = 16 * n_state
    knn_raw = {
        "fit_X": rng.rand(S, 12) * 100,
        "y": rng.randint(0, 6, S).astype(np.int32),
        "n_neighbors": 5,
        "classes": np.arange(6),
    }
    knn_raw = ksh.pad_corpus(knn_raw, n_state)
    mask = knn_raw.get("pad_mask")
    kp = interop.knn_params_from_numpy(knn_raw, dev)
    knn: dict = {"model": knn_raw}
    merges = [("all_gather", ksh.sharded_predict), ("ring", ksh.ring_predict)]
    if n_state & (n_state - 1) == 0:
        merges.append(("tournament", ksh.tournament_predict))
    for name, build in merges:
        Xq, Xd = _queries(rng, dev)
        knn[name] = (Xq, _host(build(mesh, kp, pad_mask=mask)(Xd)))
    for merge in ("all_gather", "ring", "tournament"):
        Xq, Xd = _queries(rng, dev)
        fn = ksh.fused_predict(mesh, kp, pad_mask=mask, merge=merge,
                               corpus_chunk=16)
        knn[f"fused_{merge}"] = (Xq, _host(fn(Xd)))
    out["knn"] = knn

    # --- 3. the tree-sharded forest, gather and GEMM forms -----------------
    fd = fsh.pad_trees(_synth_forest(n_trees=4 * n_state), n_state)
    fp = interop.forest_params_from_numpy(fd, dev)
    n_real = fd.get("n_real_trees", fd["left"].shape[0])
    forest: dict = {"model": fd}
    Xq, Xd = _queries(rng, dev)
    forest["gather"] = (Xq, _host(fsh.sharded_proba(mesh, fp, n_real)(Xd)))
    Xq, Xd = _queries(rng, dev)
    forest["gemm"] = (Xq, _host(fsh.gemm_sharded_proba(mesh, fd,
                                                       n_features=12)(Xd)))
    out["forest"] = forest

    # --- 3b. the batch-sharded forest through the kernel, per data shard --
    # both layouts are the one function the forest kernel computes
    batch: dict = {"model": _synth_forest(n_trees=6)}
    k = forest_kernel.compile_forest(batch["model"], n_features=12,
                                     device=dev)
    call = ppred.data_parallel(mesh, forest_kernel.predict)
    for layout in ("gemm_v2_dot", "gemm_v2_gather"):
        Xq, Xd = _queries(rng, dev, 16 * n_devices)
        batch[layout] = (Xq, _host(call(k, Xd)))
    out["forest_batch"] = batch

    # --- 4. the SV-sharded SVC, torch and kernel local stages --------------
    S = 8 * n_state
    ns = np.full(6, S // 6, np.int64)  # sums to S: the importer's pair layout
    ns[: S % 6] += 1
    sd = {
        "support_vectors": rng.rand(S, 12) * 100,
        "dual_coef": rng.randn(5, S),
        "n_support": ns,
        "intercept": rng.randn(15),
        "gamma": 1e-4,
    }
    sd = ssh.pad_support(sd, n_state)
    sp = interop.svc_params_from_numpy(sd, dev)
    svc: dict = {"model": sd}
    for name, fn in (("torch", ssh.sharded_decision(mesh, sp)),
                     ("fused", ssh.fused_decision(mesh, sp, sv_chunk=16))):
        Xq, Xd = _queries(rng, dev)
        labels, dec = fn(Xd)
        svc[name] = (Xq, _host(labels), _host(dec))
    out["svc"] = svc

    # --- 5. the closed-form fits on rows that do not divide ----------------
    Xf = rng.rand(8 * n_devices + 3, 12) * 100
    yf = rng.randint(0, 6, len(Xf)).astype(np.int32)
    g = dtrain.fit_gnb(mesh, Xf, yf, n_classes=6)
    km, inertia = dtrain.fit_kmeans(mesh, Xf, k=4, n_init=2, n_iter=5)
    out["fits"] = {"X": Xf, "y": yf, "inertia": inertia,
                   "centers": _host(km.centers),
                   **{f"gnb_{k}": _host(getattr(g, k))
                      for k in ("theta", "inv_var", "log_const")}}

    # --- 6. one tick of the sharded serving table over the data axis -------
    data_mesh = meshlib.make_mesh(n_data=n_devices, n_state=1,
                                  devices=list(mesh.devices.ravel()))
    eng = tsh.ShardedFlowEngine(
        data_mesh, 16 * n_devices,
        predict_fn=lambda _p, Xt: torch.sum(Xt, dim=1).to(torch.int32) % 6,
        params=None, table_rows=4,
    )
    eng.mark_tick()
    records = [
        TelemetryRecord(
            time=2, datapath="1", in_port=1, eth_src=f"s{i}",
            eth_dst=f"d{i}", out_port=2, packets=10, bytes=1000 + i,
        )
        for i in range(4 * n_devices)
    ]
    eng.ingest(records)
    eng.step()
    rows, evicted = eng.tick_render(now=2, idle_seconds=3600)
    if len(rows) != 4:
        raise AssertionError(f"the sharded table rendered {len(rows)} rows, "
                             "not 4")
    out["table"] = {"records": records, "capacity": 16 * n_devices,
                    "rows": np.asarray(rows, np.int64).reshape(-1, 4),
                    "evicted": int(evicted)}
    return out
