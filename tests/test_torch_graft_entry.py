"""The twin of ``__graft_entry__.py`` in the port
(``traffic_classifier_sdn_tpu_torch/graft_entry.py``) and the
data-parallel train step (``train/logreg.make_sgd(mesh=...)``) on the
CPU, against the JAX package's ``__graft_entry__.py`` functions on the
test harness's 8 virtual CPU devices, and the refusal of a mesh with both
axes above 1 that spans processes (``parallel/mesh.make_mesh``).

Tolerances, each measured on these inputs:

- ``entry()``: labels equal to JAX's ``entry()`` on the same 256 rows, on
  the synthesized stump ensemble and on the committed reference-shaped
  forest pickle, wherever the top two probabilities differ by more than
  2e-5; the pickle's trees vote with whole leaves, so 6 of the 256 rows
  are exact ties (27 of 100 trees each for classes 4 and 5), which each
  package's float sums break by rounding: there both labels must be
  among the tied classes.
- the data-parallel Adam step: the port's mesh adds the shards' partial
  sums in shard order, XLA in its own order, so the float32 sums round
  differently. Against the step without a mesh, from the same state at
  each of 20 steps: the loss within rtol 1e-5 (measured 1.4e-7), the
  first and second moments within 1e-5 of their largest component
  (measured 4.4e-7 and 7.9e-7), and the params within 1e-5 · lr of the
  step's (measured 3.7e-7 · lr) wherever the gradient component exceeds
  1e-5 of the largest: at step 1 Adam moves a component by about
  ``lr · g/|g|``, so a gradient near 0 may change sign between summation
  orders and move the params by up to 2 · lr, and there the moments
  (the gradients) are what is compared. Whole 20-step runs: params within
  1e-5 of the largest |param| of the run without a mesh and of JAX's
  ``make_sgd`` over ``NamedSharding`` with the same data shards
  (measured 5.2e-7 and 1.1e-6). One shard: bitwise the step without a
  mesh.
- ``_dryrun_steps`` against the JAX functions on the same draws over a
  JAX mesh of the same ``(n/2) × 2`` shape: the Adam step as above (loss
  rtol 1e-5, every leaf within 1e-5 of its largest component); the
  forest fit bitwise JAX's given JAX's draws; KNN labels of every merge
  and local stage equal; the tree-sharded forest's probabilities within
  ``atol=1e-5`` of JAX's un-sharded mean and labels equal to JAX's
  sharded predicts where the top two differ by more than 2e-5 (as
  tests/test_torch_parallel.py); the batch-sharded kernel forest's labels
  equal to JAX's v2 GEMM forms; SVC decisions within 1e-5 of the largest
  coefficient sum of JAX's un-sharded decisions, labels equal to JAX's
  SV-sharded predicts off that band; GNB within 1e-6 relative; k-means,
  given JAX's k-means++ centers, assignments equal and centers within
  1e-4 relative; the table's rendered rows equal.
"""

import os
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import __graft_entry__ as jentry
import chip_smoke
from test_torch_train import jax_draws, one_torch_thread  # noqa: F401
from traffic_classifier_sdn_tpu.ingest.protocol import (
    TelemetryRecord as JaxRecord,
)
from traffic_classifier_sdn_tpu.models import forest as jforest
from traffic_classifier_sdn_tpu.models import knn as jknn
from traffic_classifier_sdn_tpu.models import svc as jsvc
from traffic_classifier_sdn_tpu.ops import tree_gemm as jtree_gemm
from traffic_classifier_sdn_tpu.parallel import forest_sharded as jfs
from traffic_classifier_sdn_tpu.parallel import knn_sharded as jks
from traffic_classifier_sdn_tpu.parallel import mesh as jmeshlib
from traffic_classifier_sdn_tpu.parallel import predict as jpred
from traffic_classifier_sdn_tpu.parallel import svc_sharded as jss
from traffic_classifier_sdn_tpu.parallel import table_sharded as jtsh
from traffic_classifier_sdn_tpu.train import distributed as jdist
from traffic_classifier_sdn_tpu.train import kmeans as jkmeans
from traffic_classifier_sdn_tpu.train import logreg as jlogreg
from traffic_classifier_sdn_tpu_torch import graft_entry
from traffic_classifier_sdn_tpu_torch.ops import forest_kernel
from traffic_classifier_sdn_tpu_torch.parallel import mesh as meshlib
from traffic_classifier_sdn_tpu_torch.train import forest as tforest
from traffic_classifier_sdn_tpu_torch.train import kmeans as tkmeans
from traffic_classifier_sdn_tpu_torch.train import logreg as tlogreg

ROOT = pathlib.Path(__file__).resolve().parents[1]
PICKLES = ROOT / "tests" / "data" / "reference_pickles"
CPU = torch.device("cpu")
LR = 1e-2
STEPS = 20
SGD_RTOL = 1e-5
FOREST_ATOL = 1e-5
FOREST_GAP = 2e-5


pytestmark = pytest.mark.usefixtures("one_torch_thread")


# --- entry() -----------------------------------------------------------


@pytest.mark.parametrize("model", ["synthesized", "reference_pickle"])
def test_entry_labels_equal_jax(monkeypatch, model):
    """``entry()``'s forward step on the CPU (the forest kernel's plain
    version) labels JAX's ``entry()`` rows as JAX's step does, under JAX's
    rule for the model."""
    models_dir = str(PICKLES) if model == "reference_pickle" else str(
        ROOT / "no-such-models-dir")
    monkeypatch.setenv("TCSDN_MODELS_DIR", models_dir)
    monkeypatch.setattr(jentry, "_REF_FOREST",
                        os.path.join(models_dir, "RandomForestClassifier"))
    fn, args = graft_entry.entry(device="cpu")
    jfn, jargs = jentry.entry()
    np.testing.assert_array_equal(args[1].numpy(), np.asarray(jargs[1]))
    got = fn(*args)
    assert got.dtype == torch.int32 and got.shape == (256,)
    want = np.asarray(jfn(*jargs))
    proba = forest_kernel.forest_proba(*args).numpy()
    top2 = np.sort(proba, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > FOREST_GAP
    np.testing.assert_array_equal(got.numpy()[clear], want[clear])
    # on a tie both labels are among the tied classes
    rows = np.arange(len(want))
    near = proba >= top2[:, 1:] - FOREST_GAP
    assert near[rows, got.numpy()].all() and near[rows, want].all()
    if model == "reference_pickle":
        assert args[0].n_trees == 100
    else:
        assert args[0].n_trees == 8


def test_entry_wants_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()


def test_synth_forest_is_the_jax_entrys():
    for n in (4, 8):
        a, b = graft_entry._synth_forest(n), jentry._synth_forest(n)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


# --- the data-parallel train step --------------------------------------


def _sgd_data(n_rows: int = 128):
    rng = np.random.RandomState(0)
    X = rng.rand(n_rows, 12).astype(np.float32)
    y = rng.randint(0, 6, n_rows).astype(np.int32)
    return X, y


def _cpu_mesh(n_data: int, n_state: int = 1):
    return meshlib.make_mesh(n_data=n_data, n_state=n_state,
                             devices=[CPU] * (n_data * n_state))


def _jax_mesh(n_data: int, n_state: int = 1):
    return jmeshlib.make_mesh(n_data=n_data, n_state=n_state,
                              devices=jax.devices()[:n_data * n_state])


def _port_run(X, y, mesh, steps: int = STEPS) -> list:
    init, step = tlogreg.make_sgd(LR, device="cpu", mesh=mesh)
    state = init(6, 12)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y.astype(np.int64))
    out = []
    for _ in range(steps):
        state, loss = step(state, Xt, yt)
        out.append((float(loss), [a.numpy().copy() for a in state.leaves()]))
    return out


def _jax_run(X, y, jmesh, steps: int = STEPS) -> list:
    init, step = jlogreg.make_sgd(LR)
    state = jax.device_put(init(6, 12), jmeshlib.replicated(jmesh))
    Xj = jax.device_put(X, NamedSharding(jmesh, P(jmeshlib.DATA_AXIS, None)))
    yj = jax.device_put(y, NamedSharding(jmesh, P(jmeshlib.DATA_AXIS)))
    out = []
    for _ in range(steps):
        state, loss = step(state, Xj, yj)
        out.append((float(loss), [np.asarray(a) for a in
                                  jax.tree_util.tree_leaves(state)]))
    return out


def _close_to_largest(a, b, rtol: float, what: str) -> None:
    """``a`` within ``rtol`` of ``b``'s largest |component|."""
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=rtol * float(np.abs(b).max()),
                               err_msg=what)


def _held_step(got_state, got_loss, want_state, want_loss, what: str):
    """One Adam step held to another from the same state (module
    docstring): loss, moments, and params off the flip band."""
    assert got_loss == pytest.approx(want_loss, rel=SGD_RTOL), what
    for name, ga, wa in (("mu", got_state.opt_state.mu,
                          want_state.opt_state.mu),
                         ("nu", got_state.opt_state.nu,
                          want_state.opt_state.nu)):
        for g, w in zip(ga, wa):
            _close_to_largest(g.numpy(), w.numpy(), SGD_RTOL,
                              f"{what} {name}")
    for p, q, m in zip(got_state.params, want_state.params,
                       want_state.opt_state.mu):
        m = m.numpy()
        clear = np.abs(m) > SGD_RTOL * np.abs(m).max()
        np.testing.assert_allclose(p.numpy()[clear], q.numpy()[clear],
                                   rtol=0, atol=SGD_RTOL * LR,
                                   err_msg=f"{what} params")
    assert int(got_state.opt_state.count) == int(want_state.opt_state.count)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_sgd_step_on_a_mesh_against_one_shard_and_jax(shards):
    X, y = _sgd_data()
    mesh = _cpu_mesh(shards)
    init, sharded = tlogreg.make_sgd(LR, device="cpu", mesh=mesh)
    _, one = tlogreg.make_sgd(LR, device="cpu")
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y.astype(np.int64))
    state = init(6, 12)
    for i in range(STEPS):
        a, la = sharded(state, Xt, yt)
        b, lb = one(state, Xt, yt)
        _held_step(a, float(la), b, float(lb), f"step {i + 1}")
        if shards == 1:
            for u, v in zip(a.leaves(), b.leaves()):
                assert torch.equal(u, v)
        state = a
    # whole runs: against the run without a mesh and JAX's sharded run
    got = _port_run(X, y, mesh)
    for name, want in (("one shard", _port_run(X, y, None)),
                       ("jax", _jax_run(X, y, _jax_mesh(shards)))):
        for (lg, g), (lw, w) in zip(got, want):
            assert lg == pytest.approx(lw, rel=SGD_RTOL), name
        for g, w in zip(got[-1][1], want[-1][1]):
            _close_to_largest(g, w, SGD_RTOL, name)


def test_sgd_without_a_mesh_is_the_step_of_before():
    """No mesh: ``make_sgd`` takes no mesh path (the step that
    tests/test_torch_sgd.py holds to JAX)."""
    init, step = tlogreg.make_sgd(LR, device="cpu")
    assert step.__name__ == "train_step"
    _, sharded = tlogreg.make_sgd(LR, mesh=_cpu_mesh(2))
    assert sharded.__name__ == "sharded_step"


def test_sgd_mesh_places_the_state_on_the_first_data_shard():
    init, _ = tlogreg.make_sgd(LR, mesh=_cpu_mesh(4, 2))
    assert all(a.device == CPU for a in init(3, 12).params)


def test_sgd_mesh_refuses_a_batch_that_does_not_split():
    X, y = _sgd_data(30)
    init, step = tlogreg.make_sgd(LR, mesh=_cpu_mesh(4))
    with pytest.raises(ValueError, match="do not split over 4 shards"):
        step(init(6, 12), torch.from_numpy(X),
             torch.from_numpy(y.astype(np.int64)))


# --- dryrun_multichip and its steps ------------------------------------


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_multichip_runs(n):
    assert graft_entry.dryrun_multichip(n, device="cpu") is None
    mesh = graft_entry.dryrun_mesh(n, "cpu")
    assert mesh.devices.shape == (n // 2, 2)


def test_dryrun_wants_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)


def _jax_kmeans_inits(X: np.ndarray, d: int, k: int, n_init: int) -> list:
    """JAX ``fit_kmeans``'s k-means++ centers of each init (seed 0), on
    its trimmed rows."""
    Xt = jax.numpy.asarray(X[: len(X) - len(X) % d], jax.numpy.float32)
    keys = jax.random.split(jax.random.key(0), n_init)
    return [np.array(jkmeans._plusplus_init(kk, Xt, k)) for kk in keys]


@pytest.fixture(scope="module", params=[2, 4, 8], ids=lambda n: f"n{n}")
def dryrun(request):
    """The port's ``_dryrun_steps`` on a ``(n/2) × 2`` CPU mesh, its forest
    fit fed JAX's draws and its k-means fed JAX's k-means++ centers, and
    the JAX mesh of the same shape."""
    n = request.param
    mesh = graft_entry.dryrun_mesh(n, "cpu")
    n_data = n // 2
    draws = jax_draws(0, 2, 8 * n, 12, 3, True, 3)
    # step 5's fit rows, where the dryrun's rng draws them
    rows = graft_entry._dryrun_steps(mesh, np.random.RandomState(0))
    inits = iter(_jax_kmeans_inits(rows["fits"]["X"], n_data, 4, 2))

    def recorded(gen, tree, *a, device, **kw):
        w, scores = draws[tree]
        return (torch.from_numpy(w).to(device),
                [torch.from_numpy(s).to(device) for s in scores])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tforest, "tree_draws", recorded)
        mp.setattr(tkmeans, "_plusplus_init",
                   lambda gen, X, k: torch.from_numpy(next(inits)).to(
                       X.device))
        n_threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            out = graft_entry._dryrun_steps(mesh, np.random.RandomState(0))
        finally:
            torch.set_num_threads(n_threads)
    return {"n": n, "out": out, "jmesh": _jax_mesh(n_data, 2)}


def test_dryrun_sgd_step_against_jax(dryrun):
    s, jm = dryrun["out"]["sgd"], dryrun["jmesh"]
    (loss, leaves), = _jax_run(s["X"], s["y"], jm, steps=1)
    assert s["loss"] == pytest.approx(loss, rel=SGD_RTOL)
    for got, want in zip(s["leaves"], leaves):
        assert got.shape == want.shape and got.dtype == want.dtype
        _close_to_largest(got, want, SGD_RTOL, "sgd leaf")


def test_dryrun_forest_fit_is_jaxs_given_jaxs_draws(dryrun):
    f = dryrun["out"]["forest_fit"]
    want = jdist.fit_forest(dryrun["jmesh"], f["X"], f["y"], n_classes=6,
                            n_trees=2, max_depth=3, n_bins=8)
    for k in ("left", "right", "feature", "threshold", "values"):
        np.testing.assert_array_equal(f[k], np.asarray(getattr(want, k)), k)


def test_dryrun_knn_merges_equal_jax(dryrun):
    knn, jm = dryrun["out"]["knn"], dryrun["jmesh"]
    raw = knn["model"]
    kp = jknn.from_numpy(raw, dtype=jax.numpy.float32)
    mask = raw.get("pad_mask")
    builds = {
        "all_gather": jks.sharded_predict(jm, kp, pad_mask=mask),
        "ring": jks.ring_predict(jm, kp, pad_mask=mask),
        "tournament": jks.tournament_predict(jm, kp, pad_mask=mask),
    }
    for merge in ("all_gather", "ring", "tournament"):
        builds[f"fused_{merge}"] = jks.fused_predict(
            jm, kp, pad_mask=mask, merge=merge, row_tile=8,
            corpus_chunk=16, interpret=True)
    assert sorted(k for k in knn if k != "model") == sorted(builds)
    for name, fn in builds.items():
        Xq, labels = knn[name]
        np.testing.assert_array_equal(labels, np.asarray(
            fn(jax.numpy.asarray(Xq))), err_msg=name)


def test_dryrun_tree_sharded_forest_against_jax(dryrun):
    forest, jm = dryrun["out"]["forest"], dryrun["jmesh"]
    fd = forest["model"]
    n_state = 2
    unpadded = jforest.from_numpy(graft_entry._synth_forest(4 * n_state))
    fp = jforest.from_numpy(fd)
    preds = {"gather": jfs.sharded_predict(
        jm, fp, n_real_trees=fd.get("n_real_trees", fd["left"].shape[0])),
        "gemm": jfs.gemm_sharded_predict(jm, fd, n_features=12)}
    for name, fn in preds.items():
        Xq, proba = forest[name]
        Xj = jax.numpy.asarray(Xq)
        want = np.asarray(jforest.scores(unpadded, Xj))
        np.testing.assert_allclose(proba, want, rtol=0, atol=FOREST_ATOL,
                                   err_msg=name)
        top2 = np.sort(want, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > FOREST_GAP
        np.testing.assert_array_equal(proba.argmax(1)[clear],
                                      np.asarray(fn(Xj))[clear],
                                      err_msg=name)


def test_dryrun_batch_sharded_kernel_forest_equals_jax_v2(dryrun):
    batch, jm = dryrun["out"]["forest_batch"], dryrun["jmesh"]
    for layout in ("gemm_v2_dot", "gemm_v2_gather"):
        g2 = jtree_gemm.compile_forest_v2(
            jentry._synth_forest(n_trees=6), n_buckets=2,
            stage3=layout.rsplit("_", 1)[1])
        Xq, labels = batch[layout]
        want = jpred.data_parallel(jm, jtree_gemm.predict_v2)(
            g2, jax.numpy.asarray(Xq))
        assert labels.dtype == np.int32
        np.testing.assert_array_equal(labels, np.asarray(want), layout)


def test_dryrun_sv_sharded_svc_against_jax(dryrun):
    svc, jm = dryrun["out"]["svc"], dryrun["jmesh"]
    jp = jsvc.from_numpy(svc["model"], dtype=jax.numpy.float32)
    atol = 1e-5 * float(np.abs(np.asarray(jp.pair_coef)).sum(1).max())
    preds = {"torch": jss.sharded_predict(jm, jp),
             "fused": jss.fused_predict(jm, jp, row_tile=8, sv_chunk=16,
                                        interpret=True)}
    for name, fn in preds.items():
        Xq, labels, dec = svc[name]
        Xj = jax.numpy.asarray(Xq)
        want = np.asarray(jsvc.decision_ovo(jp, Xj))
        np.testing.assert_allclose(dec, want, rtol=0, atol=atol,
                                   err_msg=name)
        clear = np.abs(want).min(1) > atol
        np.testing.assert_array_equal(labels[clear],
                                      np.asarray(fn(Xj))[clear], name)


def test_dryrun_fits_against_jax(dryrun):
    f, jm = dryrun["out"]["fits"], dryrun["jmesh"]
    g = jdist.fit_gnb(jm, f["X"], f["y"], n_classes=6)
    for k in ("theta", "inv_var", "log_const"):
        np.testing.assert_allclose(f[f"gnb_{k}"], np.asarray(getattr(g, k)),
                                   rtol=1e-6, err_msg=k)
    km, inertia = jdist.fit_kmeans(jm, f["X"], k=4, n_init=2, n_iter=5)
    want = np.asarray(km.centers)
    np.testing.assert_allclose(f["centers"], want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    assert f["inertia"] == pytest.approx(inertia, rel=1e-4)
    Xj = jax.numpy.asarray(f["X"], jax.numpy.float32)
    np.testing.assert_array_equal(
        tkmeans._assign(torch.from_numpy(np.asarray(f["X"], np.float32)),
                        torch.from_numpy(f["centers"]))[0].numpy(),
        np.asarray(jkmeans._assign(Xj, km.centers)[0]))


def test_dryrun_table_tick_equals_jax(dryrun):
    t, n = dryrun["out"]["table"], dryrun["n"]
    data_mesh = _jax_mesh(n)
    eng = jtsh.ShardedFlowEngine(
        data_mesh, t["capacity"],
        predict_fn=lambda _p, Xt: (
            jax.numpy.sum(Xt, axis=1).astype(jax.numpy.int32) % 6),
        params=None, table_rows=4,
    )
    eng.mark_tick()
    eng.ingest([JaxRecord(time=r.time, datapath=r.datapath,
                          in_port=r.in_port, eth_src=r.eth_src,
                          eth_dst=r.eth_dst, out_port=r.out_port,
                          packets=r.packets, bytes=r.bytes)
                for r in t["records"]])
    eng.step()
    rows, evicted = eng.tick_render(now=2, idle_seconds=3600)
    np.testing.assert_array_equal(
        t["rows"], np.asarray(rows, np.int64).reshape(-1, 4))
    assert t["evicted"] == int(evicted)


# --- a 2-D mesh spanning processes -------------------------------------


RANK = """
import os, sys
os.environ["TCSDN_SHARDS_PER_DEVICE"] = "2"
from traffic_classifier_sdn_tpu_torch.parallel import mesh as m
m.init_distributed(init_method=sys.argv[1], num_processes=2,
                   process_id=int(sys.argv[2]), device="cpu",
                   initialization_timeout=30)
try:
    try:
        m.make_mesh(n_data=2, n_state=2)
        print("BUILT 2x2")
    except ValueError as e:
        print("REFUSED", e)
    data, state = m.make_mesh(n_state=1), m.make_mesh(n_data=1, n_state=4)
    print("DATA", data.devices.shape, data.local_shards("data"))
    print("STATE", state.devices.shape, state.local_shards("state"))
finally:
    m.shutdown_distributed()
"""


def test_two_dimensional_mesh_spanning_processes_is_refused(tmp_path):
    """Two gloo ranks of two CPU slots each: a 2x2 global mesh would give
    rank 1 no shard of the state axis (its slots are row 1), where the
    SVC head and ``shard_sum`` index this rank's first shard; ``make_mesh``
    refuses it with a ValueError that says what to build instead, and the
    (4, 1) and (1, 4) meshes still form, every rank owning its slots."""
    init = f"file://{tmp_path / 'rendezvous'}"
    outs = chip_smoke.run_ranks(
        [[sys.executable, "-c", RANK, init, str(i)] for i in range(2)], 120)
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, err
        assert "BUILT" not in out
        assert "REFUSED a 2x2 mesh over 2 processes is refused" in out
        assert "(N, 1) for the data axis or (1, N) for the state" in out
        assert f"DATA (4, 1) [{2 * i}, {2 * i + 1}]" in out
        assert f"STATE (1, 4) [{2 * i}, {2 * i + 1}]" in out


def test_two_dimensional_mesh_in_one_process_still_forms():
    mesh = meshlib.make_mesh(n_data=2, n_state=2, devices=["cpu"] * 4)
    assert not mesh.spans_processes
    assert mesh.local_shards("state") == [0, 1]
    assert mesh.local_shards("data") == [0, 1]
