"""The port's multi-host path on the CPU: two ranks of
``tests/torch_multihost_worker.py`` over ``torch.distributed`` (gloo, a
``file://`` rendezvous in the test's directory), two shards each, held
bitwise to the one-process 4-shard mesh and to JAX's single-device
references — the twin of ``tests/test_multihost.py``, which skips on the
CPU (XLA's CPU backend runs no multiprocess computation), where these
ranks run. One module-scoped two-rank run (``two_ranks``) carries every
check of the worker; each case reads its part.

Beyond JAX's four checks, every function the JAX package runs under
``shard_map`` runs across the two ranks, and each rank's result is held
bitwise to the one-process 4-shard mesh's and to JAX's single-process
4-device virtual CPU mesh at the tolerance tests/test_torch_parallel.py
and tests/test_torch_distributed.py state for it:

- KNN ring and tournament merges (torch and kernel local stages): labels
  bitwise JAX's ``ring_predict``/``tournament_predict``/``fused_predict``;
- forest, gather and GEMM forms: probabilities within ``atol=1e-5`` of
  the un-sharded mean, labels equal to JAX's tree-sharded predicts on rows
  whose top-two gap exceeds 2e-5;
- SVC, torch and kernel forms: decisions within ``1e-5`` of the largest
  coefficient sum of JAX's single-device decisions, labels equal to JAX's
  SV-sharded predicts on rows whose smallest |decision| exceeds it;
- the fits: GNB within 1e-6 relative of JAX's; k-means assignments equal
  to the port's single-device fit and, for a Lloyd run from given
  centers, to JAX's; the forest bitwise JAX's given JAX's draws; the SVC
  within the SVC atol of the port's single-device fit and held-out
  accuracy within 0.02 of JAX's.

Every wait has a timeout and both ranks are killed on any failure: a
lost peer fails the test, never hangs it."""

import dataclasses
import datetime
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import chip_smoke
import torch_multihost_worker as worker
from test_torch_train import jax_draws
from traffic_classifier_sdn_tpu.core import flow_table as jft
from traffic_classifier_sdn_tpu.ingest.batcher import (
    FlowStateEngine as JaxFlowStateEngine,
)
from traffic_classifier_sdn_tpu.ingest.protocol import (
    TelemetryRecord as JaxRecord,
)
from traffic_classifier_sdn_tpu.models import forest as jforest
from traffic_classifier_sdn_tpu.models import knn as jknn
from traffic_classifier_sdn_tpu.models import logreg as jlogreg
from traffic_classifier_sdn_tpu.models import svc as jsvc
from traffic_classifier_sdn_tpu.parallel import forest_sharded as jfs
from traffic_classifier_sdn_tpu.parallel import knn_sharded as jks
from traffic_classifier_sdn_tpu.parallel import mesh as jmeshlib
from traffic_classifier_sdn_tpu.parallel import svc_sharded as jss
from traffic_classifier_sdn_tpu.train import distributed as jdist
from traffic_classifier_sdn_tpu.train import kmeans as jkmeans
from traffic_classifier_sdn_tpu.train import logreg as jlogreg_train
from traffic_classifier_sdn_tpu_torch import interop
from traffic_classifier_sdn_tpu_torch.ops import tree_gemm
from traffic_classifier_sdn_tpu_torch.parallel import forest_sharded as fsh
from traffic_classifier_sdn_tpu_torch.parallel import knn_sharded as ksh
from traffic_classifier_sdn_tpu_torch.parallel import mesh as meshlib
from traffic_classifier_sdn_tpu_torch.parallel import svc_sharded as ssh
from traffic_classifier_sdn_tpu_torch.train import kmeans as tkmeans
from traffic_classifier_sdn_tpu_torch.train import svc as tsvc

WORKER = worker.__file__
RANK_TIMEOUT_S = 120  # the longest wait for a rank to exit
PEER_TIMEOUT_S = 10  # a rank's wait for a lost peer (its gloo timeout)
CPU = torch.device("cpu")
N_DEVICES = 4  # two ranks of two shards


def _run_ranks(cmds: list) -> list:
    """``(returncode, output)`` of each rank, ``chip_smoke.run_ranks``
    waiting at most ``RANK_TIMEOUT_S`` in all and killing what runs on."""
    return [(rc, out + err)
            for rc, out, err in chip_smoke.run_ranks(cmds, RANK_TIMEOUT_S)]


def _rank_cmd(init: str, pid: int, *extra) -> list:
    return [sys.executable, WORKER, init, str(pid), "2", "--device", "cpu",
            "--shards-per-rank", "2", "--timeout", str(PEER_TIMEOUT_S),
            *extra]


def _one_process_mesh_results(inp: dict) -> dict:
    dmesh = meshlib.make_mesh(n_data=N_DEVICES, n_state=1,
                              devices=[CPU] * N_DEVICES)
    smesh = meshlib.make_mesh(n_data=1, n_state=N_DEVICES,
                              devices=[CPU] * N_DEVICES)
    return worker.run_checks(inp, dmesh, smesh, CPU)[0]


def _jax_references(inp: dict) -> dict:
    """JAX's worker's single-device references on the same inputs, in
    the JAX package on the CPU."""
    X = jnp.asarray(inp["X"])
    lp = jlogreg.Params(coef=jnp.asarray(inp["logreg"]["coef"]),
                        intercept=jnp.asarray(inp["logreg"]["intercept"]))
    kp = jknn.from_numpy(dict(inp["knn"]), dtype=jnp.float32)

    def label_fn(_p, Xt):
        return (jnp.sum(Xt, axis=1).astype(jnp.int32) % 6).astype(jnp.int32)

    single = JaxFlowStateEngine(capacity=inp["capacity"])
    single.mark_tick()
    single.ingest([JaxRecord(**{f.name: getattr(r, f.name)
                                for f in dataclasses.fields(JaxRecord)})
                   for r in inp["ticks"][0]])
    single.step()
    labels = label_fn(None, jft.features12(single.table))
    return {
        "logreg_labels": np.asarray(jlogreg.predict(lp, X)),
        "knn_labels": np.asarray(
            jknn.predict(kp, jnp.asarray(inp["knn_queries"]))),
        "render_rows": np.asarray(single.render_sample(labels, 5),
                                  np.int64).reshape(-1, 4),
    }


def _fit_draws(inp: dict) -> list:
    """JAX's draws of the inputs' forest fit (``jax_draws``)."""
    fit, kw = inp["fit"], inp["fit"]["kw"]["forest"]
    return jax_draws(kw["seed"], kw["n_trees"], fit["X"].shape[0], 12,
                     kw["max_depth"], True, 3)  # bootstrap, sqrt(12)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One two-rank run of the worker on its seeded inputs, the forest
    fit fed JAX's draws (``--fit-draws``): ``{"outs": [(rc, output)],
    "got": [(results, meta)], "inp": the inputs with those draws, "want":
    the one-process 4-shard mesh's results on them}``."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    inp = worker.seeded_inputs(N_DEVICES)
    inp["fit"]["draws"] = _fit_draws(inp)
    worker.save_draws(str(tmp / "draws.npz"), inp["fit"]["draws"])
    init = f"file://{tmp / 'rendezvous'}"
    outs = _run_ranks([_rank_cmd(init, i, "--out", str(tmp / f"rank{i}.npz"),
                                 "--fit-draws", str(tmp / "draws.npz"))
                       for i in range(2)])
    got = []
    for i, (rc, out) in enumerate(outs):
        if rc == 0:
            with np.load(tmp / f"rank{i}.npz") as z:
                got.append(({k: z[k] for k in z.files if k != "meta"},
                            json.loads(z["meta"].item())))
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # as in the ranks
    try:
        want = _one_process_mesh_results(inp)
    finally:
        torch.set_num_threads(n)
    return {"outs": outs, "got": got, "inp": inp, "want": want}


def _ranks(two_ranks) -> list:
    """Each rank's ``(results, meta)``, once both ranks exited 0 and
    printed JAX's line."""
    for i, (rc, out) in enumerate(two_ranks["outs"]):
        assert rc == 0, f"rank {i} failed:\n{out}"
        assert f"MULTIHOST OK pid={i} devices={N_DEVICES}" in out, out
    return two_ranks["got"]


def _held_to_one_process(two_ranks, keys) -> dict:
    """Every rank's ``keys`` bitwise the one-process mesh's; returns the
    one-process results."""
    want = two_ranks["want"]
    for i, (got, _) in enumerate(_ranks(two_ranks)):
        for key in keys:
            assert got[key].dtype == want[key].dtype, (i, key)
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"rank {i} {key}")
    return want


def _jax_state_mesh():
    return jmeshlib.make_mesh(n_data=1, n_state=N_DEVICES,
                              devices=jax.devices()[:N_DEVICES])


def _jax_data_mesh():
    return jmeshlib.make_mesh(n_data=N_DEVICES, n_state=1,
                              devices=jax.devices()[:N_DEVICES])


def test_two_ranks_match_the_one_process_mesh_and_jax(two_ranks):
    """Two gloo ranks of two shards each: both print JAX's line, and
    each rank's every result (logreg labels, row count, KNN labels of
    every merge and local stage, forest, SVC, fits, render rows) is
    bitwise the one-process 4-shard mesh's; JAX's four checks equal JAX's
    single-device references."""
    inp, want = two_ranks["inp"], two_ranks["want"]
    jax_ref = _jax_references(inp)
    assert want["row_count"] == 64 and len(want["render_rows"]) == 5
    for i, (got, meta) in enumerate(_ranks(two_ranks)):
        assert sorted(got) == sorted(want)
        _held_to_one_process(two_ranks, want)
        assert meta["local_shards"] == [2 * i, 2 * i + 1]
    for key, a in jax_ref.items():
        np.testing.assert_array_equal(want[key], a.astype(want[key].dtype),
                                      err_msg=key)
    np.testing.assert_array_equal(want["knn_fused_labels"],
                                  jax_ref["knn_labels"])


@pytest.mark.parametrize("when", ["before_rendezvous", "after_rendezvous"])
def test_a_failing_rank_fails_its_peer_within_the_timeout(tmp_path, when):
    """Rank 1 exits with an error before the rendezvous (a process that
    never joins) or after it (inputs it cannot read): rank 0 raises within
    its gloo timeout, and neither exits 0."""
    init = f"file://{tmp_path / 'rendezvous'}"
    if when == "before_rendezvous":
        bad = [sys.executable, "-c", "raise SystemExit(3)"]
    else:
        bad = _rank_cmd(init, 1, "--inputs", str(tmp_path / "absent"))
    t0 = time.monotonic()
    outs = _run_ranks([_rank_cmd(init, 0), bad])
    assert time.monotonic() - t0 < RANK_TIMEOUT_S
    assert outs[1][0] != 0
    rc, out = outs[0]
    assert rc != 0 and "MULTIHOST OK" not in out, out


def _init_args(monkeypatch, *args, **kw) -> dict:
    """What ``init_distributed(*args, **kw)`` hands
    ``init_process_group``."""
    seen = {}
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **got: seen.update(got))
    monkeypatch.setitem(meshlib._LOCAL_KIND, "device", None)
    meshlib.init_distributed(*args, **kw)
    return seen


def test_init_distributed_maps_jax_keywords(monkeypatch):
    """A ``host:port`` coordinator becomes a tcp:// URL, an init_method
    passes through, gloo always, the timeout finite, and ``device`` is
    the kind ``local_devices`` lists."""
    got = _init_args(monkeypatch, "10.0.0.1:1234", num_processes=2,
                     process_id=1, device="cpu")
    assert got == {"backend": "gloo", "init_method": "tcp://10.0.0.1:1234",
                   "world_size": 2, "rank": 1,
                   "timeout": datetime.timedelta(
                       seconds=meshlib.DEFAULT_TIMEOUT_S)}
    assert meshlib.local_devices() == meshlib.visible_devices("cpu")
    got = _init_args(monkeypatch, init_method="file:///tmp/r",
                     num_processes=3, process_id=0,
                     initialization_timeout=5)
    assert got["init_method"] == "file:///tmp/r"
    assert got["timeout"] == datetime.timedelta(seconds=5)
    assert _init_args(monkeypatch, coordinator_address="h:1",
                      num_processes=1,
                      process_id=0)["init_method"] == "tcp://h:1"
    with pytest.raises(ValueError):
        _init_args(monkeypatch, num_processes=1, process_id=0)
    with pytest.raises(ValueError):
        _init_args(monkeypatch, "h:1", init_method="file:///x",
                   num_processes=1, process_id=0)


def test_without_a_group_the_mesh_is_one_process():
    """No process group: rank 0 of 1, the mesh owns every slot, the
    exchange is the identity and ``shard_sum`` with a mesh is without."""
    assert meshlib.process_index() == 0 and meshlib.process_count() == 1
    m = meshlib.make_mesh(n_data=2, n_state=2, devices=[CPU] * 4)
    assert m.owners is None and not m.spans_processes
    assert m.local_shards(meshlib.DATA_AXIS) == [0, 1]
    parts = [(np.arange(3),), (np.ones(2),)]
    assert meshlib.exchange(m, meshlib.DATA_AXIS, parts) == parts
    xs = [torch.tensor([0.1, 2.0]), torch.tensor([1e8, -3.0])]
    assert torch.equal(meshlib.shard_sum(xs, m), meshlib.shard_sum(xs))
    meshlib.shutdown_distributed()  # a no-op outside a group


def test_a_one_rank_group_gives_the_one_process_results(tmp_path,
                                                        monkeypatch):
    """In a gloo group of one rank, ``make_mesh`` builds the global mesh
    (every slot owned by rank 0) and every exchange runs through the
    collective: the four checks give the one-process mesh's results,
    bitwise."""
    monkeypatch.setenv("TCSDN_SHARDS_PER_DEVICE", str(N_DEVICES))
    inp = worker.seeded_inputs(N_DEVICES)
    want = _one_process_mesh_results(inp)
    meshlib.init_distributed(init_method=f"file://{tmp_path / 'r'}",
                             num_processes=1, process_id=0,
                             initialization_timeout=PEER_TIMEOUT_S,
                             device="cpu")
    try:
        dmesh = meshlib.make_mesh(n_state=1)
        smesh = meshlib.make_mesh(n_data=1, n_state=N_DEVICES)
        assert dmesh.spans_processes
        assert dmesh.owners.ravel().tolist() == [0] * N_DEVICES
        calls = meshlib.EXCHANGE_STATS["calls"]
        got, timings = worker.run_checks(inp, dmesh, smesh, CPU)
        assert meshlib.EXCHANGE_STATS["calls"] > calls
    finally:
        meshlib.shutdown_distributed()
    assert sorted(got) == sorted(want)
    for key, a in want.items():
        np.testing.assert_array_equal(got[key], a, err_msg=key)
    assert len(timings["host_ms"]) == 1


def _clear_forest_rows(p: np.ndarray) -> np.ndarray:
    top2 = np.sort(p, axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0] > 2e-5


@pytest.mark.parametrize("form", ["gather", "gemm"])
def test_tree_sharded_forest_across_ranks(two_ranks, form):
    """The tree-sharded forest (13 trees padded to 16, 4 trees a shard,
    2 shards a rank): each rank's probabilities bitwise the one-process
    mesh's, within atol 1e-5 of the un-sharded mean, and its labels JAX's
    4-device tree-sharded predict's off near-ties."""
    key = "forest_proba" if form == "gather" else "forest_gemm_proba"
    _held_to_one_process(two_ranks, [key])
    inp = two_ranks["inp"]
    d = dict(inp["state_forest"])
    X = inp["X"]
    if form == "gather":
        want = interop.forest_params_from_numpy(d, "cpu").scores(
            torch.from_numpy(X)).numpy()
    else:
        want = tree_gemm.forest_proba_gemm(
            tree_gemm.compile_forest(d, device="cpu"),
            torch.from_numpy(X)).numpy()
    dpad = fsh.pad_trees(d, N_DEVICES)
    jm = _jax_state_mesh()
    if form == "gather":
        jlab = jfs.sharded_predict(jm, jforest.from_numpy(
            dpad, dtype=jnp.float32), n_real_trees=dpad["n_real_trees"])
    else:
        jlab = jfs.gemm_sharded_predict(jm, dpad)
    jlab = np.asarray(jlab(jnp.asarray(X)))
    clear = _clear_forest_rows(want)
    assert clear.mean() > 0.9
    for got, _ in _ranks(two_ranks):
        np.testing.assert_allclose(got[key], want, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(np.argmax(got[key], 1)[clear],
                                      jlab[clear])


@pytest.mark.parametrize("form", ["torch", "fused"])
def test_sv_sharded_svc_across_ranks(two_ranks, form):
    """The SV-sharded SVC (1,200 SVs; the kernel form's 512-SV shards
    leave shard 3, on rank 1, all padding): each rank's decisions and
    labels bitwise the one-process mesh's; decisions within the SVC atol
    of JAX's single-device ones, labels JAX's 4-device SV-sharded
    predict's (the fused one in interpret mode) off near-ties."""
    keys = (("svc_labels", "svc_decisions") if form == "torch"
            else ("svc_fused_labels", "svc_fused_decisions"))
    _held_to_one_process(two_ranks, keys)
    inp = two_ranks["inp"]
    X = jnp.asarray(inp["X"])
    jp = jsvc.from_numpy(dict(inp["svc"]))
    atol = 1e-5 * float(np.abs(np.asarray(jp.pair_coef)).sum(1).max())
    want_dec = np.asarray(jsvc.decision_ovo(jp, X))
    jm = _jax_state_mesh()
    if form == "torch":
        jfn = jss.sharded_predict(jm, jsvc.from_numpy(
            ssh.pad_support(dict(inp["svc"]), N_DEVICES)))
    else:
        jfn = jss.fused_predict(jm, jp, row_tile=64, interpret=True)
    jlab = np.asarray(jfn(X))
    clear = np.abs(want_dec).min(1) > atol
    assert clear.mean() > 0.9
    for got, _ in _ranks(two_ranks):
        np.testing.assert_allclose(got[keys[1]], want_dec, rtol=0,
                                   atol=atol)
        np.testing.assert_array_equal(got[keys[0]][clear], jlab[clear])


@pytest.mark.parametrize("merge", ["ring", "tournament"])
@pytest.mark.parametrize("form", ["torch", "fused"])
def test_knn_merge_across_ranks(two_ranks, merge, form):
    """The ring and tournament merges, their hops through
    ``mesh.permute`` between ranks: each rank's labels bitwise the
    one-process mesh's and JAX's 4-device ``ring_predict`` /
    ``tournament_predict`` (torch form) or ``fused_predict`` (Pallas,
    interpret mode)."""
    key = (f"knn_{merge}_labels" if form == "torch"
           else f"knn_fused_{merge}_labels")
    _held_to_one_process(two_ranks, [key])
    inp = two_ranks["inp"]
    jm = _jax_state_mesh()
    Xq = jnp.asarray(inp["knn_queries"])
    if form == "torch":
        dpad = ksh.pad_corpus(dict(inp["knn"]), N_DEVICES)
        jp = jknn.from_numpy(dpad, dtype=jnp.float32)
        jfn = getattr(jks, f"{merge}_predict")(
            jm, jp, pad_mask=dpad.get("pad_mask"))
    else:
        jp = jknn.from_numpy(dict(inp["knn"]), dtype=jnp.float32)
        jfn = jks.fused_predict(jm, jp, merge=merge, row_tile=16,
                                interpret=True)
    want = np.asarray(jfn(Xq))
    for got, _ in _ranks(two_ranks):
        np.testing.assert_array_equal(got[key], want)


FIT_KEYS = {
    "gnb": ("fit_gnb_theta", "fit_gnb_inv_var", "fit_gnb_log_const"),
    "kmeans": ("fit_kmeans_centers", "fit_kmeans_inertia",
               "fit_kmeans_labels", "kmeans_lloyd_labels"),
    "forest": tuple(f"fit_forest_{k}" for k in
                    ("left", "right", "feature", "threshold", "values")),
    "svc": ("fit_svc_decisions", "fit_svc_labels"),
}


@pytest.mark.parametrize("family", list(FIT_KEYS))
def test_distributed_fit_across_ranks(two_ranks, family):
    """``train/distributed.py``'s fits with every rank passing the whole
    rows: each rank's model bitwise the one-process mesh's, and within
    tests/test_torch_distributed.py's tolerance of JAX's fits on its
    4-device mesh (GNB 1e-6 relative; k-means assignments the port's
    single-device fit's, and a Lloyd run from the first k rows JAX's
    ``_lloyd``'s; the forest bitwise JAX's given JAX's draws, which only
    rank 0 read; the SVC within the SVC atol of the port's single-device
    fit, held-out accuracy within 0.02 of JAX's)."""
    want = _held_to_one_process(two_ranks, FIT_KEYS[family])
    fit = two_ranks["inp"]["fit"]
    X, y, C = fit["X"], fit["y"], fit["n_classes"]
    kw = fit["kw"].get(family, {})
    if family == "gnb":
        jg = jdist.fit_gnb(_jax_data_mesh(), X, y, C)
        for k in ("theta", "inv_var", "log_const"):
            np.testing.assert_allclose(want[f"fit_gnb_{k}"],
                                       np.asarray(getattr(jg, k)),
                                       rtol=1e-6, err_msg=k)
    elif family == "kmeans":
        Xt = X[: len(X) - len(X) % N_DEVICES]
        single, _ = tkmeans.fit(Xt, device="cpu", **kw)
        np.testing.assert_array_equal(
            want["fit_kmeans_labels"],
            single.predict(torch.from_numpy(X)).numpy())
        Xj = jnp.asarray(Xt)
        jc, _ = jkmeans._lloyd(Xj, Xj[: kw["k"]], kw["n_iter"])
        np.testing.assert_array_equal(
            want["kmeans_lloyd_labels"],
            np.asarray(jkmeans._assign(Xj, jc)[0]))
    elif family == "forest":
        jf = jdist.fit_forest(_jax_data_mesh(), X, y, C, **kw)
        for k in FIT_KEYS["forest"]:
            np.testing.assert_array_equal(
                want[k], np.asarray(getattr(jf, k[len("fit_forest_"):])),
                err_msg=k)
        assert [m["tree_draws"] for _, m in _ranks(two_ranks)] == \
            [kw["n_trees"], 0]
    else:
        single = tsvc.fit(X, y, C, device="cpu", **kw)
        Xte = torch.from_numpy(fit["X_test"])
        atol = 1e-5 * float(single.pair_coef.abs().sum(1).max())
        np.testing.assert_allclose(want["fit_svc_decisions"],
                                   single.decision_ovo(Xte).numpy(),
                                   rtol=0, atol=atol)
        jwant = jdist.fit_svc(_jax_state_mesh(), X, y, C, **kw)
        j_acc = float(np.mean(np.asarray(jsvc.predict(
            jwant, jnp.asarray(fit["X_test"]))) == fit["y_test"]))
        t_acc = float(np.mean(want["fit_svc_labels"] == fit["y_test"]))
        assert abs(t_acc - j_acc) <= 0.02, (t_acc, j_acc)


SGD_KEYS = ("sgd_loss",) + tuple(f"sgd_{k}" for k in worker.SGD_LEAVES)


def test_data_parallel_sgd_step_across_ranks(two_ranks):
    """``make_sgd(mesh=...)`` over the two ranks' four data shards, every
    rank passing the whole fit rows: each rank's losses and state bitwise
    the one-process 4-shard mesh's, and within
    tests/test_torch_graft_entry.py's tolerance of JAX's ``make_sgd`` over
    ``NamedSharding`` on a 4-device data mesh (loss rtol 1e-5, each leaf
    within 1e-5 of its largest component)."""
    want = _held_to_one_process(two_ranks, SGD_KEYS)
    fit = two_ranks["inp"]["fit"]
    n = len(fit["X"]) - len(fit["X"]) % N_DEVICES
    jm = _jax_data_mesh()
    init, step = jlogreg_train.make_sgd(1e-2)
    state = jax.device_put(init(fit["n_classes"], 12),
                           jmeshlib.replicated(jm))
    X = jax.device_put(np.asarray(fit["X"][:n], np.float32), NamedSharding(
        jm, P(jmeshlib.DATA_AXIS, None)))
    y = jax.device_put(np.asarray(fit["y"][:n], np.int32), NamedSharding(
        jm, P(jmeshlib.DATA_AXIS)))
    losses = []
    for _ in range(worker.SGD_STEPS):
        state, loss = step(state, X, y)
        losses.append(float(loss))
    np.testing.assert_allclose(want["sgd_loss"], losses, rtol=1e-5)
    for name, leaf in zip(worker.SGD_LEAVES,
                          jax.tree_util.tree_leaves(state)):
        leaf = np.asarray(leaf)
        np.testing.assert_allclose(want[f"sgd_{name}"], leaf, rtol=0,
                                   atol=1e-5 * float(np.abs(leaf).max()),
                                   err_msg=name)


@pytest.mark.parametrize("merge,blocks", [("ring", 3), ("tournament", 2)])
def test_ring_and_tournament_move_only_their_hops_blocks(two_ranks, merge,
                                                         blocks):
    """Each fused call sends and receives, on each rank, exactly its
    hops' (N, k) blocks (f32 values and int32 packed ids), point to
    point, in one ``permute`` per hop: the ring's 3 hops cross ranks once
    each (shard 1 → 2 on rank 0, 3 → 0 on rank 1), the tournament's
    XOR-1 round stays inside the ranks and its XOR-2 round sends both
    shards'. No all-gather runs (it would add a call and every shard's
    block)."""
    n_hops = {"ring": N_DEVICES - 1, "tournament": 2}[merge]
    for i, (_, meta) in enumerate(_ranks(two_ranks)):
        m = meta["merges"][merge]
        block = m["rows"] * m["k"] * 8
        assert worker.hop_blocks([0, 0, 1, 1], i)[merge] == blocks
        assert len(m["calls"]) == worker.MERGE_CALLS
        for c in m["calls"]:
            assert (c["calls"], c["bytes_sent"], c["bytes_received"]) == \
                (n_hops, blocks * block, blocks * block)


DIE_IN_RING = """
import os, sys
sys.path.insert(0, {tests!r})
import torch_multihost_worker as worker
from traffic_classifier_sdn_tpu_torch.parallel import knn_sharded as ksh

real, hops = ksh.permute, []


def permute(*a, **kw):
    hops.append(1)
    if len(hops) == 2:  # the ring's second hop: gone mid-ring
        os._exit(3)
    return real(*a, **kw)


ksh.permute = permute
sys.exit(worker.main(sys.argv[1:]))
"""


def test_a_rank_that_dies_mid_ring_fails_its_peer_within_the_timeout(
        tmp_path):
    """Rank 1 exits in the ring's second hop, with rank 0's receive for
    that hop posted: rank 0 raises from the ring's wait within its gloo
    timeout, and neither exits 0."""
    init = f"file://{tmp_path / 'rendezvous'}"
    script = DIE_IN_RING.format(tests=os.path.dirname(WORKER))
    bad = [sys.executable, "-c", script] + _rank_cmd(init, 1)[2:]
    t0 = time.monotonic()
    outs = _run_ranks([_rank_cmd(init, 0), bad])
    assert time.monotonic() - t0 < RANK_TIMEOUT_S
    assert outs[1][0] == 3
    rc, out = outs[0]
    assert rc != 0 and "MULTIHOST OK" not in out, out
    assert "in permute" in out and "_ring_merge" in out, out


def test_permute_in_one_process_moves_blocks_by_shard():
    """On a mesh of one process ``permute`` is a device move per pair,
    addressed by shard, with no exchange counted: the ring's pairs hand
    shard i's block to shard i+1, and a shard no pair names gets None."""
    m = meshlib.make_mesh(n_data=1, n_state=4, devices=[CPU] * 4)
    parts = [(torch.full((2, 3), float(i)), torch.arange(2) + i)
             for i in range(4)]
    before = dict(meshlib.EXCHANGE_STATS)
    got = meshlib.permute(m, meshlib.STATE_AXIS, parts,
                          [(i, (i + 1) % 4) for i in range(4)])
    for i in range(4):
        src = parts[(i - 1) % 4]
        assert all(torch.equal(a, b) for a, b in zip(got[i], src))
    part = meshlib.permute(m, meshlib.STATE_AXIS, parts, [(0, 2)])
    assert part[2][0].eq(0).all() and part[0] is None and part[3] is None
    assert meshlib.EXCHANGE_STATS == before
    assert meshlib.broadcast(m, meshlib.DATA_AXIS, (np.ones(2),))[0].sum() \
        == 2
