"""The port's multi-host path on the CPU: two ranks of
``tests/torch_multihost_worker.py`` over ``torch.distributed`` (gloo, a
``file://`` rendezvous in the test's directory), two shards each, held
bitwise to the one-process 4-shard mesh and to JAX's single-device
references — the twin of ``tests/test_multihost.py``, which skips on the
CPU (XLA's CPU backend runs no multiprocess computation), where these
ranks run.

Every wait has a timeout and both ranks are killed on any failure: a
lost peer fails the test, never hangs it."""

import dataclasses
import datetime
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torch_multihost_worker as worker
from traffic_classifier_sdn_tpu.core import flow_table as jft
from traffic_classifier_sdn_tpu.ingest.batcher import (
    FlowStateEngine as JaxFlowStateEngine,
)
from traffic_classifier_sdn_tpu.ingest.protocol import (
    TelemetryRecord as JaxRecord,
)
from traffic_classifier_sdn_tpu.models import knn as jknn
from traffic_classifier_sdn_tpu.models import logreg as jlogreg
from traffic_classifier_sdn_tpu_torch import interop
from traffic_classifier_sdn_tpu_torch.parallel import forest_sharded as fsh
from traffic_classifier_sdn_tpu_torch.parallel import knn_sharded as ksh
from traffic_classifier_sdn_tpu_torch.parallel import mesh as meshlib
from traffic_classifier_sdn_tpu_torch.parallel import svc_sharded as ssh
from traffic_classifier_sdn_tpu_torch.train import distributed as tdist

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


def test_two_ranks_match_the_one_process_mesh_and_jax(tmp_path):
    """Two gloo ranks of two shards each: both print JAX's line, and
    each rank's logreg labels, row count, KNN labels (torch and kernel
    local stages) and render rows are bitwise those of the one-process
    4-shard mesh, and equal JAX's single-device references."""
    init = f"file://{tmp_path / 'rendezvous'}"
    outs = _run_ranks([_rank_cmd(init, i, "--out",
                                 str(tmp_path / f"rank{i}.npz"))
                       for i in range(2)])
    for i, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {i} failed:\n{out}"
        assert f"MULTIHOST OK pid={i} devices={N_DEVICES}" in out, out
    inp = worker.seeded_inputs(N_DEVICES)
    want = _one_process_mesh_results(inp)
    jax_ref = _jax_references(inp)
    assert want["row_count"] == 64 and len(want["render_rows"]) == 5
    for i in range(2):
        with np.load(tmp_path / f"rank{i}.npz") as got:
            assert sorted(k for k in got.files if k != "meta") \
                == sorted(want)
            for key, a in want.items():
                assert got[key].dtype == a.dtype, key
                np.testing.assert_array_equal(got[key], a, err_msg=key)
            meta = got["meta"].item()
        assert f'"local_shards": [{2 * i}, {2 * i + 1}]' in meta
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


def _spanning_mesh(n_data: int, n_state: int):
    """A mesh whose slots rank 0 and rank 1 own, half each (built
    directly: no group is needed to refuse it)."""
    n = n_data * n_state
    grid = np.empty(n, dtype=object)
    grid[:] = [CPU] * n
    owners = np.repeat([0, 1], n // 2).reshape(n_data, n_state)
    return meshlib.Mesh(grid.reshape(n_data, n_state), owners)


@pytest.mark.parametrize("merge", ["ring", "tournament"])
def test_ring_and_tournament_refuse_a_mesh_spanning_processes(merge):
    d = {"fit_X": np.arange(48.0).reshape(4, 12), "y": np.arange(4) % 2,
         "n_neighbors": 1, "classes": np.arange(2)}
    kp = interop.knn_params_from_numpy(d, CPU)
    mesh = _spanning_mesh(1, 2)
    for build in (lambda: ksh.fused_predict(mesh, kp, merge=merge),
                  lambda: getattr(ksh, f"{merge}_predict")(mesh, kp)):
        with pytest.raises(NotImplementedError, match="item 11"):
            build()


@pytest.mark.parametrize("build", [
    lambda m: fsh.sharded_proba(m, None),
    lambda m: fsh.gemm_sharded_proba(m, {}),
    lambda m: ssh.sharded_decision(m, None),
    lambda m: ssh.fused_decision(m, None),
], ids=["forest", "forest_gemm", "svc", "svc_fused"])
def test_state_sharded_forest_and_svc_refuse_a_spanning_mesh(build):
    with pytest.raises(NotImplementedError, match="item 12"):
        build(_spanning_mesh(1, 2))


@pytest.mark.parametrize("fit", ["fit_gnb", "fit_kmeans", "fit_forest",
                                 "fit_svc"])
def test_distributed_training_refuses_a_spanning_mesh(fit):
    X = np.zeros((4, 12))
    args = (X,) if fit == "fit_kmeans" else (X, np.zeros(4), 2)
    with pytest.raises(NotImplementedError, match="item 13"):
        getattr(tdist, fit)(_spanning_mesh(2, 1), *args)
