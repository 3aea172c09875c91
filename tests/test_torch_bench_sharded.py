"""``tools/torch_bench_sharded.py`` and
``tools/torch_bench_sharded_scaling.py`` against the JAX package.

The JAX ``bench_sharded.py`` reads the reference checkpoint and dataset
tree, which the repository does not hold (its own smoke test skips), so the twin's run (``--device cpu``, the committed
reference-shaped pickles) is held against the JAX package's sharded
predicts called in process on the same pickles and queries: the twin
holds every path to the port's un-sharded model (its ``parity``), and
here JAX's sharded KNN, forest and SVC paths over the conftest's virtual
devices give the port's un-sharded labels (the forest's and SVC's off
near-ties). ``bench_sharded_scaling.py`` needs no reference tree: both
tools run in subprocesses on a toy corpus."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_bench_pairs import (
    PICKLES,
    TOOLS,
    assert_same_keys,
    pair,
    run,
)
from traffic_classifier_sdn_tpu.io import sklearn_import as jski
from traffic_classifier_sdn_tpu.models import forest as jforest
from traffic_classifier_sdn_tpu.models import knn as jknn
from traffic_classifier_sdn_tpu.models import svc as jsvc
from traffic_classifier_sdn_tpu.parallel import forest_sharded as jfsh
from traffic_classifier_sdn_tpu.parallel import knn_sharded as jksh
from traffic_classifier_sdn_tpu.parallel import mesh as jmesh
from traffic_classifier_sdn_tpu.parallel import svc_sharded as jssh
from traffic_classifier_sdn_tpu_torch.io import sklearn_import as ski
from traffic_classifier_sdn_tpu_torch.models.forest import ForestModel
from traffic_classifier_sdn_tpu_torch.models.knn import KnnModel
from traffic_classifier_sdn_tpu_torch.models.svc import SvcModel

BATCH = 256
# the result keys of the JAX tool's line, per shard count
JAX_RESULTS = {
    "state_1": {"knn_allgather_ms", "knn_ring_ms", "knn_tournament_ms",
                "forest_ms", "svc_ms", "svc_fit_cold_ms"},
    "state_2": {"knn_allgather_ms", "knn_ring_ms", "knn_tournament_ms",
                "forest_ms", "svc_ms"},
    "state_8": {"knn_allgather_ms", "knn_ring_ms", "knn_tournament_ms",
                "forest_ms", "svc_ms", "svc_fit_cold_ms"},
    "data_1": {"forest_dp_ms", "forest_fit_cold_ms"},
    "data_8": {"forest_dp_ms", "forest_fit_cold_ms"},
}
PORT_PATHS = {"knn_fused_allgather_ms", "knn_fused_ring_ms",
              "knn_fused_tournament_ms", "svc_fused_ms"}


def test_sharded_bench_holds_to_jax_on_the_committed_pickles():
    proc = run([TOOLS / "torch_bench_sharded.py", "--device", "cpu",
                "--batch", str(BATCH), "--repeats", "1"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["metric"] == "sharded_scaling_cpu_mesh"
    assert got["batch"] == BATCH
    assert {k: set(v) - PORT_PATHS for k, v in got["results"].items()} == \
        JAX_RESULTS
    assert got["parity_ok"]
    assert all(all(p.values()) for p in got["parity"].values())

    # the twin's queries, rebuilt
    rng = np.random.RandomState(0)
    X = np.abs(rng.gamma(1.5, 200.0, (BATCH, 12))).astype(np.float32)
    Xt, Xj = torch.from_numpy(X), jnp.asarray(X)
    knn_raw = ski.import_knn(str(PICKLES / "KNeighbors"))
    forest_raw = ski.import_forest(str(PICKLES / "RandomForestClassifier"))
    svc_raw = ski.import_svc(str(PICKLES / "SVC"))
    want_knn = KnnModel.from_numpy(knn_raw, device="cpu").predict(Xt).numpy()
    fp = ForestModel.from_numpy(forest_raw, device="cpu")
    proba = fp.scores(Xt).numpy()
    top2 = np.sort(proba, axis=1)[:, -2:]
    forest_clear = (top2[:, 1] - top2[:, 0]) > 1e-5
    sp = SvcModel.from_numpy(svc_raw, device="cpu")
    dec = sp.decision_ovo(Xt).numpy()
    atol = 1e-5 * float(np.abs(sp.pair_coef.numpy()).sum(1).max())
    svc_clear = np.abs(dec).min(1) > atol
    want_svc = sp.predict(Xt).numpy()

    devices = jax.devices()
    for n in (1, 2, 8):
        mesh = jmesh.make_mesh(n_data=1, n_state=n, devices=devices[:n])
        kr = jksh.pad_corpus(dict(jski.import_knn(str(PICKLES / "KNeighbors"))),
                             n)
        kp = jknn.from_numpy(kr, dtype=jnp.float32)
        for build in (jksh.sharded_predict, jksh.ring_predict,
                      jksh.tournament_predict):
            labels = np.asarray(build(mesh, kp, pad_mask=kr.get("pad_mask"))(Xj))
            np.testing.assert_array_equal(labels, want_knn)
        fr = jfsh.pad_trees(dict(jski.import_forest(
            str(PICKLES / "RandomForestClassifier"))), n)
        labels = np.asarray(jfsh.sharded_predict(
            mesh, jforest.from_numpy(fr),
            n_real_trees=fr.get("n_real_trees", fr["left"].shape[0]))(Xj))
        np.testing.assert_array_equal(labels[forest_clear],
                                      np.argmax(proba, 1)[forest_clear])
        sr = jssh.pad_support(dict(jski.import_svc(str(PICKLES / "SVC"))), n)
        labels = np.asarray(jssh.sharded_predict(
            mesh, jsvc.from_numpy(sr, dtype=jnp.float32))(Xj))
        np.testing.assert_array_equal(labels[svc_clear], want_svc[svc_clear])


def test_sharded_scaling_equals_jax():
    args = ["--corpus", "8192", "--batch", "512", "--repeats", "1"]
    (want,), (got,) = pair("bench_sharded_scaling.py", args)
    assert got["metric"] == want["metric"]
    assert_same_keys(want, got, extra=("per_device_flops_source",
                                       "shards_on_one_device",
                                       "corpus_rows_per_shard"))
    assert got["per_device_flops_source"].startswith("computed from shapes")
    assert set(got["results"]) == set(want["results"])
    for k, w in want["results"].items():
        g = got["results"][k]
        assert set(w) == set(g) - {"corpus_rows_per_shard"}
        assert g["parity_pct_vs_single"] == w["parity_pct_vs_single"] == 100.0
        assert g["merge_bytes_per_query_row"] == w["merge_bytes_per_query_row"]
        # XLA's compiled count and the shape count agree to 1 %
        assert abs(g["per_device_flops"] / w["per_device_flops"] - 1) < 0.01
    assert abs(got["per_device_flops_ratio_8v1"]
               - want["per_device_flops_ratio_8v1"]) < 0.01
