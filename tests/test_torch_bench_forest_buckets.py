"""``tools/torch_bench_forest_buckets.py``, held against the JAX package in
process: the JAX tool reads the reference checkpoint and dataset tree,
which the repository does not hold, so the
twin runs (``--device cpu``) on the committed reference-shaped forest
pickle with parity rows written by ``chip_smoke.reference_csvs``, and each
point's ``parity_pct`` must be what JAX's ``ops/tree_gemm`` gives at the
same bucket count on the same rows, against ``bench._numpy_forest_labels``
(of which the twin keeps a copy, held equal here)."""

import json

import jax
import jax.numpy as jnp
import numpy as np

import bench
import chip_smoke
from torch_bench_pairs import PICKLES, TOOLS, assert_same_keys, run
from traffic_classifier_sdn_tpu.io import sklearn_import as ski
from traffic_classifier_sdn_tpu.io.datasets import load_reference_datasets
from traffic_classifier_sdn_tpu.ops import tree_gemm

# the keys of the JAX tool's line (tools/bench_forest_buckets.py)
JAX_KEYS = {"metric", "platform", "batch", "parity_rows", "points",
            "best_n_buckets", "best_device_ms", "best_flows_per_sec",
            "elapsed_s"}


def test_bucket_sweep_parity_is_jax_on_the_committed_pickle(tmp_path):
    import sys

    sys.path.insert(0, str(TOOLS))
    from torch_bench_forest_buckets import numpy_forest_labels

    chip_smoke.reference_csvs(str(tmp_path), rows=128,
                              files=chip_smoke.NOTEBOOK_CSVS)
    buckets = (1, 2, 8)
    proc = run([TOOLS / "torch_bench_forest_buckets.py", "--device", "cpu",
                "--batch", "512", "--buckets", ",".join(map(str, buckets)),
                "--data-dir", tmp_path])
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["metric"] == "forest_bucket_sweep"
    assert_same_keys({k: 0 for k in JAX_KEYS}, got, extra=("parity_data",))
    assert got["parity_data"].startswith("reference datasets")

    raw = ski.import_forest(str(PICKLES / "RandomForestClassifier"))
    X = load_reference_datasets(str(tmp_path)).X
    assert got["parity_rows"] == X.shape[0] == 6 * 128
    want_labels = bench._numpy_forest_labels(raw, X)
    np.testing.assert_array_equal(numpy_forest_labels(raw, X), want_labels)
    predict = jax.jit(tree_gemm.predict)
    for nb in buckets:
        g = tree_gemm.compile_forest(raw, n_buckets=nb)
        labels = np.asarray(predict(g, jnp.asarray(X, jnp.float32)))
        want = round(float((labels == want_labels).mean() * 100.0), 3)
        point = got["points"][str(nb)]
        assert point["parity_pct"] == want, (nb, point, want)
        assert point["device_ms"] > 0
    assert got["best_n_buckets"] in buckets
