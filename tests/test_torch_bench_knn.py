"""``tools/torch_bench_knn.py`` against ``tools/bench_knn.py``: both on
the committed reference-shaped KNeighbors pickle at 128 queries (the JAX
tool on the CPU, the twin with ``--device cpu``): the same two lines
(``knn_prune``, ``knn_ivf_recall``) with the same keys, the parity flags
and label parity equal, the label-agreement column and the nprobe sweep
equal, and the recall@1 column the JAX package's on the same quantizer.

The quantizers differ: the port cannot repeat ``jax.random``'s k-means++
draws (tests/test_torch_knn_ivf.py), so where the IVF lists differ the
recall at small nprobe differs too. The twin's recall column is held to
JAX's ``ivf_top1`` on the port's own quantizer (seeded, rebuilt here
in-process), carried into JAX's ``IvfParams``; at nprobe == n_lists both
tools' recall is exactly 1.0."""

import jax.numpy as jnp
import numpy as np
import torch

from torch_bench_pairs import PICKLES, assert_same_keys, pair
from traffic_classifier_sdn_tpu.models import knn as jknn
from traffic_classifier_sdn_tpu.ops import knn_ivf as jivf
from traffic_classifier_sdn_tpu_torch.io import sklearn_import as ski
from traffic_classifier_sdn_tpu_torch.models.knn import KnnModel
from traffic_classifier_sdn_tpu_torch.ops import knn_ivf as tivf

BATCH = 128
PORT_ONLY = ("knn_kernel_topk_flows_per_sec", "kernel_vs_sort_speedup",
             "kernel_bitwise_parity")


def _lines(tmp):
    args = ["--batch", str(BATCH), "--repeat", "1"]
    want, got = pair("bench_knn.py", args, jax_args=[
        "--out-prune", tmp / "jp.json", "--out-recall", tmp / "jr.json"],
        twin_args=["--out-prune", tmp / "tp.json", "--out-recall",
                   tmp / "tr.json"])
    assert [w.get("artifact") for w in want] == ["knn_prune",
                                                 "knn_ivf_recall"]
    assert [g.get("artifact") for g in got] == ["knn_prune",
                                                "knn_ivf_recall"]
    return want, got


def test_knn_bench_equals_jax(tmp_path):
    """One run of each tool (the JAX tool's compiles dominate), held three
    ways below."""
    lines = _lines(tmp_path)
    _prune_line_equals_jax(lines)
    _recall_line_equals_jax(lines)
    _recall_column_is_jax_on_the_ports_quantizer(lines)


def _prune_line_equals_jax(lines):
    (want, _), (got, _) = lines
    assert_same_keys(want, got, extra=PORT_ONLY)
    for key in ("corpus", "corpus_rows", "n_neighbors", "batch",
                "native_parity_pruned_vs_unpruned_pct", "native_votes_parity",
                "native_label_parity_vs_sort_pct", "screened_bitwise_parity",
                "platform"):
        assert got[key] == want[key], key
    assert got["corpus"] == "reference"
    assert got["kernel_bitwise_parity"] is True


def _recall_line_equals_jax(lines):
    (_, want), (_, got) = lines
    assert_same_keys(want, got, extra=PORT_ONLY)
    for key in ("corpus_rows", "n_lists", "batch", "default_nprobe",
                "nprobe_equals_K_bitwise_exact", "default_nprobe_recall_ok"):
        assert got[key] == want[key], key
    assert [r["nprobe"] for r in got["sweep"]] == \
        [r["nprobe"] for r in want["sweep"]]
    assert [r["label_agreement_vs_sort"] for r in got["sweep"]] == \
        [r["label_agreement_vs_sort"] for r in want["sweep"]]
    assert got["sweep"][-1]["recall_at_1"] == want["sweep"][-1][
        "recall_at_1"] == 1.0
    for r in got["sweep"]:
        assert_same_keys(want["sweep"][0], r)


def _recall_column_is_jax_on_the_ports_quantizer(lines):
    """The twin's queries and quantizer, rebuilt here (both seeded), fed to
    JAX's ``ivf_top1`` and ``exact_top1``: the recall@1 of every nprobe
    is the twin's."""
    _, (_, got) = lines
    d = ski.import_knn(str(PICKLES / "KNeighbors"))
    S = d["fit_X"].shape[0]
    rng = np.random.RandomState(7)
    sel = rng.choice(S, BATCH)
    Xq = np.abs(np.asarray(d["fit_X"], np.float64)[sel]
                * (1 + rng.normal(0, 0.05, (BATCH, 12)))).astype(np.float32)
    own = tivf.build(KnnModel.from_numpy(d, device="cpu"))
    jp = jknn.from_numpy(d, dtype=jnp.float32)
    jv = jivf.IvfParams(base=jp, centers=jnp.asarray(own.centers.numpy()),
                        list_idx=jnp.asarray(own.list_idx.numpy()),
                        nprobe=own.nprobe)
    Xj = jnp.asarray(Xq)
    exact = np.asarray(jivf.exact_top1(jp, Xj))
    np.testing.assert_array_equal(
        tivf.exact_top1(own.base, torch.from_numpy(Xq)).numpy(), exact)
    for r in got["sweep"]:
        top1 = np.asarray(jivf.ivf_top1(jv, Xj, r["nprobe"]))
        assert r["recall_at_1"] == round(float((top1 == exact).mean()), 5)
