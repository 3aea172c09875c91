"""``tools/torch_bench_openset.py`` against ``tools/bench_openset.py``:
both on the same seeded class-shaped data (the JAX tool on the CPU, the
twin with ``--device cpu``), a pair of runs per group of families. The
same keys and ROC length; the accuracies, the operating point (TPR, FPR)
and the AUCs within ``TOL`` = 0.02 of JAX's — the families' fits differ
from JAX's only within the tolerances of tests/test_torch_train.py (the
retrains are held to 0.02 of accuracy there), and the threshold within
5 % (it is ``margin × max`` of calibration scores keyed by each
family's own labels)."""

import pytest

from torch_bench_pairs import assert_same_keys, pair

TOL = 0.02
CLOSE = ("closed_accuracy", "gated_accuracy", "accuracy_delta",
         "unknown_tpr_at_threshold", "known_fpr_at_threshold",
         "mahalanobis_auc", "family_score_auc")


@pytest.mark.parametrize("families,rows", [("logreg,gnb", 128),
                                           ("kmeans,knn", 128), ("svc", 64),
                                           ("forest", 64)])
def test_openset_figures_within_tolerance_of_jax(families, rows):
    """At 64 rows a class for the slowest fits (the JAX SVC and forest)."""
    args = ["--rows-per-class", str(rows), "--families", families]
    (want,), (got,) = pair("bench_openset.py", args)
    assert got["bench"] == want["bench"] == "openset_eval"
    assert_same_keys(want, got)
    for key in ("margin", "known_classes", "rows_per_class", "seed",
                "platform", "notes"):
        assert got[key] == want[key], key
    assert list(got["families"]) == families.split(",")
    for fam, w in want["families"].items():
        g = got["families"][fam]
        assert set(g) == set(w)
        for key in CLOSE:
            assert abs(g[key] - w[key]) <= TOL, (fam, key, g[key], w[key])
        assert abs(g["threshold"] / w["threshold"] - 1) <= 0.05, fam
        assert len(g["roc"]) == len(w["roc"]) == 21
