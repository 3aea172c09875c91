"""The port's analysis toolkit (``analysis/``: ``StandardScaler``,
``PCA``, ``accuracy``, ``confusion_matrix``, ``match_clusters``,
``clustering_accuracy``, ``figures.save_all``) and the ``analyze``
subcommand against the JAX package's on the same seeded inputs, JAX in
float64 (x64 on, as the test harness sets it), the port in float64 on
the CPU.

Tolerance 1e-6 (absolute, on values of order 1 — the scaled features'
statistics, unit-norm components, variance ratios, accuracies): the two
packages reduce in different orders, which moves float64 results by
~1e-15, and the accuracies come from float32 predicts of float64 fits,
which agree row for row on these seeds.
"""

import contextlib
import io
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_train import one_torch_thread  # noqa: F401
from traffic_classifier_sdn_tpu import cli as jcli
from traffic_classifier_sdn_tpu.analysis import eval as jeval
from traffic_classifier_sdn_tpu.analysis import figures as jfigures
from traffic_classifier_sdn_tpu.analysis import preprocess as jpre
from traffic_classifier_sdn_tpu.io.datasets import load_reference_datasets
from traffic_classifier_sdn_tpu_torch import cli as tcli
from traffic_classifier_sdn_tpu_torch.analysis import eval as teval
from traffic_classifier_sdn_tpu_torch.analysis import figures as tfigures
from traffic_classifier_sdn_tpu_torch.analysis import preprocess as tpre

TOL = 1e-6
NUMBERS = ("pca2_explained_variance", "pca_logreg_accuracy",
           "cluster_accuracy")


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _X(seed: int = 0, n: int = 300) -> np.ndarray:
    rng = np.random.RandomState(seed)
    X = rng.gamma(2.0, 50.0, (n, 12)) * (10.0 ** rng.randint(0, 6, 12))
    X[:, 7] = 3.0  # a zero-variance column: scale 1
    return X


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("datasets")
    chip_smoke.reference_csvs(str(d), rows=48, files=chip_smoke.NOTEBOOK_CSVS)
    return str(d)


def test_scaler_within_tol_of_jax():
    X = _X()
    jp = jpre.StandardScaler.fit(X)
    tp = tpre.StandardScaler.fit(torch.from_numpy(X))
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL)
    assert float(tp.scale[7]) == 1.0
    Z = tpre.StandardScaler.transform(tp, torch.from_numpy(X))
    np.testing.assert_allclose(
        Z.numpy(), np.asarray(jpre.StandardScaler.transform(jp, X)),
        atol=TOL)
    np.testing.assert_allclose(
        tpre.StandardScaler.inverse_transform(tp, Z).numpy(), X, rtol=TOL)


@pytest.mark.parametrize("k", [2, 5])
def test_pca_within_tol_of_jax(k):
    """Components with sklearn's sign (each one's largest |loading|
    positive), explained variance and its ratio."""
    Xs = np.array(jpre.StandardScaler.transform(
        jpre.StandardScaler.fit(_X(1)), _X(1)))
    jp = jpre.PCA.fit(Xs, k)
    tp = tpre.PCA.fit(torch.from_numpy(Xs), k)
    np.testing.assert_allclose(tp.components.numpy(),
                               np.asarray(jp.components), atol=TOL)
    np.testing.assert_allclose(tp.explained_variance_ratio.numpy(),
                               np.asarray(jp.explained_variance_ratio),
                               atol=TOL)
    np.testing.assert_allclose(tp.explained_variance.numpy(),
                               np.asarray(jp.explained_variance), rtol=TOL)
    c = tp.components.numpy()
    assert (c[np.arange(k), np.abs(c).argmax(1)] > 0).all()
    Z = tpre.PCA.transform(tp, torch.from_numpy(Xs))
    np.testing.assert_allclose(Z.numpy(),
                               np.asarray(jpre.PCA.transform(jp, Xs)),
                               atol=1e-5)


def test_accuracy_and_confusion_matrix_equal_jax():
    rng = np.random.RandomState(2)
    yt, yp = rng.randint(0, 6, 500), rng.randint(0, 6, 500)
    want = np.asarray(jeval.confusion_matrix(yt, yp, 6))
    got = teval.confusion_matrix(torch.from_numpy(yt), torch.from_numpy(yp),
                                 6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[1].sum() == (yt == 1).sum()  # rows are the true labels
    assert abs(float(teval.accuracy(torch.from_numpy(yt),
                                    torch.from_numpy(yp)))
               - float(jeval.accuracy(yt, yp))) <= TOL


def test_match_clusters_ties_and_empty_clusters_equal_jax():
    """Cluster 0: a tie of labels 2 and 4 goes to 2; cluster 1 holds no
    row and maps to 0; cluster 2 votes 5."""
    cids = np.array([0, 0, 0, 0, 2, 2, 2, 3])
    y = np.array([4, 2, 2, 4, 5, 5, 1, 3])
    want = np.asarray(jeval.match_clusters(cids, y, 4, 6))
    got = teval.match_clusters(torch.from_numpy(cids), torch.from_numpy(y),
                               4, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [2, 0, 5, 3]
    assert abs(float(teval.clustering_accuracy(
        torch.from_numpy(cids), torch.from_numpy(y), 4, 6))
        - float(jeval.clustering_accuracy(cids, y, 4, 6))) <= TOL


def test_save_all_numbers_within_tol_of_jax(data_dir, tmp_path):
    ds = load_reference_datasets(data_dir)
    want = jfigures.save_all(ds, str(tmp_path / "jax"))
    got = tfigures.save_all(ds, str(tmp_path / "port"), device="cpu")
    for k in NUMBERS:
        assert abs(got[k] - want[k]) <= TOL, (k, got[k], want[k])
    assert list(got["paths"]) == list(want["paths"])
    numbers_only = tfigures.save_all(ds, None, device="cpu")
    assert numbers_only["paths"] == {}
    for k in NUMBERS:
        assert numbers_only[k] == got[k]


def test_analyze_prints_jax_numbers_and_writes_four_pngs(data_dir, tmp_path):
    outs = []
    for main, out, extra in ((jcli.main, tmp_path / "j", []),
                             (tcli.main, tmp_path / "t", ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["analyze", "--data-dir", data_dir, "--out", str(out),
                  *extra])
        outs.append(buf.getvalue().replace(str(out), "OUT"))
    assert outs[1] == outs[0]
    pngs = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert pngs == ["cluster_centers.png", "cluster_scatter.png",
                    "decision_boundary.png", "pca_scatter.png"]
    for p in (tmp_path / "t").iterdir():
        assert p.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_analyze_without_matplotlib_exits_cleanly(data_dir, tmp_path,
                                                  monkeypatch):
    import importlib.util

    find = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib"
                        else find(name, *a))
    with pytest.raises(SystemExit) as ei:
        tcli.main(["analyze", "--data-dir", data_dir, "--out",
                   str(tmp_path / "x"), "--device", "cpu"])
    assert "matplotlib" in str(ei.value.code)
    assert not (tmp_path / "x").exists()


def test_numbers_need_no_matplotlib(data_dir):
    """``save_all(ds, None)`` runs in an interpreter where matplotlib
    cannot be imported, as on a machine without it."""
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("blocked")
sys.meta_path.insert(0, Block())
from traffic_classifier_sdn_tpu_torch.analysis import figures
from traffic_classifier_sdn_tpu_torch.io.datasets import load_reference_datasets
res = figures.save_all(load_reference_datasets({data_dir!r}), None,
                       device="cpu")
assert "matplotlib" not in sys.modules
print(res["cluster_accuracy"])
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=chip_smoke.HERE)
    assert proc.returncode == 0, proc.stderr
    assert 0.0 < float(proc.stdout) <= 1.0
