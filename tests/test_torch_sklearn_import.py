"""The port's sklearn importer (``io/sklearn_import.py``) and the classify
CLI's reference-pickle default (``--checkpoint-dir``,
``models.load_reference_model``) against the JAX package's.

- Pickles that scikit-learn (where installed) writes here for all six
  families, and the committed ``tests/data/reference_pickles/``
  (``tools/torch_reference_pickles.py``: the reference checkpoints'
  shapes), import to dicts bitwise equal to the JAX importer's.
- The classify serves with no ``--native-checkpoint`` print the JAX CLI's
  stdout byte for byte (the JAX serial serve, ``--pipeline off``, as in
  the earlier slices' tests), and resolve the pickles' directory in the
  JAX CLI's order: ``--checkpoint-dir``, ``model.checkpoint_dir`` in
  ``--config``, ``$TCSDN_MODELS_DIR``, ``./models``.
"""

import contextlib
import io
import json
import os
import pickle

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_serve import JAX_SLICE_FLAGS, PORT_SERIAL
from test_torch_train import one_torch_thread  # noqa: F401
from traffic_classifier_sdn_tpu import cli as jcli
from traffic_classifier_sdn_tpu.io import sklearn_import as jsk
from traffic_classifier_sdn_tpu.models import load_reference_model as jload
from traffic_classifier_sdn_tpu_torch import cli as tcli
from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
from traffic_classifier_sdn_tpu_torch.io import sklearn_import as tsk
from traffic_classifier_sdn_tpu_torch.models import load_reference_model

PICKLES = os.path.join(chip_smoke.HERE, "tests", "data", "reference_pickles")
FAMILIES = tuple(tsk.IMPORTERS)


pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True, scope="module")
def _default_serving_menus():
    with pytest.MonkeyPatch.context() as mp:
        for var in ("TCSDN_KNN_TOPK", "TCSDN_SVC_KERNEL",
                    "TCSDN_FOREST_KERNEL"):
            mp.delenv(var, raising=False)
        yield


def assert_dicts_bitwise(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        a, b = got[k], want[k]
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            if b.dtype.kind == "f":
                assert np.array_equal(a.view(np.uint64 if a.itemsize == 8
                                             else np.uint32),
                                      b.view(np.uint64 if b.itemsize == 8
                                             else np.uint32)), k
            else:
                assert np.array_equal(a, b), k
        else:
            assert type(a) is type(b) and a == b, k


def _fit(family: str, X, y):
    """A small fitted sklearn estimator of ``family`` (the reference's
    hyperparameters where they matter)."""
    from sklearn.cluster import KMeans
    from sklearn.ensemble import RandomForestClassifier
    from sklearn.linear_model import LogisticRegression
    from sklearn.naive_bayes import GaussianNB
    from sklearn.neighbors import KNeighborsClassifier
    from sklearn.svm import SVC

    names = np.asarray(chip_smoke.CLASSES)[y]
    return {
        "logreg": lambda: LogisticRegression(max_iter=500).fit(X, names),
        "gnb": lambda: GaussianNB().fit(X, names),
        "kmeans": lambda: KMeans(4, n_init=2, random_state=0).fit(X),
        "svc": lambda: SVC(gamma="scale").fit(X, names),
        "knn": lambda: KNeighborsClassifier(5).fit(X, names),
        "forest": lambda: RandomForestClassifier(
            12, random_state=0).fit(X, names),
    }[family]()


@pytest.mark.parametrize("family", FAMILIES)
def test_fresh_sklearn_pickles_import_as_jax(tmp_path, family):
    pytest.importorskip("sklearn")
    rng = np.random.RandomState(0)
    y = rng.randint(0, 6, 240)
    X = np.abs(rng.gamma(2.0, 50.0, (240, 12)) * (1 + y[:, None]))
    path = str(tmp_path / tsk.REFERENCE_CHECKPOINTS[family])
    with open(path, "wb") as f:
        pickle.dump(_fit(family, X, y), f)
    assert_dicts_bitwise(tsk.IMPORTERS[family](path),
                         jsk.IMPORTERS[family](path))


@pytest.mark.parametrize("family", FAMILIES)
def test_committed_pickles_import_as_jax(family):
    path = os.path.join(PICKLES, tsk.REFERENCE_CHECKPOINTS[family])
    assert_dicts_bitwise(tsk.IMPORTERS[family](path),
                         jsk.IMPORTERS[family](path))


def test_committed_pickles_have_the_reference_shapes():
    """SURVEY.md §2.2: forest 100 trees of depth ≤ 14; KNN 4,448 × 12,
    k 5; SVC 2,281 support vectors, 15 pairs; GNB 6 classes; logreg 4
    classes; k-means 4 clusters."""
    def load(family):
        return tsk.IMPORTERS[family](os.path.join(
            PICKLES, tsk.REFERENCE_CHECKPOINTS[family]))

    f = load("forest")
    assert f["left"].shape[0] == 100 and f["max_depth"] <= 14
    assert f["values"].shape[2] == 6 and f["n_features"] == 12
    k = load("knn")
    assert k["fit_X"].shape == (4448, 12) and k["n_neighbors"] == 5
    s = load("svc")
    assert s["support_vectors"].shape == (2281, 12)
    assert s["dual_coef"].shape == (5, 2281) and s["intercept"].shape == (15,)
    assert s["n_support"].tolist() == [579, 516, 759, 115, 199, 113]
    assert load("gnb")["theta"].shape == (6, 12)
    assert load("logreg")["coef"].shape == (4, 12)
    assert load("kmeans")["cluster_centers"].shape == (4, 12)


@pytest.mark.parametrize("family", FAMILIES)
def test_load_reference_model_predicts_as_jax(family):
    """The port's module of each committed pickle labels served features
    as the JAX module does, and carries the JAX class list."""
    path = os.path.join(PICKLES, tsk.REFERENCE_CHECKPOINTS[family])
    got = load_reference_model(family, path, device="cpu")
    want = jload(family, path)
    assert got.name == family and got.classes.names == want.classes.names
    X = ft.features12(chip_smoke.synthetic_table(300, 3, "cpu"))
    np.testing.assert_array_equal(
        got.predict(X).numpy(),
        np.asarray(want.predict(want.params, X.numpy())))


def _serves(sub: str, argv: list) -> tuple[str, str]:
    outs = []
    for main, extra in ((jcli.main, JAX_SLICE_FLAGS),
                        (tcli.main, ["--device", "cpu", *PORT_SERIAL])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            main([sub, *argv, *extra])
        outs.append(out.getvalue())
    return outs[0], outs[1]


@pytest.mark.parametrize("sub", ["Randomforest", "knearest", "svm",
                                 "gaussiannb"])
def test_checkpoint_dir_serve_prints_jax_stdout(sub):
    want, got = _serves(sub, [
        "--checkpoint-dir", PICKLES, "--source", "synthetic",
        "--synthetic-flows", "300", "--capacity", "512", "--max-ticks", "4",
        "--print-every", "2"])
    assert chip_smoke.parse_tables(got), "no table printed"
    assert got == want


def test_kmeans_pickle_decodes_through_the_checkpoint_era_labels():
    want, got = _serves("kmeans", [
        "--checkpoint-dir", PICKLES, "--source", "synthetic",
        "--synthetic-flows", "64", "--capacity", "128", "--max-ticks", "2",
        "--print-every", "2"])
    assert got == want
    from traffic_classifier_sdn_tpu_torch.models import kmeans

    shown = {lab for t in chip_smoke.parse_tables(got) for _, lab in t}
    assert shown <= set(kmeans.CLUSTER_LABELS_CHECKPOINT)


def _resolved(argv, monkeypatch, env=None):
    if env is None:
        monkeypatch.delenv("TCSDN_MODELS_DIR", raising=False)
    else:
        monkeypatch.setenv("TCSDN_MODELS_DIR", env)
    parser = tcli._build_parser()
    args = parser.parse_args(["Randomforest", *argv])
    tcli._apply_config(args)
    return args.checkpoint_dir


def test_checkpoint_dir_resolution_order(tmp_path, monkeypatch):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model": {"checkpoint_dir": "/from-config"}}))
    assert _resolved([], monkeypatch) == "models"
    assert _resolved([], monkeypatch, env="/from-env") == "/from-env"
    assert _resolved(["--config", str(cfg)], monkeypatch,
                     env="/from-env") == "/from-config"
    assert _resolved(["--config", str(cfg), "--checkpoint-dir", "/flag"],
                     monkeypatch, env="/from-env") == "/flag"


def test_env_models_dir_serves_the_pickles(monkeypatch):
    """With no flag, ``$TCSDN_MODELS_DIR`` names the pickles' directory
    (the JAX CLI's resolution); the serve labels through them."""
    monkeypatch.setenv("TCSDN_MODELS_DIR", PICKLES)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary = tcli.main(["gaussiannb", "--source", "synthetic",
                             "--synthetic-flows", "32", "--capacity", "64",
                             "--max-ticks", "2", "--print-every", "2",
                             "--device", "cpu", *PORT_SERIAL])
    assert summary.ticks == 2 and chip_smoke.parse_tables(out.getvalue())
    assert isinstance(summary.engine.features(), torch.Tensor)
