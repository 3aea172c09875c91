"""Checkpoint parity: a JAX model checkpoint carried into the port's format
comes back bitwise equal — JAX ``io/checkpoint.save_model`` → JAX
``load_model`` → ``interop.{forest,knn,svc}_params_from_numpy`` → port
``save_model`` → port ``load_model``."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from __graft_entry__ import _synth_forest
from traffic_classifier_sdn_tpu.io import checkpoint as jck
from traffic_classifier_sdn_tpu.models import forest as jforest
from traffic_classifier_sdn_tpu.models import knn as jknn
from traffic_classifier_sdn_tpu.models import svc as jsvc
from traffic_classifier_sdn_tpu_torch import interop
from traffic_classifier_sdn_tpu_torch.io import checkpoint as tck
from traffic_classifier_sdn_tpu_torch.models.forest import PARAM_FIELDS

CLASSES = ("dns", "game", "ping", "quake", "telnet", "voice")


@pytest.mark.parametrize("n_trees", [1, 8])
def test_jax_checkpoint_roundtrips_bitwise(tmp_path, n_trees):
    params = jforest.from_numpy(_synth_forest(n_trees), dtype=jnp.float32)
    jck.save_model(str(tmp_path / "jax"), "forest", params, classes=CLASSES)
    loaded = jck.load_model(str(tmp_path / "jax"))
    port = interop.forest_params_from_numpy(loaded.params, device="cpu")
    tck.save_model(str(tmp_path / "port"), "forest", port, classes=CLASSES)
    back = tck.load_model(str(tmp_path / "port"), device="cpu")
    assert back.name == "forest"
    assert back.classes.names == CLASSES == loaded.classes.names
    assert back.params.max_depth == loaded.params.max_depth
    for k in PARAM_FIELDS:
        want = np.asarray(getattr(loaded.params, k))
        got = getattr(back.params, k).numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    manifest = json.loads((tmp_path / "port" / "manifest.json").read_text())
    assert set(manifest) == {
        "format_version", "model", "static", "classes", "dtypes"
    }
    assert manifest["static"] == {"max_depth": 1}


def test_load_rejects_newer_format_and_dtype_mismatch(tmp_path):
    port = interop.forest_params_from_numpy(_synth_forest(), device="cpu")
    tck.save_model(str(tmp_path), "forest", port, classes=CLASSES)
    path = tmp_path / "manifest.json"
    manifest = json.loads(path.read_text())
    path.write_text(json.dumps(dict(manifest, format_version=99)))
    with pytest.raises(ValueError, match="format_version"):
        tck.load_model(str(tmp_path), device="cpu")
    manifest["dtypes"]["left"] = "int64"
    path.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="left.npy"):
        tck.load_model(str(tmp_path), device="cpu")


def test_save_rejects_unknown_family(tmp_path):
    port = interop.forest_params_from_numpy(_synth_forest(), device="cpu")
    with pytest.raises(ValueError, match="unknown model family"):
        tck.save_model(str(tmp_path), "xgboost", port)  # no such family


def test_loaded_model_predicts_like_source(tmp_path):
    d = _synth_forest()
    port = interop.forest_params_from_numpy(d, device="cpu")
    tck.save_model(str(tmp_path), "forest", port, classes=CLASSES)
    back = tck.load_model(str(tmp_path), device="cpu")
    X = torch.from_numpy(
        np.random.RandomState(0).rand(64, 12).astype(np.float32) * 100
    )
    assert torch.equal(back.predict(X), port.predict(X))
    assert back.classes.decode(back.predict(X)[:3].numpy()) == [
        CLASSES[int(c)] for c in port.predict(X)[:3]
    ]
    fn, serve_params = back.serving_path()
    assert torch.equal(fn(serve_params, X), port.predict(X))


def _sample():
    return np.random.RandomState(0).gamma(1.0, 1e5, (200, 12)).astype(np.float32)


# family → (JAX module, seeded importer dict, interop builder, the port's
# array fields, the manifest's static fields)
FAMILIES = {
    "knn": (jknn, lambda: chip_smoke.random_knn(0, _sample(), n_rows=90),
            interop.knn_params_from_numpy, interop.KNN_FIELDS,
            {"n_neighbors": 5, "n_classes": 6}),
    "svc": (jsvc, lambda: chip_smoke.random_svc(0, _sample(), n_sv=70),
            interop.svc_params_from_numpy, interop.SVC_FIELDS,
            {"n_classes": 6, "has_lo": True}),
}


@pytest.mark.parametrize("family", ["knn", "svc"])
def test_jax_family_checkpoint_roundtrips_bitwise(tmp_path, family):
    """Every array bitwise with its dtype (int32 ``fit_y``/``vote_*``, the
    0-d f32 ``gamma``), and the int and bool static fields, through JAX
    save → load → interop → port save → load."""
    jmod, make, carry, fields, static = FAMILIES[family]
    jck.save_model(str(tmp_path / "jax"), family, jmod.from_numpy(make()),
                   classes=CLASSES)
    loaded = jck.load_model(str(tmp_path / "jax"))
    port = carry(loaded.params, device="cpu")
    tck.save_model(str(tmp_path / "port"), family, port, classes=CLASSES)
    back = tck.load_model(str(tmp_path / "port"), device="cpu")
    assert back.name == family and back.classes.names == CLASSES
    for k in fields:
        want = np.asarray(getattr(loaded.params, k))
        got = getattr(back.params, k).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8),
                                      np.atleast_1d(want).view(np.uint8))
    manifest = json.loads((tmp_path / "port" / "manifest.json").read_text())
    assert manifest["static"] == static
    for k, v in static.items():
        assert getattr(back.params, k) == v and type(getattr(back.params, k)) is type(v)
    X = torch.from_numpy(_sample()[:64])
    assert torch.equal(back.predict(X), port.predict(X))
    fn, serve_params = back.serving_path()
    assert torch.equal(fn(serve_params, X), port.predict(X))
