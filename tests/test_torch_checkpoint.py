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


@pytest.fixture(autouse=True, scope="module")
def _default_serving_menus():
    """The serves here run the default serving menus. A CLI given
    ``--knn-topk`` publishes it through TCSDN_KNN_TOPK for the rest of its
    process, so a serve of another module may have left it set."""
    with pytest.MonkeyPatch.context() as mp:
        for var in ("TCSDN_KNN_TOPK", "TCSDN_SVC_KERNEL",
                    "TCSDN_FOREST_KERNEL"):
            mp.delenv(var, raising=False)
        yield


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
    # the JAX manifest's fields, ``arrays_dir`` (the staged arrays) included
    jax_manifest = json.loads((tmp_path / "jax" / "manifest.json").read_text())
    assert set(manifest) == set(jax_manifest) == {
        "format_version", "model", "static", "classes", "dtypes", "arrays_dir"
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


# ---------------------------------------------------------------------------
# crash safety: a save over an existing checkpoint is all or nothing
# ---------------------------------------------------------------------------


def _gnb(value: float):
    from traffic_classifier_sdn_tpu_torch.models.gnb import GnbModel

    return GnbModel(theta=torch.full((2, 3), value),
                    inv_var=torch.full((2, 3), value / 14.0),
                    log_const=torch.full((2,), -value))


def _buffers(model) -> dict:
    return {k: v.numpy().copy() for k, v in model.named_buffers()}


def test_interrupted_save_keeps_the_old_checkpoint_whole(tmp_path,
                                                         monkeypatch):
    """Save gnb A, then gnb B over it with the second array write raising:
    the directory still loads A, every array of it, and holds no stray
    stage or temp file. (Before the arrays were staged, the load returned
    B's ``theta`` beside A's ``inv_var`` and left a ``.npy.tmp-<pid>``.)"""
    path = str(tmp_path / "ckpt")
    a = _gnb(7.0 / 2)
    tck.save_model(path, "gnb", a, classes=("ping", "voice"))
    real_save = np.save
    calls = {"n": 0}

    def dying_save(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError("disk gone mid-save")
        return real_save(*args, **kw)

    monkeypatch.setattr(tck.np, "save", dying_save)
    with pytest.raises(OSError, match="mid-save"):
        tck.save_model(path, "gnb", _gnb(7.0), classes=("ping", "voice"))
    monkeypatch.setattr(tck.np, "save", real_save)
    back = tck.load_model(path, device="cpu")
    for k, v in _buffers(a).items():
        np.testing.assert_array_equal(getattr(back.params, k).numpy(), v)
    manifest = json.loads((tmp_path / "ckpt" / "manifest.json").read_text())
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == sorted(
        ["manifest.json", manifest["arrays_dir"]])


@pytest.mark.chaos
def test_train_ckpt_write_fault_keeps_the_previous_checkpoint(tmp_path):
    """The ``train_ckpt.write`` site fires before the manifest's rename:
    the previous checkpoint still loads whole, and the next save succeeds
    and removes the earlier generation's arrays."""
    from traffic_classifier_sdn_tpu_torch.utils import faults

    path = str(tmp_path / "ckpt")
    a, b = _gnb(2.0), _gnb(5.0)
    tck.save_model(path, "gnb", a)
    plan = faults.FaultPlan([faults.FaultRule("train_ckpt.write")])
    with faults.installed(plan), pytest.raises(faults.FaultInjected):
        tck.save_model(path, "gnb", b)
    assert plan.fires
    back = tck.load_model(path, device="cpu")
    for k, v in _buffers(a).items():
        np.testing.assert_array_equal(getattr(back.params, k).numpy(), v)
    assert len([p for p in (tmp_path / "ckpt").iterdir()]) == 2
    tck.save_model(path, "gnb", b)
    back = tck.load_model(path, device="cpu")
    for k, v in _buffers(b).items():
        np.testing.assert_array_equal(getattr(back.params, k).numpy(), v)
    assert len([p for p in (tmp_path / "ckpt").iterdir()]) == 2


def test_first_layout_checkpoint_loads_and_is_replaced(tmp_path):
    """A directory of the first layout (arrays beside the manifest, no
    ``arrays_dir``) loads; a save over it stages the new arrays and
    removes the old ones beside the manifest."""
    path = tmp_path / "old"
    path.mkdir()
    a = _gnb(3.0)
    arrays = _buffers(a)
    for k, v in arrays.items():
        np.save(path / f"{k}.npy", v, allow_pickle=False)
    (path / "manifest.json").write_text(json.dumps({
        "format_version": 1, "model": "gnb", "static": {},
        "classes": ["ping", "voice"],
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
    }))
    back = tck.load_model(str(path), device="cpu")
    assert back.classes.names == ("ping", "voice")
    for k, v in arrays.items():
        np.testing.assert_array_equal(getattr(back.params, k).numpy(), v)
    tck.save_model(str(path), "gnb", _gnb(4.0))
    assert not list(path.glob("*.npy"))
    np.testing.assert_array_equal(
        tck.load_model(str(path), device="cpu").params.theta.numpy(),
        _buffers(_gnb(4.0))["theta"])
