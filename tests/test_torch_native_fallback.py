"""The degrade ladder's host rungs and the host-label render: the port's
``native/forest.py`` + ``forest_eval.cpp`` and ``native/knn.py`` +
``knn_eval.cpp`` (its own copies of the JAX package's C++), its
``models.resolve_fallback``, and ``flow_table.top_active_flags``, against
the JAX package on the same inputs.

Tolerances, stated:

- native forest labels and probabilities, native KNN labels and votes,
  ``top_active_flags``: bitwise (the same C++ on the same bytes; the same
  ranking), non-finite rows included;
- the SVC host rung (the port's plain torch version on the CPU) against
  the JAX eager-CPU rung: decisions within 1e-5 of the largest
  coefficient sum (tests/test_torch_svc.py), labels equal on every row
  whose smallest |D| exceeds that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from traffic_classifier_sdn_tpu import models as jmodels
from traffic_classifier_sdn_tpu.core import flow_table as jft
from traffic_classifier_sdn_tpu.models import forest as jforest
from traffic_classifier_sdn_tpu.models import knn as jknn
from traffic_classifier_sdn_tpu.models import svc as jsvc
from traffic_classifier_sdn_tpu.native import forest as jnative_forest
from traffic_classifier_sdn_tpu.native import knn as jnative_knn
from traffic_classifier_sdn_tpu_torch import interop, models
from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
from traffic_classifier_sdn_tpu_torch.ingest.batcher import FlowStateEngine
from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows
from traffic_classifier_sdn_tpu_torch.native import forest as native_forest
from traffic_classifier_sdn_tpu_torch.native import knn as native_knn
from traffic_classifier_sdn_tpu_torch.native import loader
from traffic_classifier_sdn_tpu_torch.ops import rbf_kernel as rk


@pytest.fixture(scope="module")
def served():
    """Served features of a synthetic table (nonzero rows), and a copy
    with NaN/±inf in every third row."""
    X = ft.features12(chip_smoke.synthetic_table(600, 3, "cpu"))
    X = X[X.abs().sum(1) > 0][:400].contiguous()
    return X.numpy(), chip_smoke.with_nonfinite(X, every=3).numpy()


def test_sources_are_copies_built_in_the_port():
    """The C++ is the JAX package's byte for byte, and the libraries are
    built from the port's copies into the port's build directory."""
    root = native_forest.SOURCE.parents[2]
    for mod, name in ((native_forest, "forest_eval.cpp"),
                      (native_knn, "knn_eval.cpp")):
        assert mod.SOURCE.read_bytes() == (
            root / "traffic_classifier_sdn_tpu" / "native" / name
        ).read_bytes()
        lib = mod.build()
        assert lib.parent == loader.BUILD_DIR and lib.exists()
        assert lib.name.startswith(name.split(".")[0] + "-")


def test_march_native_library_is_named_by_the_host_target(monkeypatch):
    """The KNN library, built with ``-march=native``, hashes the target
    options g++ resolves for the host into its name, so a build directory
    copied from another CPU is rebuilt, not loaded; the forest library
    (no ``-march=native``) keeps one name everywhere."""
    knn_here = native_knn._lazy.path
    forest_here = native_forest._lazy.path
    assert loader.host_target()  # g++ reports the host's options
    monkeypatch.setattr(loader, "_host_target", b"another cpu")
    assert native_knn._lazy.path != knn_here
    assert native_knn._lazy.path.name.startswith("knn_eval-")
    assert native_forest._lazy.path == forest_here


@pytest.mark.parametrize("rows", ["finite", "nonfinite"])
def test_native_forest_bitwise_equals_jax(served, rows):
    X = served[rows == "nonfinite"]
    d = chip_smoke.random_forest(0, served[0], n_trees=12)
    port = native_forest.NativeForest(d)
    ref = jnative_forest.NativeForest(d)
    np.testing.assert_array_equal(port.predict(X), ref.predict(X))
    np.testing.assert_array_equal(port.predict_proba(X).view(np.uint64),
                                  ref.predict_proba(X).view(np.uint64))
    assert (port.predict(X) == port.predict_proba(X).argmax(1)).all()
    port.close()
    with pytest.raises(RuntimeError, match="closed"):
        port.predict(X)


@pytest.mark.parametrize("rows", ["finite", "nonfinite"])
def test_native_knn_bitwise_equals_jax(served, rows):
    X = served[rows == "nonfinite"]
    d = chip_smoke.random_knn(0, served[0], n_rows=300)
    port = native_knn.NativeKnn(d)
    ref = jnative_knn.NativeKnn(d)
    np.testing.assert_array_equal(port.predict(X), ref.predict(X))
    np.testing.assert_array_equal(port.votes(X), ref.votes(X))
    assert (port.predict(X) == port.votes(X).argmax(1)).all()
    with pytest.raises(ValueError, match="n_neighbors"):
        native_knn.NativeKnn(dict(d, n_neighbors=65))


def _families(X):
    return {
        "forest": (chip_smoke.random_forest(0, X, n_trees=12),
                   interop.forest_params_from_numpy, jforest),
        "knn": (chip_smoke.random_knn(0, X, n_rows=300),
                interop.knn_params_from_numpy, jknn),
        "svc": (chip_smoke.random_svc(0, X, n_sv=150),
                interop.svc_params_from_numpy, jsvc),
    }


@pytest.mark.parametrize("family,kind", [("forest", "native-forest"),
                                         ("knn", "native-knn"),
                                         ("svc", "plain-cpu")])
def test_resolve_fallback_matches_jax(served, family, kind):
    """Each family's host rung has the JAX kind's counterpart and gives
    the JAX rung's labels (SVC: on rows clear of the decision rounding),
    and ``argmax(scores) == predict``."""
    X = served[0]
    d, carry, jmod = _families(X)[family]
    jp = jmod.from_numpy(d)
    port = models.resolve_fallback(family, carry(d if family == "forest"
                                                 else jp, device="cpu"))
    ref = jmodels.resolve_fallback(family, jp)
    assert port.kind == kind
    assert ref.kind == ("eager-cpu" if family == "svc" else kind)
    got, want = port.predict(X), ref.predict(X)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(np.argmax(port.scores(X), 1), got)
    if family != "svc":
        np.testing.assert_array_equal(got, want)
        return
    atol = 1e-5 * float(np.abs(np.asarray(jp.pair_coef)).sum(1).max())
    D_port = rk.decision_ovo(rk.compile_svc(carry(jp, device="cpu")),
                             torch.from_numpy(X)).numpy()
    D_jax = np.asarray(jsvc.decision_ovo(jp, jnp.asarray(X)))
    np.testing.assert_allclose(D_port, D_jax, atol=atol, rtol=0)
    clear = np.abs(D_jax).min(1) > atol
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(got[clear], want[clear])


@pytest.mark.parametrize("family", ["forest", "knn"])
def test_without_gpp_forest_and_knn_fall_back_to_the_plain_version(
        served, monkeypatch, family):
    """Where the native evaluators cannot be built, forest and KNN take the
    plain torch version on the CPU, as SVC always does."""
    X = served[0]
    d, carry, jmod = _families(X)[family]
    params = carry(d if family == "forest" else jmod.from_numpy(d),
                   device="cpu")
    monkeypatch.setattr(native_forest, "available", lambda: False)
    monkeypatch.setattr(native_knn, "available", lambda: False)
    fb = models.resolve_fallback(family, params)
    assert fb.kind == "plain-cpu"
    predict, operands = models._build_serving_path(family, params)
    np.testing.assert_array_equal(
        fb.predict(X), predict(operands, torch.from_numpy(X)).numpy())
    assert models.resolve_fallback("xgboost", params) is None


def test_top_active_flags_bitwise_equals_jax():
    """The ranked flags of the host-label render, on a table with idle,
    fresh and unused slots, equal JAX's (and ``top_active_render``'s)."""
    syn = SyntheticFlows(n_flows=150, seed=4, churn=0.3)
    eng = FlowStateEngine(256, device="cpu")
    from traffic_classifier_sdn_tpu.ingest.batcher import (
        FlowStateEngine as JaxEngine,
    )

    jeng = JaxEngine(256)
    for _ in range(4):
        recs = syn.tick()
        for e in (eng, jeng):
            e.mark_tick()
            e.ingest(recs)
            e.step()
    floor = eng.tick_floor
    assert floor == jeng.tick_floor
    for n in (16, 200, 256):
        got = ft.top_active_flags(eng.table, n, floor)
        want = jft.top_active_flags(jeng.table, n, np.int32(floor))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        labels = torch.arange(256, dtype=torch.int32) % 6
        full = ft.top_active_render(eng.table, labels, n, floor)
        for g, w in zip(got, (full[0], full[1], full[3], full[4])):
            assert torch.equal(g, w)
        # the engine's render joins host labels on the same ranked rows
        assert (eng.render_sample(labels.numpy(), n)
                == eng.render_sample(labels, n))


def test_plain_fallback_runs_on_the_cpu_copy(served):
    """The plain-CPU rung stages its params to the CPU once: the operands
    it runs on are CPU tensors, separate from the serving params."""
    X = served[0]
    d, carry, jmod = _families(X)["svc"]
    params = carry(jmod.from_numpy(d), device="cpu")
    fb = models.resolve_fallback("svc", params)
    labels = fb.predict(X)
    g = rk.compile_svc(params)
    np.testing.assert_array_equal(
        labels, rk.predict(g, torch.from_numpy(X)).numpy())
    params.sv_hi.zero_()  # the serving params change; the rung's copy not
    np.testing.assert_array_equal(fb.predict(X), labels)
