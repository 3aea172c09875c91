"""The port's trainers (``traffic_classifier_sdn_tpu_torch/train/``) against
the JAX package's on the same seeded numpy inputs, and the drift loop's
refit entry point (``serving/retrain.fit_family``).

Tolerances, by trainer:

- forest: node stacks (``left``, ``right``, ``feature``, ``threshold``,
  ``values``) bitwise equal to JAX ``train/forest.fit`` given JAX's own
  random draws (its bootstrap weights and per-level feature scores, made
  here with ``jax.random`` exactly as JAX makes them and handed to the
  port's ``build_tree`` in place of its ``tree_draws``). Counts are
  integer-valued float32 below 2^24, so every histogram, cumsum and sum
  of squares is exact in either package;
- gnb: the folded ``theta``, ``inv_var`` and ``log_const`` within 1e-6
  relative of JAX's (both fit in float64 here; the fold rounds once to
  float32);
- knn: the corpus arrays bitwise (``fit_X``, ``fit_X_lo``, ``fit_y``) and
  the labels equal;
- svc and logreg: held-out accuracy within 0.02 of JAX's trainers (other
  optimizers' arithmetic: the trainer rule, accuracy not bits);
- kmeans: the port draws k-means++ seeds from a torch generator, JAX from
  ``jax.random``; on well-separated blobs both reach the same clustering
  (mode-matched accuracy 1.0) and inertia within 1e-6 relative.
"""

import jax
import numpy as np
import pytest
import torch

from traffic_classifier_sdn_tpu.models import gnb as jgnb
from traffic_classifier_sdn_tpu.models import kmeans as jkmeans
from traffic_classifier_sdn_tpu.models import knn as jknn
from traffic_classifier_sdn_tpu.models import logreg as jlogreg
from traffic_classifier_sdn_tpu.models import svc as jsvc
from traffic_classifier_sdn_tpu.serving import retrain as jretrain
from traffic_classifier_sdn_tpu.train import forest as jforest_train
from traffic_classifier_sdn_tpu.train import gnb as jgnb_train
from traffic_classifier_sdn_tpu.train import knn as jknn_train
from traffic_classifier_sdn_tpu.train import logreg as jlogreg_train
from traffic_classifier_sdn_tpu.train import svc as jsvc_train
from traffic_classifier_sdn_tpu_torch import interop
from traffic_classifier_sdn_tpu_torch.models import (
    MODEL_CLASSES,
    make_loaded_model,
)
from traffic_classifier_sdn_tpu_torch.models.base import ClassList
from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk
from traffic_classifier_sdn_tpu_torch.serving import retrain
from traffic_classifier_sdn_tpu_torch.train import forest as tforest
from traffic_classifier_sdn_tpu_torch.train import gnb as tgnb
from traffic_classifier_sdn_tpu_torch.train import knn as tknn
from traffic_classifier_sdn_tpu_torch.train import kmeans as tkmeans
from traffic_classifier_sdn_tpu_torch.train import logreg as tlogreg
from traffic_classifier_sdn_tpu_torch.train import svc as tsvc
from traffic_classifier_sdn_tpu_torch.utils import faults

FOREST_FIELDS = ("left", "right", "feature", "threshold", "values")


@pytest.fixture
def one_torch_thread():
    """The port's CPU fits issue many small torch ops; one intra-op
    thread each keeps them from contending with the suite's other
    workers for every core. The test modules of the port's trainers
    share this one fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def blobs(seed: int, n: int, n_classes: int = 3, spread: float = 0.35):
    """(X float32 (n, 12), y int32): per-class gamma centers with
    multiplicative noise — positive, traffic-scaled features."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, n_classes, n)
    centers = rng.gamma(2.0, 300.0, (n_classes, 12))
    X = np.abs(centers[y] * (1 + spread * rng.randn(n, 12)))
    return X.astype(np.float32), y.astype(np.int32)


def jax_draws(seed: int, n_trees: int, n_rows: int, n_features: int,
              max_depth: int, bootstrap: bool, max_features: int) -> list:
    """The draws JAX's ``train/forest.fit`` makes, tree by tree: the
    bootstrap weights of ``_bootstrap_weights`` and the per-level
    ``jax.random.uniform`` feature scores, from the same key splits."""
    out = []
    for key in jax.random.split(jax.random.PRNGKey(seed), n_trees):
        k_boot, k_feat = jax.random.split(key)
        w = (np.asarray(jforest_train._bootstrap_weights(
            k_boot, n_rows, 0, n_rows)) if bootstrap
            else np.ones(n_rows, np.float32))
        scores = []
        if max_features < n_features:
            keys = jax.random.split(k_feat, max_depth)
            scores = [np.array(jax.random.uniform(keys[d],
                                                  (2 ** d, n_features)))
                      for d in range(max_depth)]
        out.append((np.array(w), scores))
    return out


FOREST_CASES = {
    "bootstrap-sqrt": dict(n_trees=4, max_depth=5, n_bins=32,
                           bootstrap=True, max_features="sqrt", seed=3),
    "no-bootstrap-all-features": dict(n_trees=3, max_depth=4, n_bins=16,
                                      bootstrap=False, max_features=12,
                                      seed=1),
    "deep-narrow": dict(n_trees=2, max_depth=7, n_bins=64, bootstrap=True,
                        max_features=2, seed=7),
}


@pytest.mark.parametrize("case", sorted(FOREST_CASES))
def test_forest_node_stacks_equal_jax_given_jax_draws(monkeypatch, case):
    kw = FOREST_CASES[case]
    X, y = blobs(0, 300)
    y = np.where(X[:, 5] > np.median(X[:, 5]), y, (y + 1) % 3).astype(
        np.int32)
    mf = tforest.resolve_max_features(kw["max_features"], 12)
    draws = jax_draws(kw["seed"], kw["n_trees"], X.shape[0], 12,
                      kw["max_depth"], kw["bootstrap"], mf)

    def recorded(gen, tree, n_rows, n_features, max_depth, *, bootstrap,
                 max_features, device):
        w, scores = draws[tree]
        return (torch.from_numpy(w).to(device),
                [torch.from_numpy(s).to(device) for s in scores])

    monkeypatch.setattr(tforest, "tree_draws", recorded)
    want = jforest_train.fit(X, y, 3, **kw)
    got = tforest.fit(X, y, 3, device="cpu", **kw)
    assert got.max_depth == want.max_depth
    for k in FOREST_FIELDS:
        a, b = np.asarray(getattr(want, k)), getattr(got, k).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def test_forest_split_takes_the_first_maximum():
    """``jnp.argmax``'s tie rule: the first index of a row's maximum, an
    all ``-inf`` row included."""
    a = torch.tensor([[1.0, 3.0, 3.0, 0.0], [-np.inf] * 4,
                      [2.0, 2.0, 2.0, 2.0], [0.0, 0.0, 0.0, 5.0]])
    assert tforest._first_argmax(a).tolist() == [1, 0, 0, 3]
    assert tforest._first_argmax(a).tolist() == np.asarray(
        jax.numpy.argmax(jax.numpy.asarray(a.numpy()), axis=1)).tolist()


def test_forest_own_draws_fit_and_serve_through_the_kernel_layout():
    """The port's own draws: a depth-10 fit (the drift loop's depth; 8
    trees here, 100 in a serve) on a 2,048-row window keeps thresholds as
    float32 bin edges, learns the labels, and its node stacks compile for
    the forest kernel — a 2,047-slot tree fits the shared-memory stage
    beside every row tile — whose plain version labels as the gather
    traversal does."""
    X, y = blobs(1, 2048, n_classes=6)
    # a third of the labels flipped at random: the trees grow deep
    rng = np.random.RandomState(1)
    noisy = np.where(rng.rand(2048) < 1 / 3, rng.randint(0, 6, 2048), y)
    model = tforest.fit(X, noisy, 6, n_trees=8, max_depth=10, seed=0,
                        device="cpu")
    assert model.threshold.dtype == torch.float32
    assert model.left.shape == (8, 2047)
    edges = tforest.make_bins(X, 128)
    split = model.left.numpy() != -1
    thr, feat = model.threshold.numpy(), model.feature.numpy()
    assert all(thr[t, n] in edges[feat[t, n]] for t, n in zip(*np.nonzero(split)))
    Xt = torch.from_numpy(X)
    labels = model.predict(Xt)
    assert (labels.numpy() == y).mean() > 0.9  # the clean labels
    k = fk.compile_forest(model.node_arrays(), n_features=12, device="cpu")
    assert set(k.per_chunk) == set(fk.ROWS_PER_TILE)
    # the plain version's GEMM form holds (rows, trees · internal nodes)
    # matrices: a slice of the window keeps it small
    assert torch.equal(fk.predict(k, Xt[:512]), labels[:512])
    # the worst case of the layout: every slot of a depth-10 tree used
    # (1,023 internal nodes, 1,024 leaves); its 32 KB blob still fits the
    # stage beside every row tile
    full = {a: v.copy() for a, v in model.node_arrays().items()}
    M = 2047
    for t in range(full["left"].shape[0]):
        inner = np.arange(1023)
        full["left"][t, inner] = 2 * inner + 1
        full["right"][t, inner] = 2 * inner + 2
        full["feature"][t, inner] = inner % 12
        full["threshold"][t, inner] = np.float32(100.0 + inner)
        full["values"][t, 1023:M] = np.eye(6, dtype=np.float32)[
            np.arange(1024) % 6]
    k = fk.compile_forest(full, n_features=12, device="cpu")
    assert (k.n_internal, k.n_leaves) == (1023, 1024)
    assert all(k.per_chunk[r] >= 1 for r in fk.ROWS_PER_TILE)
    deep = interop.forest_params_from_numpy(dict(full, max_depth=10),
                                            device="cpu")
    assert torch.equal(fk.predict(k, Xt[:256]), deep.predict(Xt[:256]))


def test_forest_draws_are_seeded_and_shaped():
    gen = torch.Generator().manual_seed(5)
    w, scores = tforest.tree_draws(gen, 0, 50, 12, 4, bootstrap=True,
                                   max_features=3, device="cpu")
    assert w.dtype == torch.float32 and float(w.sum()) == 50.0
    assert [tuple(s.shape) for s in scores] == [(1, 12), (2, 12), (4, 12),
                                                (8, 12)]
    gen2 = torch.Generator().manual_seed(5)
    w2, scores2 = tforest.tree_draws(gen2, 0, 50, 12, 4, bootstrap=True,
                                     max_features=3, device="cpu")
    assert torch.equal(w, w2) and all(torch.equal(a, b)
                                      for a, b in zip(scores, scores2))
    w, scores = tforest.tree_draws(gen, 1, 50, 12, 4, bootstrap=False,
                                   max_features=12, device="cpu")
    assert torch.equal(w, torch.ones(50)) and scores == []


@pytest.mark.parametrize("absent", [False, True])
def test_gnb_moments_within_1e6_of_jax(absent):
    X, y = blobs(2, 400)
    if absent:  # a window that saw no row of class 1 (of 3)
        y = np.where(y == 1, 0, y).astype(np.int32)
    want = jgnb_train.fit(X, y, 3)
    got = tgnb.fit(X, y, 3, device="cpu")
    for k in ("theta", "inv_var", "log_const"):
        a = np.asarray(getattr(want, k), np.float64)
        b = getattr(got, k).numpy().astype(np.float64)
        fin = np.isfinite(a)
        assert np.array_equal(fin, np.isfinite(b)), k
        np.testing.assert_allclose(b[fin], a[fin], rtol=1e-6, err_msg=k)
    Xt = torch.from_numpy(X)
    assert np.array_equal(got.predict(Xt).numpy(),
                          np.asarray(jgnb.predict(want, X)))


def test_knn_corpus_is_the_window():
    X, y = blobs(3, 200)
    want = jknn_train.fit(X, y, n_neighbors=5, n_classes=3)
    got = tknn.fit(X, y, n_neighbors=5, n_classes=3, device="cpu")
    for k in ("fit_X", "fit_X_lo", "fit_y"):
        a, b = np.asarray(getattr(want, k)), getattr(got, k).numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    assert got.n_neighbors == 5 and got.n_classes == 3
    Xq, _ = blobs(3, 400)
    assert np.array_equal(got.predict(torch.from_numpy(Xq)).numpy(),
                          np.asarray(jknn.predict(want, Xq)))


def _accuracy(pred, y) -> float:
    return float(np.mean(np.asarray(pred) == y))


@pytest.mark.parametrize("family", ["svc", "logreg"])
def test_held_out_accuracy_within_002_of_jax(family):
    X, y = blobs(0, 3000)
    Xtr, ytr, Xte, yte = X[:600], y[:600], X[600:], y[600:]
    if family == "svc":
        want = jsvc.predict(jsvc_train.fit(Xtr, ytr, 3), Xte)
        got = tsvc.fit(Xtr, ytr, 3, device="cpu").predict(
            torch.from_numpy(Xte)).numpy()
    else:
        want = jlogreg.predict(jlogreg_train.fit(Xtr, ytr, 3), Xte)
        got = tlogreg.fit(Xtr, ytr, 3, device="cpu").predict(
            torch.from_numpy(Xte)).numpy()
    a_jax, a_port = _accuracy(want, yte), _accuracy(got, yte)
    assert a_jax > 0.9
    assert abs(a_port - a_jax) <= 0.02, (a_port, a_jax)


def test_svc_support_vectors_and_pairs():
    """The packed SVC: 15 pairs over 6 classes in (i, j) order, support
    vectors as the two-float split of window rows, every coefficient of a
    row outside a pair zero."""
    X, y = blobs(4, 240, n_classes=6)
    m = tsvc.fit(X, y, 6, n_iters=200, device="cpu")
    assert m.vote_i.tolist() == [i for i in range(6) for _ in range(i + 1, 6)]
    assert m.vote_j.tolist() == [j for i in range(6) for j in range(i + 1, 6)]
    sv = m.sv_hi.numpy().astype(np.float64) + m.sv_lo.numpy()
    rows = {tuple(r) for r in X.astype(np.float64)}
    assert all(tuple(r) in rows for r in sv)
    assert m.pair_coef.shape == (15, sv.shape[0])


def test_kmeans_fit_family_reaches_jax_clustering():
    """``fit_family('kmeans')`` runs the port's trainer at
    ``dist.fit_kmeans``' defaults (k = the class count, n_init 10, n_iter
    50, seed 0): on separated blobs its clustering mode-matches JAX's and
    its inertia is within 1e-6 relative."""
    rng = np.random.RandomState(0)
    centers = np.array([[100.0] * 12, [1000.0] * 12, [5000.0] * 12])
    y = rng.randint(0, 3, 600)
    X = (centers[y] * (1 + 0.02 * rng.randn(600, 12))).astype(np.float32)
    jp = jretrain.fit_family("kmeans", X, y, 3)
    tp = retrain.fit_family("kmeans", X, y, 3, device="cpu")
    _, t_inertia = tkmeans.fit(X, k=3, device="cpu")
    j_lab = np.asarray(jkmeans.predict(jp, X))
    t_lab = tp.predict(torch.from_numpy(X)).numpy()
    for lab in np.unique(t_lab):
        assert np.unique(j_lab[t_lab == lab]).size == 1
    c = np.asarray(jp.centers, np.float64)
    j_inertia = float(((X[:, None, :].astype(np.float64) - c[None]) ** 2
                       ).sum(-1).min(1).sum())
    np.testing.assert_allclose(t_inertia, j_inertia, rtol=1e-6)


@pytest.mark.parametrize("family", sorted(MODEL_CLASSES))
def test_fit_family_builds_a_servable_model(family):
    """Every family's refit is the port's module on the asked device, and
    its serving pair labels the window."""
    X, y = blobs(5, 120)
    small = {"forest": {"n_trees": 5}, "svc": {"n_iters": 100},
             "logreg": {"max_iter": 30}}  # short fits: the shape matters
    params = retrain.fit_family(family, X, y, 3, device="cpu",
                                **small.get(family, {}))
    assert isinstance(params, MODEL_CLASSES[family])
    assert all(b.device.type == "cpu" for b in params.buffers())
    fn, p = make_loaded_model(family, params,
                              ClassList(("a", "b", "c"))).serving_path()
    labels = fn(p, torch.from_numpy(X))
    assert labels.shape == (120,) and int(labels.max()) < 3


def test_fit_family_fault_site_and_unknown_family():
    X, y = blobs(5, 40)
    plan = faults.FaultPlan([faults.FaultRule("retrain.fit")])
    with faults.installed(plan), pytest.raises(faults.FaultInjected):
        retrain.fit_family("gnb", X, y, 3, device="cpu")
    assert plan.fires
    with pytest.raises(ValueError, match="unknown model family"):
        retrain.fit_family("tree", X, y, 3, device="cpu")
