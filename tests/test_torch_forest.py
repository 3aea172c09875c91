"""Forest parity: the port's forest forms against the JAX package's, on
forests fitted by the JAX trainer (``train/forest.fit``) and the stump
ensemble of ``__graft_entry__._synth_forest``, carried across with
``interop.forest_params_from_numpy``.

Tolerances, stated:

- labels of the gather traversal (the semantic reference): exact;
- probabilities of the port's plain forest version (the CUDA kernel's
  CPU twin) against JAX ``tree_gemm.forest_proba_gemm`` (8 size buckets)
  and ``pallas_forest.forest_proba_pallas(interpret=True)``: ``atol=1e-5``.
  The f32 sums run in a different order — the port adds trees one by one
  in tree order, JAX reduces per bucket or per grid chunk — over ≤ 100
  terms each ≤ 1, so they differ by a few ulps of 1;
- argmax of those probabilities: exact on every row whose JAX top-two
  margin exceeds 1e-5; on the few rows below it the port's label must be
  one of JAX's near-top classes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synth_forest
from traffic_classifier_sdn_tpu.models import forest as jforest
from traffic_classifier_sdn_tpu.ops import pallas_forest
from traffic_classifier_sdn_tpu.ops import tree_gemm as jgemm
from traffic_classifier_sdn_tpu.train import forest as jtrain
from traffic_classifier_sdn_tpu_torch import interop
from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk
from traffic_classifier_sdn_tpu_torch.ops import tree_gemm as tgemm

NODE_KEYS = ("left", "right", "feature", "threshold", "values")
MARGIN = 1e-5


def _flows(seed: int, n: int):
    """Feature rows shaped like the 12 flow features (non-negative, heavy
    tailed) with a class rule plus label noise."""
    rng = np.random.RandomState(seed)
    X = rng.gamma(1.0, 100.0, (n, 12)).astype(np.float32)
    y = ((X[:, 0] > X[:, 1]).astype(int) + 2 * (X[:, 2] > 80)
         + (rng.rand(n) < 0.3) * rng.randint(0, 6, n)) % 6
    return X, y


@pytest.fixture(scope="module", params=["shallow", "deep", "stumps"])
def case(request):
    """(name, JAX params, port ForestModel, X (777, 12) f32)."""
    X_fit, y = _flows(0, 1500)
    if request.param == "shallow":
        params = jtrain.fit(X_fit, y, 6, n_trees=8, max_depth=5, n_bins=32,
                            seed=1)
    elif request.param == "deep":
        params = jtrain.fit(X_fit, y, 6, n_trees=3, max_depth=9, n_bins=64,
                            seed=2)
        left = np.asarray(params.left)
        assert max(int((left[t] != -1).sum()) for t in range(3)) > 64
    else:
        params = jforest.from_numpy(_synth_forest(), dtype=jnp.float32)
    X, _ = _flows(1, 777)  # ragged: not a multiple of any tile
    # put some inputs exactly on split thresholds (the <= edge)
    thr = np.asarray(params.threshold)
    feat = np.asarray(params.feature)
    internal = np.argwhere(np.asarray(params.left) != -1)
    rng = np.random.RandomState(2)
    for i, (t, n) in enumerate(internal[rng.permutation(len(internal))[:200]]):
        X[i, feat[t, n]] = thr[t, n]
    port = interop.forest_params_from_numpy(params, device="cpu")
    return request.param, params, port, X


def _node_arrays(params) -> dict:
    return {k: np.asarray(getattr(params, k)) for k in NODE_KEYS}


def test_gather_labels_exact(case):
    _, params, port, X = case
    want = np.asarray(jforest.predict(params, jnp.asarray(X, jnp.float32)))
    got = port.predict(torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        port.scores(torch.from_numpy(X)).numpy(),
        np.asarray(jforest.scores(params, jnp.asarray(X, jnp.float32))),
        atol=1e-6, rtol=0,
    )


def _check_against(jax_proba: np.ndarray, got: np.ndarray) -> None:
    np.testing.assert_allclose(got, jax_proba, atol=1e-5, rtol=0)
    top2 = np.sort(jax_proba, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > MARGIN
    np.testing.assert_array_equal(
        got.argmax(1)[clear], jax_proba.argmax(1)[clear]
    )
    # near-ties: the port's choice is one of JAX's top classes
    near = jax_proba >= jax_proba.max(1, keepdims=True) - MARGIN
    assert near[np.arange(len(got)), got.argmax(1)].all()
    # exact vote ties of pure leaves are the only near-ties expected
    assert (~clear).mean() < 0.1


def test_plain_matches_jax_gemm(case):
    _, params, port, X = case
    k = fk.compile_forest(port.node_arrays(), n_features=12, device="cpu")
    g = jgemm.compile_forest(_node_arrays(params), n_features=12)
    want = np.asarray(jgemm.forest_proba_gemm(g, jnp.asarray(X, jnp.float32)))
    _check_against(want, fk.forest_proba(k, torch.from_numpy(X)).numpy())


def test_plain_matches_pallas_interpret(case):
    _, params, port, X = case
    k = fk.compile_forest(port.node_arrays(), n_features=12, device="cpu")
    g = pallas_forest.compile_forest(
        _node_arrays(params), row_tile=256, tree_chunk=8, n_buckets=2,
        n_features=12,
    )
    want = np.asarray(pallas_forest.forest_proba_pallas(
        g, jnp.asarray(X, jnp.float32), interpret=True
    ))
    _check_against(want, fk.forest_proba(k, torch.from_numpy(X)).numpy())


def test_bucketed_gemm_matches_jax(case):
    """The port's size-bucketed GEMM form (8 buckets, as JAX serves)."""
    _, params, port, X = case
    groups = tgemm.compile_forest(port.node_arrays(), n_features=12,
                                  n_buckets=8, row_chunk=128, device="cpu")
    g = jgemm.compile_forest(_node_arrays(params), n_features=12)
    want = np.asarray(jgemm.forest_proba_gemm(g, jnp.asarray(X, jnp.float32)))
    _check_against(
        want, tgemm.forest_proba_gemm(groups, torch.from_numpy(X)).numpy()
    )


def _walk_records(k: fk.ForestKernelOperands, X: np.ndarray) -> np.ndarray:
    """The CUDA kernel's arithmetic in numpy: walk the node records, add
    the reached leaf rows in tree order in float32."""
    nodes = k.nodes.numpy().reshape(k.n_trees, k.n_internal, 4)
    lv = k.leaf_values.numpy()
    out = np.zeros((X.shape[0], k.n_classes), np.float32)
    for i, x in enumerate(X):
        acc = np.zeros(k.n_classes, np.float32)
        for t in range(k.n_trees):
            code = 0
            while code >= 0:
                f, thr_bits, lc, rc = nodes[t, code]
                thr = np.int32(thr_bits).view(np.float32)
                code = lc if x[f] <= thr else rc
            acc = acc + lv[t, -1 - code]
        out[i] = acc
    return out


def test_node_records_walk_equals_plain_bitwise(case):
    """The kernel's node-record layout, walked as the kernel walks it,
    reproduces the plain version bit for bit (the card check repeats this
    with the compiled kernel)."""
    _, _, port, X = case
    k = fk.compile_forest(port.node_arrays(), n_features=12, device="cpu")
    X = X[:200]
    plain = fk.forest_proba_plain(k, torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(
        _walk_records(k, X).view(np.uint32), plain.view(np.uint32)
    )


def test_root_leaf_tree_and_empty_input():
    """A tree whose root is a leaf gets an always-true split; zero rows
    give an empty (0, C) result."""
    d = _synth_forest(n_trees=3)
    d["left"][1] = -1
    d["right"][1] = -1
    k = fk.compile_forest(d, n_features=12, device="cpu")
    X = np.random.RandomState(0).rand(50, 12).astype(np.float32) * 100
    np.testing.assert_array_equal(
        _walk_records(k, X), fk.forest_proba(k, torch.from_numpy(X)).numpy()
    )
    assert fk.forest_proba(k, torch.zeros((0, 12))).shape == (0, 6)


def test_wrapper_checks_inputs():
    k = fk.compile_forest(_synth_forest(), n_features=12, device="cpu")
    with pytest.raises(ValueError, match="features"):
        fk.forest_proba(k, torch.zeros((4, 11)))
    with pytest.raises(ValueError, match="float32"):
        fk.forest_proba(k, torch.zeros((4, 12), dtype=torch.float64))
    with pytest.raises(ValueError, match="classes"):
        d = _synth_forest(n_classes=fk.MAX_CLASSES + 1)
        fk.compile_forest(d, n_features=12, device="cpu")
    bad = _synth_forest()
    bad["feature"][2, 0] = -2  # sklearn's leaf marker on an internal node
    with pytest.raises(ValueError, match="feature -2"):
        fk.compile_forest(bad, n_features=12, device="cpu")
    launches = fk.forest_proba.launches
    fk.predict(k, torch.zeros((4, 12)))
    assert fk.forest_proba.launches == launches  # the CPU twin never counts
