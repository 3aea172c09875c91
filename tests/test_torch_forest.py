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

import chip_smoke
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
    """The CUDA kernel's arithmetic in numpy: stage each row's effective
    features (``x[f]`` where every other feature is finite, else NaN),
    walk the tree blobs' node records, add the reached leaf rows in tree
    order in float32."""
    blob = k.forest.numpy()
    D, C = k.n_internal, k.n_classes
    out = np.zeros((X.shape[0], C), np.float32)
    for i, x in enumerate(X):
        bad = ~np.isfinite(x)
        if bad.sum() > 1:
            x = np.full_like(x, np.nan)
        elif bad.any():
            x = np.where(bad, x, np.float32(np.nan))
        acc = np.zeros(C, np.float32)
        for t in range(k.n_trees):
            code = 0
            while code < D:
                thr = blob[t, 2 * code: 2 * code + 1].view(np.float32)[0]
                packed = int(blob[t, 2 * code + 1]) & 0xFFFFFFFF
                f = packed & (fk.MAX_FEATURES - 1)
                lc = (packed >> fk.FEATURE_BITS) & (fk.MAX_CODES - 1)
                rc = packed >> (fk.FEATURE_BITS + fk.CHILD_BITS)
                code = lc if x[f] <= thr else rc
            at = k.node_words + (code - D) * C
            acc = acc + blob[t, at: at + C].view(np.float32)
        out[i] = acc
    return out


def _nonfinite_rows(X: np.ndarray, seed: int) -> np.ndarray:
    """Rows of X with NaN, +inf or -inf in one feature, and in two (of one
    kind and of two kinds), beside untouched rows."""
    rng = np.random.RandomState(seed)
    X = X[:96].copy()
    kinds = (np.nan, np.inf, -np.inf)
    for i in range(0, 96, 4):
        f, g = rng.choice(X.shape[1], 2, replace=False)
        X[i, f] = kinds[(i // 4) % 3]
        if i % 8 == 4:  # a second non-finite feature
            X[i, g] = kinds[(i // 8) % 3]
        X[i + 1, g] = kinds[(i // 4 + 1) % 3]
    return X


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


def test_nonfinite_rows_walk_equals_plain_bitwise(case):
    """Rows with NaN, +inf or -inf in one or two features: the record
    walk on effective features reproduces the plain version (the GEMM
    form, where NaN*0 and inf*0 are NaN) bit for bit."""
    _, _, port, X = case
    k = fk.compile_forest(port.node_arrays(), n_features=12, device="cpu")
    X = _nonfinite_rows(X, 5)
    plain = fk.forest_proba_plain(k, torch.from_numpy(X)).numpy()
    assert np.isfinite(plain).all()
    np.testing.assert_array_equal(
        _walk_records(k, X).view(np.uint32), plain.view(np.uint32)
    )


def test_effective_features_is_the_onehot_selection(case):
    """``effective_features`` is what ``X @ feat_onehot`` selects, for
    every feature column."""
    _, _, _, X = case
    X = torch.from_numpy(_nonfinite_rows(X, 6))
    got = fk.effective_features(X)
    want = X @ torch.eye(12)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0))


def test_nonfinite_plain_matches_jax(case):
    """The plain version against JAX's GEMM form and the Pallas kernel in
    interpret mode on the non-finite rows, within the parity tolerance."""
    _, params, port, X = case
    X = _nonfinite_rows(X, 7)
    k = fk.compile_forest(port.node_arrays(), n_features=12, device="cpu")
    got = fk.forest_proba(k, torch.from_numpy(X)).numpy()
    g = jgemm.compile_forest(_node_arrays(params), n_features=12)
    _check_against(np.asarray(jgemm.forest_proba_gemm(
        g, jnp.asarray(X, jnp.float32))), got)
    gp = pallas_forest.compile_forest(
        _node_arrays(params), row_tile=256, tree_chunk=8, n_buckets=2,
        n_features=12,
    )
    _check_against(np.asarray(pallas_forest.forest_proba_pallas(
        gp, jnp.asarray(X, jnp.float32), interpret=True)), got)


def _reference_shaped(n_features: int = 12) -> fk.ForestKernelOperands:
    rng = np.random.RandomState(0)
    X = rng.gamma(1.0, 100.0, (500, n_features)).astype(np.float32)
    d = chip_smoke.random_forest(0, X, n_trees=100)
    return fk.compile_forest(d, n_features=n_features, device="cpu")


# (N, rows per tile chosen): the sizes tools/torch_kernel_sweep.py times,
# each shape chosen at one or more of them.
SWEEP_SHAPES = [
    (1, 32), (33, 32), (777, 32), (3000, 32), (4097, 32), (6000, 32),
    (12_000, 128), (65_536, 128), (131_072, 1024), (1 << 20, 1024),
]


@pytest.mark.parametrize("n_rows, rows", SWEEP_SHAPES)
def test_launch_shape_picks_each_shape(n_rows, rows):
    """The shape chosen at each size the sweep times, with the whole
    reference-shaped forest in one stage; 1024 threads a block in the
    tile design, one per row in the row design."""
    k = _reference_shaped()
    assert fk.launch_shape(n_rows, k) == (rows, 100)
    assert fk.smem_bytes(k, rows, 100) <= fk.SMEM_BYTES
    assert fk.blocks(n_rows, rows) == min(-(-n_rows // rows), fk.SMS)
    assert fk.threads(rows) == (rows if fk.row_design(rows) else 1024)
    assert fk.row_design(rows) == (rows > fk.MAX_TILE_ROWS)


def test_launch_shape_switches_at_each_threshold_and_fits():
    """Each shape takes over at its ``FROM_ROWS`` threshold; a forest of 64
    features, whose 1024-row X tile leaves no room for a tree, keeps
    128-row tiles at any N."""
    k = _reference_shaped()
    shapes = sorted(fk.FROM_ROWS.items(), key=lambda rl: rl[1])
    assert shapes[0] == (32, 0)
    for (before, _), (rows, least) in zip(shapes, shapes[1:]):
        assert fk.launch_shape(least - 1, k)[0] == before
        assert fk.launch_shape(least, k)[0] == rows
    wide = _reference_shaped(n_features=64)
    assert fk.trees_per_chunk(wide, 1024) == 0
    assert 1024 not in wide.per_chunk
    assert fk.launch_shape(1 << 20, wide)[0] == 128
    assert fk.smem_bytes(wide, 128, wide.per_chunk[128]) <= fk.SMEM_BYTES


def test_large_forest_split_into_tree_chunks_in_order():
    """A forest larger than one shared-memory stage is walked in chunks of
    whole trees, in tree order, each within the stage; the walk replayed
    chunk by chunk adds the same leaves in the same order."""
    rng = np.random.RandomState(1)
    X = rng.gamma(1.0, 100.0, (800, 12)).astype(np.float32)
    d = chip_smoke.random_forest(3, X, n_trees=60, node_count=(201, 301),
                                 max_depth=20)
    k = fk.compile_forest(d, n_features=12, device="cpu")
    for R in fk.ROWS_PER_TILE:
        per_chunk = fk.trees_per_chunk(k, R)
        assert per_chunk < k.n_trees
        assert fk.smem_bytes(k, R, per_chunk) <= fk.SMEM_BYTES
        assert fk.smem_bytes(k, R, per_chunk + 1) > fk.SMEM_BYTES
        chunks = fk.tree_chunks(k.n_trees, per_chunk)
        assert len(chunks) > 1
        assert [t for a, b in chunks for t in range(a, b)] == list(range(60))
    assert fk.tree_chunks(7, 3) == [(0, 3), (3, 6), (6, 7)]
    Xs = _nonfinite_rows(X, 8)[:40]
    np.testing.assert_array_equal(
        _walk_records(k, Xs).view(np.uint32),
        fk.forest_proba_plain(k, torch.from_numpy(Xs)).numpy().view(np.uint32),
    )


def test_tree_blobs_decode_to_the_importer_nodes(case):
    """Every reachable internal node's feature, threshold and children
    survive the 8-byte record packing; blobs are whole 16-byte copies."""
    _, _, port, _ = case
    d = port.node_arrays()
    k = fk.compile_forest(d, n_features=12, device="cpu")
    assert k.blob_words % 4 == 0 and k.node_words % 4 == 0
    feat, thr, left, right = (a.numpy() for a in fk.unpack_records(k))
    ops = tgemm.build_gemm_operands(d, n_features=12)
    thr_want = ops["thresholds"].reshape(k.n_trees, k.n_internal)
    for t in range(k.n_trees):
        reach = tgemm._reachable_nodes(d["left"], d["right"], t)
        internal = [n for n in reach if d["left"][t, n] != -1]
        leaves = [n for n in reach if d["left"][t, n] == -1]
        code = {n: s for s, n in enumerate(internal)}
        code.update({n: k.n_internal + s for s, n in enumerate(leaves)})
        for s, n in enumerate(internal):
            assert feat[t, s] == d["feature"][t, n]
            assert thr[t, s].view(np.int32) == thr_want[t, s].view(np.int32)
            assert (left[t, s], right[t, s]) == (code[d["left"][t, n]],
                                                 code[d["right"][t, n]])


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
    with pytest.raises(ValueError, match="features"):
        fk.compile_forest(_synth_forest(), n_features=fk.MAX_FEATURES + 1,
                          device="cpu")
    bad = _synth_forest()
    bad["feature"][2, 0] = -2  # sklearn's leaf marker on an internal node
    with pytest.raises(ValueError, match="feature -2"):
        fk.compile_forest(bad, n_features=12, device="cpu")
    launches = fk.forest_proba.launches
    fk.predict(k, torch.zeros((4, 12)))
    assert fk.forest_proba.launches == launches  # the CPU twin never counts
