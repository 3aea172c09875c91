"""The port's IVF tier (``ops/knn_ivf.py``), its quantizer's trainer
(``train/kmeans.py``) and the native mirror, against the JAX package's
``ops/knn_ivf.py`` and ``train/kmeans.py`` — the cases of JAX's
tests/test_knn_ivf.py through the port.

The port cannot repeat ``jax.random``'s k-means++ draws, so the tier is
held to JAX's on JAX's quantizer carried across
(``interop.ivf_params_from_numpy``): votes and labels bitwise on this
seeded corpus, where the two packages' similarities order every row's
candidates alike. The port's own trainer is held to what Lloyd does from
JAX's initial centers: the same assignments, centers within rtol 1e-5
(the per-cluster sums are float32 matmuls summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traffic_classifier_sdn_tpu.models import knn as jknn
from traffic_classifier_sdn_tpu.ops import knn_ivf as jivf
from traffic_classifier_sdn_tpu.train import kmeans as jkmeans
from traffic_classifier_sdn_tpu_torch import interop
from traffic_classifier_sdn_tpu_torch import models as tmodels
from traffic_classifier_sdn_tpu_torch.models import knn as tknn
from traffic_classifier_sdn_tpu_torch.native import knn as native_knn
from traffic_classifier_sdn_tpu_torch.ops import knn_ivf as tivf
from traffic_classifier_sdn_tpu_torch.train import kmeans as tkmeans


def _corpus(rng, S, k=5, n_cls=6):
    """Flow-shaped clustered corpus (JAX tests/test_knn_ivf.py's)."""
    theta = rng.gamma(2.0, 100.0, (n_cls, 12))
    conv = -(-S // 8)
    ccls = rng.randint(0, n_cls, conv)
    base = rng.gamma(2.0, 1.0, (conv, 12)) * theta[ccls]
    rows, ys = [], []
    for i in range(conv):
        t = np.sort(rng.uniform(0.1, 1.0, 8))[:, None]
        rows.append(np.abs(base[i] * t * (1 + rng.normal(0, 0.02, (8, 12)))))
        ys += [int(ccls[i])] * 8
    return {
        "fit_X": np.concatenate(rows)[:S],
        "y": np.asarray(ys[:S], np.int32),
        "n_neighbors": k,
        "classes": np.arange(n_cls),
    }


@pytest.fixture(scope="module")
def setup():
    """JAX's IVF on its own quantizer, the port's bundle on the same
    quantizer, the port's own build, and 257 jittered queries."""
    rng = np.random.RandomState(7)
    d = _corpus(rng, 1024)
    jp = jknn.from_numpy(d, dtype=jnp.float32)
    jv = jivf.build(jp, nprobe=2, seed=0)
    tp = interop.knn_params_from_numpy(jp, device="cpu")
    tv = interop.ivf_params_from_numpy(tp, jv.centers, jv.list_idx, jv.nprobe)
    sel = rng.choice(1024, 257)
    X = np.abs(d["fit_X"][sel] * (1 + rng.normal(0, 0.05, (257, 12)))
               ).astype(np.float32)
    own = tivf.build(tp, nprobe=2, seed=0)
    return d, jp, jv, tp, tv, own, X


@pytest.mark.parametrize("nprobe", [1, 2, 3, 4, None, 32, 80])
def test_votes_equal_jax_on_the_carried_quantizer(setup, nprobe):
    """``neighbor_votes_ivf``, ``predict``, ``predict_scores`` and
    ``ivf_top1`` against JAX's at every nprobe, past K included."""
    _, _, jv, _, tv, _, X = setup
    Xj, Xt = jnp.asarray(X), torch.from_numpy(X)
    want = np.asarray(jivf.neighbor_votes_ivf(jv, Xj, nprobe))
    np.testing.assert_array_equal(
        tivf.neighbor_votes_ivf(tv, Xt, nprobe).numpy(), want)
    labels = np.asarray(jivf.predict(jv, Xj, nprobe))
    np.testing.assert_array_equal(tivf.predict(tv, Xt, nprobe).numpy(),
                                  labels)
    lab, sc = tivf.predict_scores(tv, Xt, nprobe)
    np.testing.assert_array_equal(lab.numpy(), labels)
    np.testing.assert_array_equal(sc.numpy(), want)
    np.testing.assert_array_equal(tivf.ivf_top1(tv, Xt, nprobe).numpy(),
                                  np.asarray(jivf.ivf_top1(jv, Xj, nprobe)))
    assert tivf.recall_at_1(tv, Xt, nprobe) == jivf.recall_at_1(jv, Xj, nprobe)


def test_probe_lists_equal_jax(setup):
    _, _, jv, _, tv, _, X = setup
    for nprobe in (1, 3, jv.n_lists):
        np.testing.assert_array_equal(
            tivf._probe_lists(tv, torch.from_numpy(X), nprobe).numpy(),
            np.asarray(jivf._probe_lists(jv, jnp.asarray(X), nprobe)))


@pytest.mark.parametrize("which", ["carried", "own"])
def test_nprobe_equals_K_is_exact_bitwise(setup, which):
    """The anchor: every list probed is the exact search — votes and
    labels bitwise equal to the ``sort`` tier, recall@1 exactly 1.0 —
    on JAX's quantizer and on the port's own."""
    _, _, _, tp, tv, own, X = setup
    ivf = tv if which == "carried" else own
    Xt = torch.from_numpy(X)
    K = ivf.n_lists
    np.testing.assert_array_equal(
        tivf.neighbor_votes_ivf(ivf, Xt, K).numpy(),
        tp.neighbor_votes(Xt).numpy())
    np.testing.assert_array_equal(tivf.predict(ivf, Xt, K).numpy(),
                                  tp.predict(Xt).numpy())
    np.testing.assert_array_equal(tivf.ivf_top1(ivf, Xt, K).numpy(),
                                  tivf.exact_top1(tp, Xt).numpy())
    assert tivf.recall_at_1(ivf, Xt, K) == 1.0


def test_nprobe_clamps_past_K(setup):
    *_, own, X = setup
    Xt = torch.from_numpy(X)
    np.testing.assert_array_equal(
        tivf.predict(own, Xt, own.n_lists).numpy(),
        tivf.predict(own, Xt, own.n_lists + 50).numpy())


def test_recall_monotone_and_default_positive(setup):
    *_, own, X = setup
    Xt = torch.from_numpy(X)
    r = [tivf.recall_at_1(own, Xt, n) for n in (1, 2, 4, own.n_lists)]
    assert all(b >= a - 1e-12 for a, b in zip(r, r[1:])), r
    assert r[-1] == 1.0
    assert tivf.recall_at_1(own, Xt) >= 0.9


def test_chunked_matches_unchunked(setup):
    *_, own, X = setup
    Xt = torch.from_numpy(X)
    np.testing.assert_array_equal(
        tivf.predict_chunked(own, Xt, row_chunk=64).numpy(),
        tivf.predict(own, Xt).numpy())


def test_sparse_probe_votes_over_real_members_only():
    """A probe set with fewer than k real members: the padding never
    votes (3 real votes, all class 0), on JAX's quantizer carried across
    and equal to JAX's votes."""
    rng = np.random.RandomState(3)
    a = np.abs(rng.normal(10.0, 0.1, (3, 12)))
    b = np.abs(rng.normal(1e6, 0.1, (61, 12)))
    d = {
        "fit_X": np.concatenate([a, b]),
        "y": np.asarray([0] * 3 + [1] * 61, np.int32),
        "n_neighbors": 5,
        "classes": np.arange(6),
    }
    jp = jknn.from_numpy(d, dtype=jnp.float32)
    jv = jivf.build(jp, n_clusters=2, nprobe=1, seed=0)
    tv = interop.ivf_params_from_numpy(
        interop.knn_params_from_numpy(jp, device="cpu"), jv.centers,
        jv.list_idx, jv.nprobe)
    X = np.abs(rng.normal(10.0, 0.1, (8, 12))).astype(np.float32)
    votes = tivf.neighbor_votes_ivf(tv, torch.from_numpy(X), 1).numpy()
    assert (votes.sum(axis=1) == 3).all() and (votes[:, 0] == 3).all()
    np.testing.assert_array_equal(
        votes, np.asarray(jivf.neighbor_votes_ivf(jv, jnp.asarray(X), 1)))
    assert (tivf.predict(tv, torch.from_numpy(X), 1).numpy() == 0).all()
    # the port's own build on the same blobs: same two lists
    own = tivf.build(interop.knn_params_from_numpy(jp, device="cpu"),
                     n_clusters=2, nprobe=1)
    votes = tivf.neighbor_votes_ivf(own, torch.from_numpy(X), 1).numpy()
    assert (votes.sum(axis=1) == 3).all() and (votes[:, 0] == 3).all()


def test_assignments_and_their_inversion(setup):
    """``assignments`` is JAX's host function; ``assignments_of`` reads
    the same partition back from the built lists."""
    d, jp, jv, tp, tv, own, _ = setup
    want = jivf.assignments(np.asarray(jp.fit_X), np.asarray(jv.centers))
    np.testing.assert_array_equal(
        tivf.assignments(np.asarray(jp.fit_X), np.asarray(jv.centers)), want)
    np.testing.assert_array_equal(tivf.assignments_of(tv),
                                  jivf.assignments_of(jv))
    np.testing.assert_array_equal(tivf.assignments_of(tv), want)
    np.testing.assert_array_equal(
        tivf.assignments_of(own),
        tivf.assignments(tp.fit_X.numpy(), own.centers.numpy()))
    assert tivf.default_n_clusters(1024) == jivf.default_n_clusters(1024) == 32
    assert own.n_lists == 32 and own.nprobe == 2


def test_build_validates_nprobe():
    rng = np.random.RandomState(0)
    tp = tknn.KnnModel.from_numpy(_corpus(rng, 128), device="cpu")
    with pytest.raises(ValueError, match="nprobe"):
        tivf.build(tp, nprobe=0)


def test_lloyd_from_jax_initial_centers():
    """``_lloyd`` from JAX's k-means++ centers: the same assignments, the
    centers within rtol 1e-5, the inertia within rtol 1e-5."""
    rng = np.random.RandomState(11)
    X = _corpus(rng, 600)["fit_X"].astype(np.float32)
    Xj = jnp.asarray(X)
    c0 = jkmeans._plusplus_init(jax.random.key(3), Xj, 8)
    jc, jin = jkmeans._lloyd(Xj, c0, 10)
    tc, tin = tkmeans._lloyd(torch.from_numpy(X),
                             torch.from_numpy(np.array(c0)), 10)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5)
    np.testing.assert_allclose(float(tin), float(jin), rtol=1e-5)
    np.testing.assert_array_equal(
        tkmeans._assign(torch.from_numpy(X), tc)[0].numpy(),
        np.asarray(jkmeans._assign(Xj, jc)[0]))


def test_fit_is_seeded_and_finds_the_blobs():
    """The port's ``fit``: the same seed gives the same centers, each of
    four separated blobs gets one center, and the inertia is the
    assignment's."""
    rng = np.random.RandomState(0)
    means = np.array([[0.0] * 12, [1e4] * 12, [1e6] * 12, [1e8] * 12])
    X = np.concatenate([m + rng.normal(0, 1.0, (50, 12)) for m in means]
                       ).astype(np.float32)
    a, ia = tkmeans.fit(X, k=4, n_init=3, n_iter=10, seed=5, device="cpu")
    b, ib = tkmeans.fit(torch.from_numpy(X), k=4, n_init=3, n_iter=10, seed=5)
    np.testing.assert_array_equal(a.centers.numpy(), b.centers.numpy())
    assert ia == ib
    labels = a.predict(torch.from_numpy(X)).numpy()
    assert sorted(set(labels[i * 50] for i in range(4))) == [0, 1, 2, 3]
    assert all(len(set(labels[i * 50:(i + 1) * 50])) == 1 for i in range(4))
    d2 = tkmeans._assign(torch.from_numpy(X), a.centers)[1]
    assert ia == pytest.approx(float(d2.min(1).values.sum()), rel=1e-6)


def test_native_mirror_matches_exact_at_full_probe(setup):
    """The native IVF mirror on the port's partition: at nprobe = K its
    labels and votes equal the native exact search, and those equal the
    torch tier's on this corpus; the unpruned scan equals the pruned."""
    if not native_knn.available():
        pytest.skip("g++ cannot build the native KNN evaluator here")
    d, _, _, tp, _, own, X = setup
    h = native_knn.NativeKnn(d)
    h.build_ivf(own.centers.numpy(), tivf.assignments_of(own))
    assert h.n_lists == own.n_lists
    np.testing.assert_array_equal(h.predict_ivf(X, own.n_lists), h.predict(X))
    np.testing.assert_array_equal(h.votes_ivf(X, own.n_lists), h.votes(X))
    np.testing.assert_array_equal(h.predict_unpruned(X), h.predict(X))
    np.testing.assert_array_equal(h.votes_unpruned(X), h.votes(X))
    np.testing.assert_array_equal(
        h.votes_ivf(X, 2),
        tivf.neighbor_votes_ivf(own, torch.from_numpy(X), 2).numpy())
    scr, _ab, queries = h.screen_stats()
    assert queries > 0 and scr >= 0
    with pytest.raises(ValueError, match="nprobe"):
        h.predict_ivf(X, 0)
    with pytest.raises(ValueError, match="assignments shape"):
        h.build_ivf(own.centers.numpy(), tivf.assignments_of(own)[:-1])


def test_serving_requires_explicit_opt_in(monkeypatch):
    """The default resolution never builds an IVF index; the opt-in does
    and serves labels (the native mirror where g++ builds it)."""
    for var in ("TCSDN_KNN_TOPK",):
        monkeypatch.setenv(var, "")
        monkeypatch.delenv(var)
    rng = np.random.RandomState(1)
    d = _corpus(rng, 256)
    tp = tknn.KnnModel.from_numpy(d, device="cpu")
    called = []
    real_build = tivf.build
    monkeypatch.setattr(tivf, "build", lambda *a, **k: (
        called.append(1), real_build(*a, **k))[1])
    tmodels._build_serving_path("knn", tp)
    assert not called
    monkeypatch.setenv("TCSDN_KNN_TOPK", "ivf4")
    fn, p = tmodels._build_serving_path("knn", tp)
    assert called
    X = torch.from_numpy(np.abs(d["fit_X"][:16]).astype(np.float32))
    assert np.asarray(fn(p, X)).shape == (16,)


@pytest.mark.parametrize("nprobe", [1, None, "K"])
@pytest.mark.parametrize("which", ["carried", "own"])
def test_tier_votes_equal_native_mirror_on_a_shared_quantizer(
        setup, which, nprobe):
    """The torch tier (what a card serve runs) against the native IVF
    mirror (what a CPU serve runs where g++ builds it) on one quantizer,
    handed to the mirror as the serving path does (``build_ivf(centers,
    assignments_of(ivf))``): votes and labels equal, exactly, at nprobe 1,
    the default and K."""
    if not native_knn.available():
        pytest.skip("g++ cannot build the native KNN evaluator")
    _, _, _, tp, tv, own, X = setup
    ivf = tv if which == "carried" else own
    n = ivf.n_lists if nprobe == "K" else nprobe
    hk = tmodels._native_knn(tp)
    hk.build_ivf(ivf.centers.numpy(), tivf.assignments_of(ivf))
    Xt = torch.from_numpy(X)
    np.testing.assert_array_equal(
        hk.votes_ivf(X, tivf._nprobe(ivf, n)),
        tivf.neighbor_votes_ivf(ivf, Xt, n).numpy())
    np.testing.assert_array_equal(
        hk.predict_ivf(X, tivf._nprobe(ivf, n)),
        tivf.predict(ivf, Xt, n).numpy())
