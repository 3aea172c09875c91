"""State- and data-sharded predicts: the port's ``parallel/{predict,
knn_sharded,forest_sharded,svc_sharded}.py`` against the JAX package's
``parallel/`` on the conftest's 8-device CPU mesh (the fused Pallas paths
in interpret mode, as the JAX package's own tests run them), case for
case with tests/test_parallel.py, on seeded synthetic models (the
reference checkpoints are not needed). The port's shards are 8 entries of
the one CPU device.

Tolerances, stated:

- KNN labels: bitwise, across the three merge schedules, the torch and
  the kernel local stage, the un-sharded predict and the JAX paths. The
  corpus and queries are integer-valued, so every similarity is exact and
  a tie-order difference cannot hide behind rounding;
- forest: class probabilities to ``atol=1e-5`` of the un-sharded mean
  (the shards' sums add in another order; ROADMAP Queue 3 item 6), labels
  exact on rows whose top-two gap exceeds 2e-5;
- SVC: decisions to ``atol = 1e-5 · max_p Σ_s |coef[p, s]|`` of the JAX
  and the un-sharded ones (tests/test_torch_svc.py), labels exact on rows
  whose smallest |decision| exceeds that atol.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from traffic_classifier_sdn_tpu.models import forest as jforest
from traffic_classifier_sdn_tpu.models import gnb as jgnb
from traffic_classifier_sdn_tpu.models import knn as jknn
from traffic_classifier_sdn_tpu.models import logreg as jlogreg
from traffic_classifier_sdn_tpu.models import svc as jsvc
from traffic_classifier_sdn_tpu.parallel import forest_sharded as jfs
from traffic_classifier_sdn_tpu.parallel import knn_sharded as jks
from traffic_classifier_sdn_tpu.parallel import mesh as jmesh
from traffic_classifier_sdn_tpu.parallel import predict as jpred
from traffic_classifier_sdn_tpu.parallel import svc_sharded as jss
from traffic_classifier_sdn_tpu_torch import interop
from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
from traffic_classifier_sdn_tpu_torch.models import knn as tknn
from traffic_classifier_sdn_tpu_torch.ops import knn_kernel as kk
from traffic_classifier_sdn_tpu_torch.ops import rbf_kernel as rk
from traffic_classifier_sdn_tpu_torch.parallel import forest_sharded as tfs
from traffic_classifier_sdn_tpu_torch.parallel import knn_sharded as tks
from traffic_classifier_sdn_tpu_torch.parallel import mesh as tmesh
from traffic_classifier_sdn_tpu_torch.parallel import predict as tpred
from traffic_classifier_sdn_tpu_torch.parallel import svc_sharded as tss

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8,
    reason="the JAX side needs the conftest's 8-device CPU mesh",
)

MERGES = ("all_gather", "ring", "tournament")


def _state_mesh(n):
    return (jmesh.make_mesh(n_data=1, n_state=n, devices=jax.devices()[:n]),
            tmesh.make_mesh(n_data=1, n_state=n, devices=["cpu"] * n))


@pytest.fixture(scope="module")
def served():
    """Served features of a synthetic table (nonzero rows)."""
    X = ft.features12(chip_smoke.synthetic_table(600, 3, "cpu")).numpy()
    return X[np.abs(X).sum(1) > 0][:256]


def _tie_knn(rng, S, k=5, n_classes=6):
    return {
        "fit_X": rng.randint(0, 4, (S, 12)).astype(np.float64),
        "y": rng.randint(0, n_classes, S).astype(np.int32),
        "n_neighbors": k,
        "classes": np.arange(n_classes),
    }


def _knn_pair(d):
    jp = jknn.from_numpy(d, dtype=jnp.float32)
    return jp, interop.knn_params_from_numpy(jp, device="cpu")


@pytest.mark.parametrize("name", ["logreg", "gnb"])
def test_data_parallel_predict_matches(served, name):
    """Rows split over an 8-way data axis: the labels of the un-sharded
    predict, in the port and in JAX's ``data_parallel``."""
    X = served[:256]
    if name == "logreg":
        jp = jlogreg.from_numpy(chip_smoke.random_logreg(0, X))
        tp = interop.logreg_params_from_numpy(jp, device="cpu")
        jfn = jlogreg.predict
    else:
        jp = jgnb.from_numpy(chip_smoke.random_gnb(0, X))
        tp = interop.gnb_params_from_numpy(jp, device="cpu")
        jfn = jgnb.predict
    Xt = torch.from_numpy(X)
    want = tp.predict(Xt).numpy()
    dp = tpred.data_parallel(tmesh.make_mesh(devices=["cpu"] * 8),
                             lambda p, x: p.predict(x))
    np.testing.assert_array_equal(dp(tp, Xt).numpy(), want)
    jdp = jpred.data_parallel(jmesh.make_mesh(), jfn)
    np.testing.assert_array_equal(
        np.asarray(jdp(jp, jnp.asarray(X, jnp.float32))), want)


def test_knn_state_sharded_matches():
    """all_gather merge over 8 corpus shards == the un-sharded predict ==
    the JAX sharded predict, bitwise."""
    rng = np.random.RandomState(0)
    d = _tie_knn(rng, 333)
    X = rng.randint(0, 4, (256, 12)).astype(np.float32)
    _, single = _knn_pair(d)
    want = single.predict(torch.from_numpy(X)).numpy()
    jm, tm = _state_mesh(8)
    dpad = tks.pad_corpus(d, 8)
    jp, tp = _knn_pair(dpad)
    got = tks.sharded_predict(tm, tp, pad_mask=dpad.get("pad_mask"))(
        torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(got, want)
    jfn = jks.sharded_predict(jm, jp, pad_mask=dpad.get("pad_mask"))
    np.testing.assert_array_equal(np.asarray(jfn(jnp.asarray(X))), want)


@pytest.mark.parametrize("S,n_shards", [(333, 8), (8, 8), (4448, 4),
                                        (900, 5), (900, 8)],
                         ids=["333x8", "8x8-padding-heavy", "4448x4",
                              "900x5-ring", "900x8"])
def test_knn_merges_bitwise_equal(S, n_shards):
    """The three merge schedules, torch and kernel local stages: labels
    bitwise equal to one another and to the un-sharded predict, with
    shards of padding alone (8 rows over 8 shards; the fused layout of
    900 or 4,448 rows over 4-8 shards of 512-row chunks) and a
    non-power-of-two D for the ring (the tournament refuses it)."""
    rng = np.random.RandomState(S + n_shards)
    d = _tie_knn(rng, S)
    X = torch.from_numpy(rng.randint(0, 4, (96, 12)).astype(np.float32))
    _, single = _knn_pair(d)
    want = single.predict(X).numpy()
    _, tm = _state_mesh(n_shards)
    dpad = tks.pad_corpus(d, n_shards)
    _, tp = _knn_pair(dpad)
    mask = dpad.get("pad_mask")
    pow2 = not n_shards & (n_shards - 1)
    builders = [tks.sharded_predict, tks.ring_predict]
    if pow2:
        builders.append(tks.tournament_predict)
    else:
        with pytest.raises(ValueError, match="power-of-two"):
            tks.tournament_predict(tm, tp, pad_mask=mask)
    for b in builders:
        np.testing.assert_array_equal(b(tm, tp, pad_mask=mask)(X).numpy(),
                                      want, err_msg=b.__name__)
    _, unpadded = _knn_pair(d)
    for merge in MERGES if pow2 else MERGES[:2]:
        fn = tks.fused_predict(tm, unpadded, merge=merge)
        np.testing.assert_array_equal(fn(X).numpy(), want, err_msg=merge)


@pytest.mark.parametrize("merge", MERGES)
def test_knn_fused_matches_jax_fused(merge):
    """The port's kernel local stage (the plain version on the CPU) ==
    the JAX fused path (Pallas, interpret mode), bitwise, on a corpus
    whose tail shards are padding alone (S = 600 over 4 shards of 512
    rows: shards 2 and 3 are all padding)."""
    rng = np.random.RandomState(11)
    d = _tie_knn(rng, 600)
    X = rng.randint(0, 4, (64, 12)).astype(np.float32)
    jp, tp = _knn_pair(d)
    jm, tm = _state_mesh(4)
    fn = tks.fused_predict(tm, tp, merge=merge)
    assert fn.per == 512
    got = fn(torch.from_numpy(X)).numpy()
    jfn = jks.fused_predict(jm, jp, merge=merge, row_tile=64,
                            interpret=True)
    np.testing.assert_array_equal(got, np.asarray(jfn(jnp.asarray(X))))


def test_knn_fused_shards_hold_their_plain_version():
    """Each shard's kernel operands (the padded slice itself) give the
    un-sharded corpus's candidates on that slice: bitwise the plain
    version over the same rows, and −inf candidates at the lowest indices
    on a shard of padding alone."""
    rng = np.random.RandomState(3)
    d = _tie_knn(rng, 4448)
    _, tp = _knn_pair(d)
    _, tm = _state_mesh(4)
    fn = tks.fused_predict(tm, tp)
    assert fn.per == 1536 and len(fn.operands) == 4
    X = torch.from_numpy(rng.randint(0, 4, (40, 12)).astype(np.float32))
    full = kk.compile_knn(tp)
    for s, g in enumerate(fn.operands):
        assert g.n_rows == 1536
        val, idx = kk.topk_sim_idx(g, X)
        lo, hi = s * 1536, min((s + 1) * 1536, 4448)
        if hi <= lo:  # shard 3: padding alone
            assert torch.isneginf(val).all()
            np.testing.assert_array_equal(
                idx.numpy(), np.tile(np.arange(5, dtype=np.int32), (40, 1)))
            continue
        sim = tknn.dot_expansion_sim(X, full.fit_X[lo:hi], full.half_sq[lo:hi])
        wv, wi = tknn.topk_stable(sim, 5)
        np.testing.assert_array_equal(idx.numpy(), wi.numpy())
        np.testing.assert_array_equal(val.numpy(), wv.numpy())


def test_knn_merge_unpacked_fallback(monkeypatch):
    """Corpora whose rows × classes reach 2^31 carry labels as their own
    payload: the ring and the tournament still merge exactly."""
    monkeypatch.setattr(tks, "_packable", lambda n, c: False)
    rng = np.random.RandomState(5)
    d = _tie_knn(rng, 333)
    X = torch.from_numpy(rng.randint(0, 4, (128, 12)).astype(np.float32))
    _, single = _knn_pair(d)
    want = single.predict(X).numpy()
    _, tm = _state_mesh(8)
    dpad = tks.pad_corpus(d, 8)
    _, tp = _knn_pair(dpad)
    for b in (tks.ring_predict, tks.tournament_predict):
        np.testing.assert_array_equal(
            b(tm, tp, pad_mask=dpad.get("pad_mask"))(X).numpy(), want)
    np.testing.assert_array_equal(
        tks.fused_predict(tm, single, merge="ring")(X).numpy(), want)


def test_knn_sharded_refuses_too_few_real_rows():
    rng = np.random.RandomState(1)
    d = _tie_knn(rng, 3)  # 3 real rows < k = 5
    dpad = tks.pad_corpus(d, 2)
    _, tp = _knn_pair(dpad)
    _, tm = _state_mesh(2)
    with pytest.raises(ValueError, match="real rows"):
        tks.sharded_predict(tm, tp, pad_mask=dpad["pad_mask"])


def test_merge_topk_property_vs_numpy_sort():
    """The sort-free rank merge against a numpy (value desc, index asc)
    sort of the union: quantized values (cross-block ties), −inf padding
    candidates, unique indices; and against the JAX ``_merge_topk``."""
    rng = np.random.RandomState(5)
    k = 5
    for trial in range(20):
        N = 7
        av = np.round(rng.rand(N, k) * 4) / 4.0
        bv = np.round(rng.rand(N, k) * 4) / 4.0
        av[rng.rand(N, k) < 0.15] = -np.inf
        bv[rng.rand(N, k) < 0.15] = -np.inf
        perm = np.stack([rng.permutation(100)[: 2 * k] for _ in range(N)])
        ai, bi = perm[:, :k], perm[:, k:]

        def order(v, i):
            o = np.lexsort((i, -v), axis=-1)
            return np.take_along_axis(v, o, 1), np.take_along_axis(i, o, 1)

        av, ai = order(av, ai)
        bv, bi = order(bv, bi)
        args = [av.astype(np.float32), ai.astype(np.int32),
                bv.astype(np.float32), bi.astype(np.int32)]
        mv, mi, _ = tks._merge_topk(*map(torch.from_numpy, args), k)
        uv = np.concatenate([av, bv], axis=1)
        ui = np.concatenate([ai, bi], axis=1)
        o = np.lexsort((ui, -uv), axis=-1)[:, :k]
        np.testing.assert_array_equal(
            mv.numpy(), np.take_along_axis(uv, o, 1).astype(np.float32),
            err_msg=f"values trial {trial}")
        np.testing.assert_array_equal(
            mi.numpy(), np.take_along_axis(ui, o, 1), err_msg=f"trial {trial}")
        jv, ji, _ = jks._merge_topk(*map(jnp.asarray, args), k)
        np.testing.assert_array_equal(mv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(mi.numpy(), np.asarray(ji))


def _forest(served, n_trees=13):
    d = chip_smoke.random_forest(0, served, n_trees=n_trees,
                                 node_count=(15, 63), max_depth=6)
    d["n_features"] = 12
    return d


def _check_proba(got, want, labels, want_labels):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2e-5
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(labels[clear], want_labels[clear])


def test_forest_tree_sharded_matches(served):
    """13 trees padded to 16 over 8 shards (the gather traversal per
    shard): probabilities to atol 1e-5 of the un-sharded mean, labels
    equal to it and to the JAX tree-sharded predict off near-ties."""
    d = _forest(served)
    X = torch.from_numpy(served)
    single = interop.forest_params_from_numpy(d, device="cpu")
    want = single.scores(X).numpy()
    want_lab = np.argmax(want, 1)
    jm, tm = _state_mesh(8)
    dpad = tfs.pad_trees(d, 8)
    tp = interop.forest_params_from_numpy(dpad, device="cpu")
    proba = tfs.sharded_proba(tm, tp, n_real_trees=dpad["n_real_trees"])(X)
    labels = tfs.sharded_predict(tm, tp, dpad["n_real_trees"])(X).numpy()
    _check_proba(proba.numpy(), want, labels, want_lab)
    jp = jforest.from_numpy(dpad, dtype=jnp.float32)
    jlab = np.asarray(jfs.sharded_predict(
        jm, jp, n_real_trees=dpad["n_real_trees"])(jnp.asarray(served)))
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2e-5
    np.testing.assert_array_equal(labels[clear], jlab[clear])


def test_forest_tree_sharded_gemm_matches(served):
    """The GEMM form per shard: probabilities to atol 1e-5 of the
    un-sharded GEMM form, labels equal to JAX's ``gemm_sharded_predict``
    off near-ties; an unpadded ensemble is refused."""
    from traffic_classifier_sdn_tpu_torch.ops import tree_gemm

    d = _forest(served)
    X = torch.from_numpy(served)
    want = tree_gemm.forest_proba_gemm(
        tree_gemm.compile_forest(d, device="cpu"), X).numpy()
    jm, tm = _state_mesh(8)
    dpad = tfs.pad_trees(d, 8)
    proba = tfs.gemm_sharded_proba(tm, dpad)(X).numpy()
    labels = tfs.gemm_sharded_predict(tm, dpad)(X).numpy()
    _check_proba(proba, want, labels, np.argmax(want, 1))
    jlab = np.asarray(jfs.gemm_sharded_predict(jm, dpad)(
        jnp.asarray(served)))
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2e-5
    np.testing.assert_array_equal(labels[clear], jlab[clear])
    with pytest.raises(ValueError, match="pad_trees"):
        tfs.gemm_sharded_predict(tm, d)  # 13 trees, 8 shards


def _svc_case(served, n_sv):
    d = chip_smoke.random_svc(0, served, n_sv=n_sv)
    jp = jsvc.from_numpy(d)
    tp = interop.svc_params_from_numpy(jp, device="cpu")
    atol = 1e-5 * float(np.abs(np.asarray(jp.pair_coef)).sum(1).max())
    return d, jp, tp, atol


def _svc_check(dec, lab, want_dec, want_lab, atol):
    np.testing.assert_allclose(dec, want_dec, rtol=0, atol=atol)
    clear = np.abs(want_dec).min(1) > atol
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(lab[clear], want_lab[clear])


def test_svc_state_sharded_matches(served):
    """SV-sharded SVC over 8 shards, torch local stage, with the hi/lo
    query split and without: decisions to atol of the JAX single-device
    ones, labels equal to them and to JAX's sharded predict off
    near-ties."""
    d, jp, _, atol = _svc_case(served, 150)
    X64 = served.astype(np.float64) * (
        1 + 1e-4 * np.random.RandomState(1).rand(*served.shape))
    X_hi, X_lo = jsvc.split_hilo(X64)
    jm, tm = _state_mesh(8)
    dpad = tss.pad_support(d, 8)
    jpp = jsvc.from_numpy(dpad)
    tp = interop.svc_params_from_numpy(jpp, device="cpu")
    for lo in (X_lo, None):
        jlo = None if lo is None else jnp.asarray(lo)
        want_dec = np.asarray(jsvc.decision_ovo(jp, jnp.asarray(X_hi), jlo))
        want_lab = np.asarray(jsvc.predict(jp, X_hi, lo))
        lab, dec = tss.sharded_decision(tm, tp)(
            torch.from_numpy(np.array(X_hi)),
            None if lo is None else torch.from_numpy(np.array(lo)))
        _svc_check(dec.numpy(), lab.numpy(), want_dec, want_lab, atol)
        jfn = jss.sharded_predict(jm, jpp, precise=True)
        jlab = np.asarray(jfn(X_hi, lo))
        clear = np.abs(want_dec).min(1) > atol
        np.testing.assert_array_equal(lab.numpy()[clear], jlab[clear])
    plain = tss.sharded_predict(tm, tp)(torch.from_numpy(np.array(X_hi)))
    assert plain.dtype == torch.int32 and plain.shape == (served.shape[0],)


@pytest.mark.parametrize("n_sv,n_shards", [(150, 4), (1200, 4)],
                         ids=["one-real-shard", "padding-tail-shard"])
def test_svc_fused_matches(served, n_sv, n_shards):
    """The kernel local stage (the plain version on the CPU) per 512-SV
    shard: decisions to atol of the JAX fused path (Pallas, interpret
    mode) and of the un-sharded kernel's plain version; labels equal off
    near-ties. 150 SVs over 4 shards leave shards 1-3 with zero
    coefficients only; 1,200 leave shard 3 so."""
    d, jp, tp, atol = _svc_case(served, n_sv)
    jm, tm = _state_mesh(n_shards)
    X = torch.from_numpy(served)
    fn = tss.fused_decision(tm, tp)
    assert fn.per == 512
    lab, dec = fn(X)
    g = rk.compile_svc(tp)
    want_dec = rk.decision_ovo(g, X).numpy()
    want_lab = rk.predict(g, X).numpy()
    _svc_check(dec.numpy(), lab.numpy(), want_dec, want_lab, atol)
    jfn = jss.fused_predict(jm, jp, row_tile=64, interpret=True)
    jlab = np.asarray(jfn(jnp.asarray(served)))
    clear = np.abs(want_dec).min(1) > atol
    np.testing.assert_array_equal(lab.numpy()[clear], jlab[clear])
    # a shard of zero coefficients adds exactly zero
    last = fn.operands[-1]
    np.testing.assert_array_equal(
        rk.partial_decision(last, X).numpy(),
        np.zeros((X.shape[0], 15), np.float32))
    np.testing.assert_array_equal(
        tss.fused_predict(tm, tp)(X).numpy(), lab.numpy())


def test_svc_sharded_pad_is_noop_when_aligned(served):
    d = chip_smoke.random_svc(0, served, n_sv=150)
    assert tss.pad_support(d, 1) is d
    dpad = tss.pad_support(d, 8)
    assert dpad["support_vectors"].shape[0] == 152
    assert np.all(dpad["dual_coef"][:, 150:] == 0)
    jpad = jss.pad_support(d, 8)
    for k in ("support_vectors", "dual_coef"):
        np.testing.assert_array_equal(dpad[k], jpad[k])
