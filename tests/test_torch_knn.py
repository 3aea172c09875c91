"""KNN parity: the port's ``models/knn.py`` and ``ops/knn_kernel.py`` (the
CUDA kernel's plain version, which a CPU tensor takes) against the JAX
package's ``models/knn.py``, ``lax.top_k`` and the Pallas kernel
``ops/pallas_knn.py`` run in interpret mode, as tests/test_pallas_knn.py
runs it.

Tolerances, stated:

- neighbor indices and similarities: bitwise on the integer tie corpus
  (``randint(0, 4)`` features): every similarity is exact there and
  massively tied, so a tie-order difference cannot hide behind rounding;
- labels and vote counts on float features: exact on every row whose
  k-th/(k+1)-th similarity gap exceeds ``NEAR`` = 16 ulps of the row's
  largest |similarity|. The similarities differ from JAX's in the last
  bits (the port rounds each product and sum on its own, XLA's matmul
  fuses and blocks), which can reorder only neighbors within rounding of
  each other. On the few rows below that gap, every neighbor the port
  picks is within ``NEAR`` of JAX's k-th similarity;
- the two-float form: similarities to ``rtol=1e-6``, votes exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import chip_smoke
from traffic_classifier_sdn_tpu.models import knn as jknn
from traffic_classifier_sdn_tpu.models import svc as jsvc
from traffic_classifier_sdn_tpu.ops import pallas_knn
from traffic_classifier_sdn_tpu_torch import interop
from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
from traffic_classifier_sdn_tpu_torch.models import knn as tknn
from traffic_classifier_sdn_tpu_torch.ops import knn_kernel as kk


def _tie_dict(rng, S, n_classes=6, k=5):
    """A few-distinct-value integer corpus (tests/test_pallas_knn.py)."""
    return {
        "fit_X": rng.randint(0, 4, (S, 12)).astype(np.float64),
        "y": rng.randint(0, n_classes, S),
        "n_neighbors": k,
        "classes": np.arange(n_classes),
    }


def _both(d):
    """(JAX params, port model carried over from them, port kernel operands)."""
    jp = jknn.from_numpy(d, dtype=jnp.float32)
    tp = interop.knn_params_from_numpy(jp, device="cpu")
    return jp, tp, kk.compile_knn(tp)


@pytest.fixture(scope="module")
def served():
    """Served features of a synthetic table (nonzero rows) and a seeded
    KNN drawn near them (chip_smoke.random_knn), as the serve builds it."""
    X = ft.features12(chip_smoke.synthetic_table(1500, 3, "cpu")).numpy()
    X = X[np.abs(X).sum(1) > 0]
    return X, chip_smoke.random_knn(0, X, n_rows=600)


@pytest.mark.parametrize(
    "S,k,row_tile,chunk",
    [(333, 5, 64, 64), (333, 5, 64, 128), (333, 5, 64, 360), (333, 5, 64, 512),
     (7, 5, 16, 64), (5, 5, 16, 64), (40, 1, 32, 64), (200, 9, 64, 128)],
    ids=["multi-chunk", "chunk128", "one-padded-chunk", "chunk512",
         "S<chunk", "S==k", "k1", "k9"],
)
def test_neighbor_idx_bitwise_on_ties(S, k, row_tile, chunk):
    """(N, k) indices and values bitwise against JAX ``lax.top_k`` over
    the full similarity row and ``pallas_knn.neighbor_idx`` (interpret),
    at chunk sizes below, at and above S, S == k and a non-tile N."""
    rng = np.random.RandomState(7 + S + k)
    jp, tp, g = _both(_tie_dict(rng, S, k=k))
    X = rng.randint(0, 4, (100, 12)).astype(np.float32)
    sim = jknn._dot_expansion_sim(jnp.asarray(X), jp.fit_X, jp.half_sq_norms)
    want_v, want_i = (np.asarray(a) for a in lax.top_k(sim, k))
    jg = pallas_knn.compile_knn(jp, row_tile=row_tile, corpus_chunk=chunk)
    pallas_i = np.asarray(pallas_knn.neighbor_idx(jg, jnp.asarray(X),
                                                  interpret=True))
    vals, idx = kk.topk_sim_idx(g, torch.from_numpy(X))
    np.testing.assert_array_equal(idx.numpy(), want_i)
    np.testing.assert_array_equal(idx.numpy(), pallas_i)
    np.testing.assert_array_equal(vals.numpy().view(np.uint32),
                                  want_v.view(np.uint32))
    np.testing.assert_array_equal(kk.neighbor_idx(g, torch.from_numpy(X)), idx)
    assert idx.dtype == torch.int32


def test_vote_counts_bitwise_on_ties():
    rng = np.random.RandomState(11)
    jp, tp, g = _both(_tie_dict(rng, 900))
    X = rng.randint(0, 4, (64, 12)).astype(np.float32)
    want = np.asarray(jknn.neighbor_votes(jp, jnp.asarray(X)))
    np.testing.assert_array_equal(kk.scores(g, torch.from_numpy(X)).numpy(), want)
    np.testing.assert_array_equal(tp.neighbor_votes(torch.from_numpy(X)).numpy(),
                                  want)


def _kth_gap(sim: np.ndarray, k: int) -> np.ndarray:
    """Per row, the gap between the k-th and (k+1)-th largest similarity."""
    top = -np.sort(-sim, axis=1)[:, : k + 1]
    return top[:, k - 1] - top[:, k]


NEAR = 16  # ulps of a row's largest |similarity|: the f32 rounding scale


def test_labels_and_votes_match_jax_on_served_features(served):
    X, d = served
    jp, tp, g = _both(d)
    Xj = jnp.asarray(X)
    sim = np.asarray(jknn._dot_expansion_sim(Xj, jp.fit_X, jp.half_sq_norms))
    tol = NEAR * np.spacing(np.abs(sim).max(1))
    near = _kth_gap(sim, 5) <= tol
    assert near.mean() < 0.05
    want_votes = np.asarray(jknn.neighbor_votes(jp, Xj))
    Xt = torch.from_numpy(X)
    votes = kk.scores(g, Xt).numpy()
    np.testing.assert_array_equal(votes[~near], want_votes[~near])
    # near-ties: the port's neighbors are a top-k of JAX's similarities
    # within rounding
    idx = kk.neighbor_idx(g, Xt).numpy()[near]
    kth = -np.sort(-sim[near], axis=1)[:, 4]
    picked = np.take_along_axis(sim[near], idx, axis=1)
    assert (picked >= (kth - tol[near])[:, None]).all()
    labels = kk.predict(g, Xt).numpy()
    np.testing.assert_array_equal(labels[~near],
                                  np.asarray(jknn.predict(jp, Xj))[~near])
    assert len(np.unique(labels)) > 1
    # the kernel's plain version is the model's own arithmetic
    np.testing.assert_array_equal(tp.neighbor_votes(Xt).numpy(), votes)
    np.testing.assert_array_equal(tp.predict(Xt).numpy(), labels)
    np.testing.assert_array_equal(tp.predict_chunked(Xt, row_chunk=97).numpy(),
                                  labels)
    lab, sc = tp.predict_scores(Xt)
    np.testing.assert_array_equal(lab.numpy(), labels)
    np.testing.assert_array_equal(sc.numpy(), votes)


def test_two_float_form_matches_jax(served):
    X, d = served
    jp, tp, _ = _both(d)
    rng = np.random.RandomState(3)
    X64 = X.astype(np.float64) * (1 + 1e-3 * rng.rand(*X.shape))
    hi, lo = jsvc.split_hilo(X64)
    assert np.any(np.asarray(lo)) and np.any(tp.fit_X_lo.numpy())
    want_sim = np.asarray(jknn._neighbor_sim(jp, hi, lo))
    Xt, Xl = torch.from_numpy(np.array(hi)), torch.from_numpy(np.array(lo))
    np.testing.assert_allclose(tp._neighbor_sim(Xt, Xl).numpy(), want_sim,
                               rtol=1e-6)
    np.testing.assert_array_equal(
        tp.neighbor_votes(Xt, Xl).numpy(),
        np.asarray(jknn.neighbor_votes(jp, hi, lo)),
    )
    np.testing.assert_array_equal(tp.predict(Xt, Xl).numpy(),
                                  np.asarray(jknn.predict(jp, hi, lo)))


def test_half_sq_norms():
    """The port's ``from_numpy`` sums ½‖s‖² in one fixed order; interop
    carries JAX's array over as it is."""
    d = chip_smoke.random_knn(2, np.random.RandomState(0).gamma(
        1.0, 1e5, (50, 12)).astype(np.float32), n_rows=80)
    own = tknn.KnnModel.from_numpy(d, device="cpu")
    hi = own.fit_X.numpy()
    acc = hi[:, 0] * hi[:, 0]
    for f in range(1, 12):
        acc = (acc + hi[:, f] * hi[:, f]).astype(np.float32)
    np.testing.assert_array_equal(own.half_sq_norms.numpy(), np.float32(0.5) * acc)
    jp = jknn.from_numpy(d, dtype=jnp.float32)
    carried = interop.knn_params_from_numpy(jp, device="cpu")
    for name in interop.KNN_FIELDS:
        want = np.asarray(getattr(jp, name))
        got = getattr(carried, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    np.testing.assert_array_equal(own.fit_X.numpy(), np.asarray(jp.fit_X))
    np.testing.assert_array_equal(own.fit_X_lo.numpy(), np.asarray(jp.fit_X_lo))


SENTINEL = np.iinfo(np.int32).max  # kSentinel: an empty slot's index


def _offer(vals, idx, v, s):
    """WarpList::offer for one candidate: it enters if it beats the k-th
    value, after every entry >= it; the entries behind move down."""
    if not v > vals[-1]:
        return
    p = sum(1 for u in vals if u >= v)
    vals.insert(p, v)
    idx.insert(p, s)
    del vals[-1], idx[-1]


def _kernel_scan(g: kk.KnnKernelOperands, X: np.ndarray):
    """The CUDA kernel's procedure in numpy: the corpus taken 128 records
    at a time, record 32·j + lane of a chunk in lane ``lane``'s column j,
    padded past the corpus's end with zeros and a half norm of +inf; the
    similarity in its order; the first chunk's k best (value desc, index
    asc) filling the empty list (k <= 32), every later candidate offered
    column by column, lane by lane. Empty slots are (-inf, SENTINEL)."""
    rec = g.records.numpy()
    k, F, S = g.n_neighbors, g.n_features, g.n_rows
    pad = np.zeros(kk.RECORD, np.float32)
    pad[-1] = np.inf
    out_v = np.zeros((X.shape[0], k), np.float32)
    out_i = np.zeros((X.shape[0], k), np.int32)
    with np.errstate(invalid="ignore"):
        for row, x in enumerate(X):
            vals, idx = [np.float32(-np.inf)] * k, [SENTINEL] * k
            for base in range(0, S, kk.CHUNK):
                cand = []  # column by column, lane by lane
                for j in range(kk.CHUNK // 32):
                    for lane in range(32):
                        s = base + 32 * j + lane
                        r = rec[s] if s < S else pad
                        acc = np.float32(x[0] * r[0])
                        for f in range(1, F):
                            acc = np.float32(acc + np.float32(x[f] * r[f]))
                        cand.append((np.float32(acc - r[-1]), s))
                if base == 0 and k <= 32:  # fill: the chunk's k best
                    best = sorted((c for c in cand if c[0] > -np.inf),
                                  key=lambda c: (-c[0], c[1]))[:k]
                    for q, (v, s) in enumerate(best):
                        vals[q], idx[q] = v, s
                    continue
                for v, s in cand:
                    _offer(vals, idx, v, s)
            out_v[row], out_i[row] = vals, idx
    return out_v, out_i


@pytest.mark.parametrize("k", [1, 5, 12])
def test_kernel_procedure_equals_plain_bitwise(served, k):
    """The kernel's records, chunking, argmax fill and insertion, run as
    the kernel runs them, reproduce the plain version bit for bit -- on
    the tie corpus (S = 300, over three chunks, the last one padded, and
    S == k) and on served features. The card check repeats this with the
    compiled kernel at every rows-per-warp choice."""
    rng = np.random.RandomState(k)
    tie = kk.compile_knn(tknn.KnnModel.from_numpy(_tie_dict(rng, 300, k=k),
                                                  device="cpu"))
    tie_k = kk.compile_knn(tknn.KnnModel.from_numpy(_tie_dict(rng, k, k=k),
                                                    device="cpu"))
    X, dserved = served
    dserved = dict(dserved, n_neighbors=k)
    dserved["fit_X"] = dserved["fit_X"][:160]
    dserved["y"] = dserved["y"][:160]
    real = kk.compile_knn(tknn.KnnModel.from_numpy(dserved, device="cpu"))
    Xtie = rng.randint(0, 4, (12, 12)).astype(np.float32)
    for g, Xq in ((tie, Xtie), (tie_k, Xtie), (real, X[:30])):
        np.testing.assert_array_equal(g.records[:, :12].numpy(), g.fit_X.numpy())
        want_v, want_i = kk.topk_sim_idx(g, torch.from_numpy(Xq))
        got_v, got_i = _kernel_scan(g, Xq)
        np.testing.assert_array_equal(got_i, want_i.numpy())
        np.testing.assert_array_equal(got_v.view(np.uint32),
                                      want_v.numpy().view(np.uint32))


SHAPE_ROWS = (1, 31, 777, 65536, 1 << 20)


@pytest.mark.parametrize("k", [1, 5, 20, 128])
@pytest.mark.parametrize("N", SHAPE_ROWS)
def test_launch_shape_covers_every_row_and_corpus_row_once(N, k):
    """The kernel's index math, replayed on the chosen rows per warp for
    the reference corpus (S = 4448): every row is scanned by one warp; the
    512-record stages and their 128-record chunks give every corpus row to
    one (stage, chunk, column, lane) slot, in ascending order; and the
    launch has at least one block per SM wherever N allows."""
    S = 4448
    RW = kk.launch_shape(N, k)
    assert RW in kk.rows_per_warp_choices(k)
    # two blocks per SM (__launch_bounds__(256, 2)) fit its 228 KB of
    # shared memory: two record stages, the rows, the lists
    smem = (2 * 4 * kk.CHUNK * kk.RECORD * 4 + kk.WARPS * RW * 64
            + kk.WARPS * RW * 32 * kk.list_slots(k) * 8)
    assert 2 * (smem + 1024) <= 228 * 1024
    # (block, warp, i) -> row, as the kernel computes it
    b = np.arange(kk.blocks(N, RW))[:, None, None]
    w = np.arange(kk.WARPS)[None, :, None]
    i = np.arange(RW)[None, None, :]
    row = (b * kk.WARPS + w) * RW + i
    np.testing.assert_array_equal(np.sort(row[row < N]), np.arange(N))
    # (stage, chunk, column, lane) -> corpus row, as the stages load them
    stage = 4 * kk.CHUNK
    slot = (np.arange(-(-S // stage))[:, None, None, None] * stage
            + np.arange(4)[None, :, None, None] * kk.CHUNK
            + 32 * np.arange(kk.CHUNK // 32)[None, None, :, None]
            + np.arange(32)[None, None, None, :]).ravel()
    np.testing.assert_array_equal(slot[slot < S], np.arange(S))
    assert kk.blocks(N, RW) >= min(kk.SMS, kk.blocks(N, 1))
    if RW > 1:  # the most rows per warp that still fill the card
        assert kk.blocks(N, RW) >= kk.SMS


def test_rejections_match_jax():
    """k > 128 and S < k are refused with the JAX kernel's messages; the
    kernel has no two-float mode."""
    rng = np.random.RandomState(5)
    for S, k in ((3, 5), (200, 129)):
        d = _tie_dict(rng, S, k=k)
        with pytest.raises(ValueError) as jerr:
            pallas_knn.compile_knn(jknn.from_numpy(d, dtype=jnp.float32))
        with pytest.raises(ValueError) as terr:
            kk.compile_knn(tknn.KnnModel.from_numpy(d, device="cpu"))
        assert str(terr.value) == str(jerr.value)
    g = kk.compile_knn(tknn.KnnModel.from_numpy(_tie_dict(rng, 20), device="cpu"))
    X = torch.zeros((4, 12))
    with pytest.raises(ValueError, match="two-float"):
        kk.predict(g, X, X_lo=X)
    with pytest.raises(ValueError, match="features"):
        kk.topk_sim_idx(g, torch.zeros((4, 11)))
    with pytest.raises(ValueError, match="float32"):
        kk.topk_sim_idx(g, torch.zeros((4, 12), dtype=torch.float64))
    with pytest.raises(ValueError, match="not ported"):
        tknn.KnnModel.from_numpy(_tie_dict(rng, 20), device="cpu").neighbor_votes(
            X, top_k_impl="argmax")
    launches = kk.topk_sim_idx.launches
    assert kk.predict(g, X).shape == (4,)
    assert kk.topk_sim_idx(g, torch.zeros((0, 12)))[1].shape == (0, 5)
    assert kk.topk_sim_idx.launches == launches  # the CPU twin never counts
