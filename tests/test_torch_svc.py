"""SVC parity: the port's ``models/svc.py`` and ``ops/rbf_kernel.py`` (the
CUDA kernel's plain version, which a CPU tensor takes) against the JAX
package's ``models/svc.py`` and the Pallas kernel ``ops/pallas_rbf.py``
run in interpret mode, as tests/test_pallas_rbf.py runs it.

Tolerances, stated:

- the model's arrays from one importer dict (``pair_coef``, ``sv_hi``,
  ``sv_lo``, ``intercept``, ``gamma``, the vote tables): bitwise;
- decision values: ``atol = 1e-5 · max_p Σ_s |coef[p, s]|``. Each
  decision is a sum of S terms ``K·coef`` with K ≤ 1; the port adds them
  one by one in support-vector order, JAX in a matmul's blocked order, and
  ``exp`` and the distance sums round differently, so the two differ by a
  few ulps of that largest possible sum;
- labels: exact on every row whose smallest |D| exceeds that atol (a
  decision farther from 0 than the rounding cannot change sign).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from traffic_classifier_sdn_tpu.models import svc as jsvc
from traffic_classifier_sdn_tpu.ops import pallas_rbf
from traffic_classifier_sdn_tpu_torch import interop
from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
from traffic_classifier_sdn_tpu_torch.models import svc as tsvc
from traffic_classifier_sdn_tpu_torch.ops import rbf_kernel as rk

ARRAYS = ("sv_hi", "sv_lo", "pair_coef", "intercept", "vote_i", "vote_j",
          "gamma")


@pytest.fixture(scope="module")
def case():
    """Served features of a synthetic table (nonzero rows, and a float64
    copy with residuals for the two-float form), a seeded SVC drawn near
    them (chip_smoke.random_svc), the JAX params, and the port's model
    carried over from them."""
    X = ft.features12(chip_smoke.synthetic_table(1200, 3, "cpu")).numpy()
    X = X[np.abs(X).sum(1) > 0][:777]
    d = chip_smoke.random_svc(0, X, n_sv=150)
    jp = jsvc.from_numpy(d)
    tp = interop.svc_params_from_numpy(jp, device="cpu")
    X64 = X.astype(np.float64) * (
        1 + 1e-4 * np.random.RandomState(1).rand(*X.shape))
    return X, X64, d, jp, tp


def _bits(a: np.ndarray) -> np.ndarray:
    return np.atleast_1d(a).view(np.uint8)


def _atol(jp) -> float:
    return 1e-5 * float(np.abs(np.asarray(jp.pair_coef)).sum(1).max())


def test_from_numpy_bitwise_equal_to_jax(case):
    """One importer dict through both ``from_numpy``s: the dense libsvm
    layout (built in float64, rounded once) and the two-float split agree
    bit for bit, and interop carries the JAX arrays over as they are."""
    _, _, d, jp, carried = case
    own = tsvc.SvcModel.from_numpy(d, device="cpu")
    for m in (own, carried):
        for name in ARRAYS:
            want = np.asarray(getattr(jp, name))
            got = getattr(m, name).numpy()
            assert got.dtype == want.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(_bits(got), _bits(want),
                                          err_msg=name)
        assert m.n_classes == jp.n_classes == 6
        assert m.has_lo == jp.has_lo is True
    assert own.pair_coef.shape == (15, 150)


def _inputs(case, lo: bool):
    X, X64, *_ = case
    if not lo:
        return X, None
    hi, xlo = tsvc.split_hilo(X64)
    assert np.any(xlo)
    return hi, xlo


@pytest.mark.parametrize("lo", [False, True], ids=["no-X_lo", "X_lo"])
def test_decision_matches_jax(case, lo):
    """Decisions within the stated atol of JAX ``svc.decision_ovo`` and
    ``pallas_rbf.decision_ovo_pallas`` (interpret; 128-row tiles, 64-SV
    chunks so the 150 SVs pad), with and without ``X_lo``."""
    _, _, _, jp, tp = case
    Xh, Xl = _inputs(case, lo)
    jXl = None if Xl is None else jnp.asarray(Xl)
    want = np.asarray(jsvc.decision_ovo(jp, jnp.asarray(Xh), jXl))
    jg = pallas_rbf.compile_svc(jp, row_tile=128, sv_chunk=64)
    want_pl = np.asarray(pallas_rbf.decision_ovo_pallas(
        jg, jnp.asarray(Xh), jXl, interpret=True))
    g = rk.compile_svc(tp)
    tXl = None if Xl is None else torch.from_numpy(Xl)
    got = rk.decision_ovo(g, torch.from_numpy(Xh), tXl).numpy()
    atol = _atol(jp)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    np.testing.assert_allclose(got, want_pl, atol=atol, rtol=0)
    # not vacuous: the kernel values reach the decisions
    intercept = np.asarray(jp.intercept)[None, :]
    assert np.abs(want - intercept).max() > 1.0
    # the kernel's plain version is the model's own arithmetic, bitwise
    np.testing.assert_array_equal(
        tp.decision_ovo(torch.from_numpy(Xh), tXl).numpy().view(np.uint32),
        got.view(np.uint32),
    )


@pytest.mark.parametrize("lo", [False, True], ids=["no-X_lo", "X_lo"])
def test_labels_exact_off_the_rounding(case, lo):
    _, _, _, jp, tp = case
    Xh, Xl = _inputs(case, lo)
    jXl = None if Xl is None else jnp.asarray(Xl)
    tXl = None if Xl is None else torch.from_numpy(Xl)
    D = np.asarray(jsvc.decision_ovo(jp, jnp.asarray(Xh), jXl))
    clear = np.abs(D).min(1) > _atol(jp)
    assert clear.mean() > 0.9
    want = np.asarray(jsvc.predict(jp, jnp.asarray(Xh), jXl))
    g = rk.compile_svc(tp)
    got = rk.predict(g, torch.from_numpy(Xh), tXl).numpy()
    np.testing.assert_array_equal(got[clear], want[clear])
    assert len(np.unique(got)) > 1
    np.testing.assert_array_equal(
        rk.scores(g, torch.from_numpy(Xh), tXl).numpy()[clear],
        np.asarray(jsvc.scores(jp, jnp.asarray(Xh), jXl))[clear],
    )
    Xt = torch.from_numpy(Xh)
    np.testing.assert_array_equal(tp.predict(Xt, tXl).numpy(), got)
    np.testing.assert_array_equal(
        tp.predict_chunked(Xt, tXl, row_chunk=100).numpy(), got)
    lab, votes = tp.predict_scores(Xt, tXl)
    np.testing.assert_array_equal(lab.numpy(), got)
    np.testing.assert_array_equal(votes.argmax(1).numpy(), got)


def test_kernel_records_reproduce_plain_bitwise(case):
    """The kernel's support-vector records, read back in the kernel's
    order, give the plain version's decisions bit for bit (the card check
    repeats this with the compiled kernel)."""
    X, X64, _, _, tp = case
    g = rk.compile_svc(tp)
    rec = g.records
    F, P = g.n_features, g.n_pairs
    np.testing.assert_array_equal(rec[:, rk.COEF_SLOT + P:].numpy(), 0)
    Xt = torch.from_numpy(X[:200])
    d2 = None
    for f in range(F):
        diff = (Xt[:, f, None] - rec[None, :, f]) - rec[None, :, rk.LO_SLOT + f]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    K = torch.exp(torch.tensor(-g.gamma, dtype=torch.float32) * d2)
    acc = torch.zeros((Xt.shape[0], P))
    for s in range(g.n_sv):
        acc = acc + K[:, s, None] * rec[None, s, rk.COEF_SLOT: rk.COEF_SLOT + P]
    np.testing.assert_array_equal(
        acc.numpy().view(np.uint32),
        rk.partial_decision(g, Xt).numpy().view(np.uint32),
    )
    np.testing.assert_array_equal(
        rk.partial_decision_plain(g, Xt).numpy(),
        torch.cat([rk.partial_decision(g, Xt[:77]),
                   rk.partial_decision(g, Xt[77:])]).numpy(),
    )


def test_wrapper_checks_and_rejections(case):
    X, _, d, _, tp = case
    g = rk.compile_svc(tp)
    with pytest.raises(ValueError, match="features"):
        rk.partial_decision(g, torch.zeros((4, 11)))
    with pytest.raises(ValueError, match="float32"):
        rk.partial_decision(g, torch.zeros((4, 12), dtype=torch.float64))
    with pytest.raises(ValueError, match="X_lo"):
        rk.partial_decision(g, torch.zeros((4, 12)), torch.zeros((3, 12)))
    seven = chip_smoke.random_svc(1, X, n_sv=40, n_classes=7)
    with pytest.raises(ValueError, match="15 pairs"):
        rk.compile_svc(tsvc.SvcModel.from_numpy(seven, device="cpu"))
    launches = rk.partial_decision.launches
    assert rk.predict(g, torch.from_numpy(X[:5])).shape == (5,)
    assert rk.partial_decision(g, torch.zeros((0, 12))).shape == (0, 15)
    assert rk.partial_decision.launches == launches  # the CPU twin never counts


@pytest.mark.parametrize("N", [1, 31, 777, 65536, 1 << 20])
def test_launch_shape_covers_every_row_and_support_vector_once(N):
    """The kernel's index math, replayed on the chosen rows per block:
    every row is in one block; in each stage, phase 1 gives every (row,
    SV) pair of the tile to one thread and phase 2 every (row, pair) sum
    to one thread; the stages cover the support vectors once in ascending
    order; and the launch has at least one block per SM wherever N
    allows (the support vectors are never split, so a block holds at
    least 4 rows)."""
    R = rk.launch_shape(N)
    assert R in rk.ROWS_PER_BLOCK
    blocks = -(-N // R)
    rows = (np.arange(blocks)[:, None] * R + np.arange(R)[None, :]).ravel()
    np.testing.assert_array_equal(rows[rows < N], np.arange(N))
    assert blocks >= min(-(-N // 4), 132)
    T = rk.threads_per_block(R)
    subs = T // R
    groups = min(subs, rk.MAX_PAIRS)
    per_group = -(-rk.MAX_PAIRS // groups)
    t = np.arange(T)
    tile = [(r, s) for tt in t for m in range(rk.STAGE // subs)
            for r, s in [(tt % R, tt // R + m * subs)]]
    assert sorted(tile) == [(r, s) for r in range(R) for s in range(rk.STAGE)]
    sums = [(tt % R, (tt // R) * per_group + i) for tt in t
            if tt // R < groups for i in range(per_group)
            if (tt // R) * per_group + i < rk.MAX_PAIRS]
    assert sorted(sums) == [(r, p) for r in range(R)
                            for p in range(rk.MAX_PAIRS)]
    for S in (15, 129, 2281):
        stages = [range(b, min(S, b + rk.STAGE)) for b in range(0, S, rk.STAGE)]
        assert [s for st in stages for s in st] == list(range(S))
