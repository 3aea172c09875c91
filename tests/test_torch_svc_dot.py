"""``TCSDN_SVC_KERNEL=dot`` in the port: ``SvcModel.rbf_kernel_dot`` /
``decision_dot`` / ``predict_dot`` / ``predict_dot_chunked`` against the
JAX package's ``svc.rbf_kernel_dot`` / ``predict_dot`` on the same
params (carried through ``interop``) and inputs, with and without the lo
parts.

Tolerance, stated: decisions within 1e-5 of the largest coefficient sum
``max_p Σ_s |coef[p, s]|`` (each kernel value is in [0, 1], so that sum
bounds |decision − intercept|; both packages run float32 matmuls, summed
in their own orders), and labels equal. The features are served-scale
rows (``chip_smoke.synthetic_table``), where the dot expansion does not
cancel enough to flip a vote; at ~8e8 it can (svc.py's numerics note),
which the card check in chip_smoke.py bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from traffic_classifier_sdn_tpu.models import svc as jsvc
from traffic_classifier_sdn_tpu_torch import interop
from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
from traffic_classifier_sdn_tpu_torch.models import svc as tsvc


@pytest.fixture(scope="module")
def served():
    X = ft.features12(chip_smoke.synthetic_table(1500, 3, "cpu")).numpy()
    X = X[np.abs(X).sum(1) > 0].astype(np.float64)
    d = chip_smoke.random_svc(0, X.astype(np.float32), n_sv=300)
    jp = jsvc.from_numpy(d)
    return X, jp, interop.svc_params_from_numpy(jp, device="cpu")


def _tol(tp) -> float:
    return 1e-5 * float(tp.pair_coef.abs().sum(1).max())


@pytest.mark.parametrize("with_lo", [False, True], ids=["X", "X+X_lo"])
@pytest.mark.parametrize("has_lo", [True, False], ids=["sv_lo", "no-sv_lo"])
def test_decisions_and_labels_match_jax(served, with_lo, has_lo):
    X, jp, tp = served
    if not has_lo:  # the f32-exact support vectors: no SV lo correction
        jp = jp.replace(sv_lo=jnp.zeros_like(jp.sv_lo), has_lo=False)
        tp = interop.svc_params_from_numpy(jp, device="cpu")
    Xh, Xl = jsvc.split_hilo(X)
    xl_j = Xl if with_lo else None
    xl_t = torch.from_numpy(np.array(Xl)) if with_lo else None
    Xt = torch.from_numpy(np.array(Xh))
    want = np.asarray(jsvc._decision_from_kernel(
        jp, jsvc.rbf_kernel_dot(jp, Xh, xl_j)))
    got = tp.decision_dot(Xt, xl_t).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(tp))
    np.testing.assert_allclose(
        tp.rbf_kernel_dot(Xt, xl_t).numpy(),
        np.asarray(jsvc.rbf_kernel_dot(jp, Xh, xl_j)), rtol=0, atol=1e-5)
    labels = np.asarray(jsvc.predict_dot(jp, Xh, xl_j))
    np.testing.assert_array_equal(tp.predict_dot(Xt, xl_t).numpy(), labels)
    np.testing.assert_array_equal(
        tp.predict_dot_chunked(Xt, xl_t, row_chunk=100).numpy(),
        np.asarray(jsvc.predict_dot_chunked(jp, Xh, xl_j, row_chunk=100)))
    np.testing.assert_array_equal(
        tsvc.serve_predict_dot(tp, Xt, xl_t).numpy(), labels)


def test_dot_labels_equal_the_difference_form_here(served):
    """On served-scale rows the dot form's labels equal the difference
    form's (the canonical path) in both packages."""
    X, jp, tp = served
    Xt = torch.from_numpy(X.astype(np.float32))
    np.testing.assert_array_equal(tp.predict_dot(Xt).numpy(),
                                  tp.predict(Xt).numpy())


def test_lo_corrections_are_structural(served):
    """Dropping sv_lo changes the dot-form decisions (the correction
    matmul is there), as JAX's structural regression test holds."""
    X, _, tp = served
    Xt = torch.from_numpy(X[:64].astype(np.float32))
    base = tp.decision_dot(Xt)
    tp.has_lo = False
    try:
        assert not torch.equal(tp.decision_dot(Xt), base)
    finally:
        tp.has_lo = True
