"""The SVC host rung, ``native/svc.py`` + ``svc_eval.cpp``, against the SVC
kernel's plain version (``ops/rbf_kernel``) on the CPU.

Tolerance, stated: bitwise. The C++ loops take the plain version's order,
each difference, product and sum rounded on its own, and the exponential
between them is the plain version's torch expression over the same
tensor; so the partial decisions, the votes and the labels equal the plain
version's, non-finite rows and empty inputs included. Where g++ cannot
build the library, the rung is the plain version itself.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from traffic_classifier_sdn_tpu_torch import interop, models
from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
from traffic_classifier_sdn_tpu_torch.native import svc as native_svc
from traffic_classifier_sdn_tpu_torch.ops import rbf_kernel as rk


@pytest.fixture(scope="module")
def sample():
    X = ft.features12(chip_smoke.synthetic_table(1024, 3, "cpu")).numpy()
    return np.ascontiguousarray(X[:777], np.float32)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _inputs(sample, n):
    X = sample[:n].copy()
    bad = X.copy()
    bad[0::3, 0] = np.nan
    bad[1::3, 3] = np.inf
    bad[2::3, 7] = -np.inf
    return {"finite": X, "non-finite": bad}


@pytest.mark.parametrize("n_sv", [45, 2281])
@pytest.mark.parametrize("rows", [0, 1, 7, 777])
def test_native_svc_is_the_plain_version_bit_for_bit(sample, n_sv, rows):
    g = rk.compile_svc(interop.svc_params_from_numpy(
        chip_smoke.random_svc(0, sample, n_sv=n_sv), "cpu"))
    ns = native_svc.NativeSvc(g)
    for what, X in _inputs(sample, rows).items():
        Xt = torch.from_numpy(X)
        got, want = ns.partial(X), rk.partial_decision_plain(g, Xt)
        assert got.shape == want.shape == (rows, g.n_pairs), what
        assert torch.equal(_bits(got), _bits(want)), what
        np.testing.assert_array_equal(ns.scores(X), rk.scores(g, Xt).numpy())
        np.testing.assert_array_equal(ns.predict(X),
                                      rk.predict(g, Xt).numpy())


def test_host_rung_is_native_and_takes_the_plain_version_without_gpp(
        sample, monkeypatch):
    sp = interop.svc_params_from_numpy(
        chip_smoke.random_svc(0, sample, n_sv=150), "cpu")
    want = rk.predict(rk.compile_svc(sp), torch.from_numpy(sample)).numpy()
    fb = models.resolve_fallback("svc", sp)
    assert fb.kind == "native-svc"
    np.testing.assert_array_equal(fb.predict(sample), want)
    monkeypatch.setattr(native_svc, "available", lambda: False)
    fb = models.resolve_fallback("svc", sp)
    assert fb.kind == "plain-cpu"
    np.testing.assert_array_equal(fb.predict(sample), want)


def test_native_svc_rejects_a_matrix_of_the_wrong_width(sample):
    g = rk.compile_svc(interop.svc_params_from_numpy(
        chip_smoke.random_svc(0, sample, n_sv=45), "cpu"))
    with pytest.raises(ValueError, match="X must be"):
        native_svc.NativeSvc(g).predict(sample[:, :11])
