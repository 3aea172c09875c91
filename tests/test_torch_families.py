"""Logistic regression, Gaussian naive Bayes and k-means in the port
(``models/{logreg,gnb,kmeans}.py``) against the JAX package's modules on
the same seeded numpy inputs; their checkpoints and host rung; and the
port CLI's ``logistic``, ``gaussiannb`` and ``kmeans`` serves against the
JAX CLI's stdout.

Tolerances. Each family's score is a float32 sum over the 12 features,
which the two packages reduce in their own orders (XLA's dot and reduce
against torch's matmul and sum). Per row and class, with ``scale`` the sum
of the absolute values of the terms (``scores_scale``), two orders differ
by at most ``11 · 2⁻²⁴ · scale ≈ 6.6e-7 · scale``; the scores are held to
``atol = 1e-6 · scale``, which for logreg and kmeans is ``rtol = 1e-6``
against float32 scale and for gnb adds the folded constant's magnitude.
Non-finite inputs give the same NaN and ±inf positions in both. Labels
are equal except on a row whose JAX top-two score gap is within
``2e-6 · scale`` (an f32 near-tie); such a row is reported by name, and
with these seeds none occurs.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_incremental import _capture_and_sample
from test_torch_pipeline import _run
from test_torch_serve import (
    JAX_SLICE_FLAGS,
    PORT_SERIAL,
    _sample_features,
    write_capture,
)
from traffic_classifier_sdn_tpu import cli as jcli
from traffic_classifier_sdn_tpu.io import checkpoint as jck
from traffic_classifier_sdn_tpu.models import gnb as jgnb
from traffic_classifier_sdn_tpu.models import kmeans as jkmeans
from traffic_classifier_sdn_tpu.models import logreg as jlogreg
from traffic_classifier_sdn_tpu_torch import cli as tcli
from traffic_classifier_sdn_tpu_torch import interop
from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
from traffic_classifier_sdn_tpu_torch.ingest.replay import (
    SyntheticFlows,
    iter_capture,
)
from traffic_classifier_sdn_tpu_torch.io import checkpoint as tck
from traffic_classifier_sdn_tpu_torch.models import (
    SUBCOMMAND_ALIASES,
    resolve_fallback,
)
from traffic_classifier_sdn_tpu_torch.models import kmeans as tkmeans
from traffic_classifier_sdn_tpu_torch.models.base import argmax_labels
from traffic_classifier_sdn_tpu_torch.utils import faults as tfaults

CLASSES = chip_smoke.CLASSES
# family → (JAX module, seeded importer-dict builder, interop builder,
# class names)
FAMILIES = {
    "logreg": (jlogreg, chip_smoke.random_logreg,
               interop.logreg_params_from_numpy, CLASSES),
    "gnb": (jgnb, chip_smoke.random_gnb, interop.gnb_params_from_numpy,
            CLASSES),
    "kmeans": (jkmeans, chip_smoke.random_kmeans,
               interop.kmeans_params_from_numpy,
               jkmeans.CLUSTER_LABELS_CHECKPOINT),
}
SUBCOMMANDS = {"logistic": "logreg", "gaussiannb": "gnb", "kmeans": "kmeans"}


@pytest.fixture(autouse=True, scope="module")
def _default_serving_menus():
    """The serves here run the default serving menus. A CLI given
    ``--knn-topk`` publishes it through TCSDN_KNN_TOPK for the rest of its
    process, so a serve of another module may have left it set."""
    with pytest.MonkeyPatch.context() as mp:
        for var in ("TCSDN_KNN_TOPK", "TCSDN_SVC_KERNEL",
                    "TCSDN_FOREST_KERNEL"):
            mp.delenv(var, raising=False)
        yield


def scores_scale(family: str, d: dict, X: np.ndarray) -> np.ndarray:
    """(N, C) float64 sum of the absolute values of each score's terms —
    the scale of its float32 rounding."""
    X = X.astype(np.float64)
    if family == "logreg":
        return np.abs(X) @ np.abs(d["coef"]).T + np.abs(d["intercept"])
    if family == "gnb":
        f = jgnb.from_numpy(d)
        q = ((X[:, None, :] - np.asarray(f.theta, np.float64)[None]) ** 2
             * np.asarray(f.inv_var, np.float64)[None]).sum(-1)
        const = np.abs(np.asarray(f.log_const, np.float64))
        return np.where(np.isfinite(const), const, 0.0)[None, :] + 0.5 * q
    c = np.asarray(d["cluster_centers"], np.float64)
    return ((X[:, None, :] - c[None]) ** 2).sum(-1)


def _served_X(n_flows: int = 300) -> np.ndarray:
    return ft.features12(chip_smoke.synthetic_table(n_flows, 3, "cpu")).numpy()


def _case(family: str, case: str):
    """(importer dict, X) of one seeded case."""
    X = _served_X()
    d = FAMILIES[family][1](0, X)
    if case == "nonfinite":
        X = chip_smoke.with_nonfinite(torch.from_numpy(X), every=3).numpy()
    elif case == "absent-class":
        d["class_prior"][2] = 0.0
        d["class_prior"] /= d["class_prior"].sum()
        d["theta"][2] = np.nan  # a fit's moments of a class with no rows
        d["var"][2] = np.nan
    return d, X


def _near_tie_rows(jax_scores, scale, rows) -> list:
    s = np.sort(jax_scores[rows], axis=1)
    gap = s[:, -1] - s[:, -2]
    return [r for r, g, sc in zip(rows, gap, scale[rows].max(1))
            if g <= 2e-6 * sc]


CASES = [("logreg", "served"), ("logreg", "nonfinite"), ("gnb", "served"),
         ("gnb", "nonfinite"), ("gnb", "absent-class"), ("kmeans", "served"),
         ("kmeans", "nonfinite")]


@pytest.mark.parametrize("family,case", CASES)
def test_scores_and_labels_equal_jax(family, case):
    jmod, _, carry, _ = FAMILIES[family]
    d, X = _case(family, case)
    jp = jmod.from_numpy(d)
    want = np.asarray(jmod.scores(jp, X))
    want_labels = np.asarray(jmod.predict(jp, X))
    m = carry(d, device="cpu")
    got_labels_t, got_t = m.predict_scores(torch.from_numpy(X))
    got, got_labels = got_t.numpy(), got_labels_t.numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~finite & ~np.isnan(want)],
                                  want[~finite & ~np.isnan(want)])
    scale = scores_scale(family, d, X)
    err = np.abs(got[finite].astype(np.float64) - want[finite])
    assert (err <= 1e-6 * scale[finite]).all(), (err / scale[finite]).max()
    differ = np.flatnonzero(got_labels != want_labels)
    assert differ.size == len(_near_tie_rows(want, scale, differ)), (
        f"labels differ off near-ties at rows {differ.tolist()}")
    assert differ.size == 0, f"near-tie rows {differ.tolist()}"
    assert np.array_equal(m.predict(torch.from_numpy(X)).numpy(), got_labels)
    if case == "absent-class":
        assert np.isneginf(got[:, 2]).all() and (got_labels != 2).all()
    if case == "served":
        assert len(np.unique(got_labels)) > 2


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_interop_from_jax_params_equals_from_importer_dict(family):
    """The JAX ``Params`` carried across and the port's own import of the
    same importer dict are the same module, buffer for buffer."""
    jmod, build, carry, _ = FAMILIES[family]
    d = build(0, _served_X())
    a = carry(jmod.from_numpy(d), device="cpu")
    b = carry(d, device="cpu")
    for (ka, va), (kb, vb) in zip(a.named_buffers(), b.named_buffers()):
        assert ka == kb and va.dtype == torch.float32
        assert torch.equal(va, vb), ka


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_checkpoint_round_trip_and_host_rung(tmp_path, family):
    _, build, carry, classes = FAMILIES[family]
    X = _served_X()
    m = carry(build(0, X), device="cpu")
    tck.save_model(str(tmp_path), family, m, classes=classes)
    lm = tck.load_model(str(tmp_path), device="cpu")
    assert lm.name == family and lm.classes.names == tuple(classes)
    for (k, v), (_, w) in zip(m.named_buffers(), lm.params.named_buffers()):
        assert torch.equal(v, w), k
    predict, params = lm.serving_path()
    Xt = torch.from_numpy(X)
    want = m.predict(Xt).numpy()
    assert np.array_equal(predict(params, Xt).numpy(), want)
    fb = resolve_fallback(family, lm.params)
    assert fb.kind == "plain-cpu"
    assert np.array_equal(fb.predict(X), want)
    assert np.array_equal(fb.scores(X), m.scores(Xt).numpy())


def test_kmeans_checkpoint_without_names_decodes_cluster_labels(tmp_path):
    m = interop.kmeans_params_from_numpy(
        chip_smoke.random_kmeans(0, _served_X()), device="cpu")
    tck.save_model(str(tmp_path), "kmeans", m)
    lm = tck.load_model(str(tmp_path), device="cpu")
    assert lm.classes.names == tkmeans.CLUSTER_LABELS_CHECKPOINT
    assert tkmeans.CLUSTER_LABELS_CHECKPOINT == \
        jkmeans.CLUSTER_LABELS_CHECKPOINT


def test_subcommand_aliases_equal_jax():
    from traffic_classifier_sdn_tpu.models import SUBCOMMAND_ALIASES as jal

    assert SUBCOMMAND_ALIASES == jal
    # the classify subcommands, and since the training path JAX's whole
    # list in its order
    assert tcli.SUBCOMMANDS == jcli.SUBCOMMANDS
    assert set(tcli.SUBCOMMANDS) - {"train", "retrain", "analyze"} == set(jal)


@pytest.mark.parametrize("row", [[1.0, np.nan, 3.0, np.nan],
                                 [np.nan, 5.0, np.nan, 1.0],
                                 [-np.inf] * 4, [2.0, 2.0, 1.0, 2.0],
                                 [-0.0, 0.0, -0.0, 0.0]],
                         ids=["nan-after-max", "nan-first", "all-neg-inf",
                              "ties", "signed-zeros"])
def test_argmax_picks_as_jnp_argmax(row):
    """The first maximum wins, and the first NaN counts as the maximum."""
    import jax.numpy as jnp

    x = np.asarray([row], np.float32)
    assert argmax_labels(torch.from_numpy(x)).tolist() == \
        np.asarray(jnp.argmax(x, axis=-1)).tolist()


def _checkpoints(tmp_path, sub, X_sample):
    family = SUBCOMMANDS[sub]
    jmod, build, carry, classes = FAMILIES[family]
    d = build(0, X_sample)
    jp = jmod.from_numpy(d)
    jdir, tdir = str(tmp_path / "jax_ckpt"), str(tmp_path / "port_ckpt")
    jck.save_model(jdir, family, jp, classes=classes)
    tck.save_model(tdir, family, carry(jp, device="cpu"), classes=classes)
    return d, jdir, tdir


def _classes_shown(out: str) -> set:
    return {lab for t in chip_smoke.parse_tables(out) for _, lab in t}


def _serve_both(capsys, sub, jdir, tdir, argv):
    jcli.main([sub, "--native-checkpoint", jdir, *argv, *JAX_SLICE_FLAGS])
    jax_io = capsys.readouterr()
    summary = tcli.main([sub, "--native-checkpoint", tdir, *argv,
                         "--device", "cpu", *PORT_SERIAL])
    return jax_io, capsys.readouterr(), summary


@pytest.mark.parametrize("sub", sorted(SUBCOMMANDS))
def test_family_synthetic_serve_stdout_identical(tmp_path, capsys, sub):
    """The synthetic source on a table too small for its flows (drops and
    the table-full warning)."""
    syn = SyntheticFlows(n_flows=300)
    X = _sample_features([syn.tick() for _ in range(2)], 512)
    _, jdir, tdir = _checkpoints(tmp_path, sub, X)
    argv = ["--source", "synthetic", "--synthetic-flows", "300",
            "--capacity", "256", "--max-ticks", "4", "--print-every", "2"]
    jax_io, port_io, summary = _serve_both(capsys, sub, jdir, tdir, argv)
    assert port_io.out == jax_io.out
    assert port_io.out.count("Flow ID") == 2
    assert len(_classes_shown(port_io.out)) > 1
    assert summary.engine.num_flows() == 256


@pytest.mark.parametrize("table_rows", ["64", "0"])
@pytest.mark.parametrize("sub", sorted(SUBCOMMANDS))
def test_family_replay_serve_stdout_identical(tmp_path, capsys, sub,
                                              table_rows):
    """The replay capture of ``write_capture`` (counter wrap, reset, full
    wire, malformed lines, idle eviction), ranked and full renders."""
    cap = tmp_path / "capture.tsv"
    write_capture(cap)
    X = _sample_features(iter_capture(str(cap)), 64)
    _, jdir, tdir = _checkpoints(tmp_path, sub, X)
    argv = ["--source", "replay", "--capture", str(cap), "--capacity", "64",
            "--print-every", "2", "--idle-timeout", "2",
            "--table-rows", table_rows]
    jax_io, port_io, summary = _serve_both(capsys, sub, jdir, tdir, argv)
    assert port_io.out == jax_io.out
    assert port_io.out.count("Flow ID") == 4
    assert len(_classes_shown(port_io.out)) > 1
    assert summary.engine.num_flows() == 40 - 13


@pytest.mark.parametrize("sub", sorted(SUBCOMMANDS))
def test_no_flag_serve_deep_enough_is_byte_identical(tmp_path, monkeypatch,
                                                     sub):
    """With no flag (pipelined, the ladder, host-mode incremental labels
    through the family's plain predict) and a handoff deeper than the
    serve's renders, stdout is the JAX serial serve's, on the churn
    capture (churn from 0 to 100 %, idle eviction of every flow at the
    fourth render)."""
    monkeypatch.setattr(tcli, "PIPELINE_DEPTH", 64)
    capture, X = _capture_and_sample(tmp_path)
    _, jdir, tdir = _checkpoints(tmp_path, sub, X)
    common = [sub, "--source", "replay", "--capture", capture,
              "--capacity", "48", "--print-every", "1",
              "--idle-timeout", "2", "--table-rows", "16"]
    want, _ = _run(jcli.main, common + ["--native-checkpoint", jdir,
                                        "--pipeline", "off"])
    got, summary = _run(tcli.main, common + ["--native-checkpoint", tdir,
                                             "--device", "cpu"])
    assert got == want and want.count("Flow ID") == 6
    assert summary.degrade["state"] == "HEALTHY"
    assert summary.degrade["fallback"] == "plain-cpu"
    # a plan made before the last one's labels are committed on the
    # device stage is full, so only the first plan's kind is fixed
    assert len(summary.render_plans) == 6
    assert summary.render_plans[0][0] == "full"


def test_gaussiannb_dispatch_error_demotes_to_plain_cpu_and_repromotes(
        tmp_path, monkeypatch):
    """``degrade.dispatch_error`` armed on the second device call: the
    ladder demotes to the ``plain-cpu`` rung, serves its labels, and
    re-promotes after two clean probes; stdout is the unarmed serve's."""
    monkeypatch.setattr(tcli, "PIPELINE_DEPTH", 64)
    capture, X = _capture_and_sample(tmp_path)
    _, _, tdir = _checkpoints(tmp_path, "gaussiannb", X)
    argv = ["gaussiannb", "--source", "replay", "--capture", capture,
            "--capacity", "48", "--print-every", "1", "--probe-every", "0",
            "--probe-successes", "2", "--native-checkpoint", tdir,
            "--device", "cpu"]
    want, _ = _run(tcli.main, argv)
    plan = tfaults.FaultPlan([tfaults.FaultRule("degrade.dispatch_error",
                                                after=1)])
    with tfaults.installed(plan):
        got, summary = _run(tcli.main, argv)
    assert got == want
    assert summary.degrade_transitions == [
        ("HEALTHY", "DEGRADED", "error:FaultInjected"),
        ("DEGRADED", "PROBING", "probe-due"),
        ("PROBING", "HEALTHY", "promoted"),
    ]
    assert summary.degrade["fallback"] == "plain-cpu"
    assert summary.degrade["fallback_calls"] >= 1
