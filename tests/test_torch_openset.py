"""Open-set rejection in the port (``serving/openset.py``) against the JAX
package's (``traffic_classifier_sdn_tpu/serving/openset.py``), on the same
seeded numpy inputs.

Tolerances:

- ``class_reference``, ``floored_std``, ``reference_matrices``,
  ``openset_scores``, the frozen threshold, the re-based stats and the
  persisted reference: bitwise (the same float64 numpy arithmetic);
- the gate's host labels (a ``host_native`` predict, numpy labels):
  equal;
- the gate's device labels (a tensor predict: the float32 torch relabel)
  against JAX's: equal on every row whose float64 score is further than
  ``1e-5`` relative from the threshold (float32 epsilon is 1.2e-7; a
  12-term float32 mean and square root stay well inside 1e-5), and such
  rows are reported — with these seeds none is that close;
- CLI: a serve with novel conversations arriving prints ``unknown`` rows,
  stdout byte-equal to the JAX serial serve.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from traffic_classifier_sdn_tpu import cli as jcli
from traffic_classifier_sdn_tpu.io import checkpoint as jck
from traffic_classifier_sdn_tpu.models import gnb as jgnb
from traffic_classifier_sdn_tpu.serving import openset as jos
from traffic_classifier_sdn_tpu.utils.metrics import Metrics as JMetrics
from traffic_classifier_sdn_tpu_torch import cli as tcli
from traffic_classifier_sdn_tpu_torch import interop
from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
from traffic_classifier_sdn_tpu_torch.io import checkpoint as tck
from traffic_classifier_sdn_tpu_torch.serving import openset as tos
from traffic_classifier_sdn_tpu_torch.utils import faults as tfaults
from traffic_classifier_sdn_tpu_torch.utils.metrics import Metrics as TMetrics

CLASSES = chip_smoke.CLASSES
TIE_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU fits here issue many small torch ops; one intra-op
    thread each keeps them from contending with the suite's other
    workers for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _teacher(params, X):
    return (np.asarray(X)[:, 0] > 500.0).astype(np.int32)


def _batch(lo, hi, n=32, seed=0):
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 12), np.float32)
    X[: n // 2, 0] = lo * (1 + 0.01 * rng.rand(n // 2))
    X[n // 2:, 0] = hi * (1 + 0.01 * rng.rand(n - n // 2))
    X[:, 1] = 1.0
    X[:, 2:] = rng.gamma(2.0, 20.0, (n, 10))
    return X


def _novel_batch(n=16, seed=0):
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 12), np.float32)
    X[:, 0] = 5e4 * (1 + 0.1 * rng.rand(n))
    X[:, 1] = 1.0
    X[:, 5] = 7e3 * (1 + 0.1 * rng.rand(n))
    return X


def _mixed(seed: int):
    """Known rows, novel rows, inactive (all-zero) rows and rows near the
    known classes' edges."""
    rng = np.random.RandomState(seed)
    near = _batch(10.0, 1000.0, n=16, seed=seed + 100)
    near[:, 2:] *= 1 + 1.5 * rng.rand(16, 10)
    return np.concatenate([_batch(10.0, 1000.0, seed=seed),
                           _novel_batch(seed=seed), np.zeros((4, 12),
                                                             np.float32),
                           near])


def _gates(predicts=(_teacher, _teacher), rows=64, margin=3.0):
    """A JAX gate and a port gate fed the same calibration stream."""
    j = jos.OpenSetGate(predicts[0], n_classes=2, margin=margin,
                        calibration_rows=rows, metrics=JMetrics())
    t = tos.OpenSetGate(predicts[1], n_classes=2, margin=margin,
                        calibration_rows=rows, metrics=TMetrics())
    i = 0
    while t.state == tos.CALIBRATING:
        i += 1
        assert i < 64, "gate never armed"
        X = _batch(10.0, 1000.0, seed=i)
        _same_labels(j(None, X), t(None, X))
    assert j.state == jos.ARMED
    return j, t


def _same_labels(a, b) -> None:
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def _same_dict(a: dict, b: dict) -> None:
    assert a.keys() == b.keys(), set(a) ^ set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_math_is_bitwise(seed):
    rng = np.random.RandomState(seed)
    X = rng.gamma(2.0, 100.0, (200, 12))
    X[:, 3] = 7.0  # a constant feature: the global-std floor at 0
    y = rng.randint(0, 4, 200)
    y[::7] = 3  # the unknown index of a 3-class model
    y[y == 1] = 0  # class 1 absent: dropped from the matrices
    ref_j, ref_t = jos.class_reference(X, y, 3), tos.class_reference(X, y, 3)
    _same_dict(ref_j, ref_t)
    g = X.std(axis=0)
    assert jos.floored_std(ref_j["class_std"], g).tobytes() == \
        tos.floored_std(ref_t["class_std"], g).tobytes()
    mj, mt = jos.reference_matrices(ref_j, g), tos.reference_matrices(ref_t, g)
    assert mt[0].shape == (2, 12)
    for a, b in zip(mj, mt):
        assert a.tobytes() == b.tobytes()
    Q = np.concatenate([X[:50], _novel_batch(seed=seed)])
    assert jos.openset_scores(Q, *mj).tobytes() == \
        tos.openset_scores(Q, *mt).tobytes()
    assert tos.reference_matrices(
        {"class_count": np.zeros(3), "class_mean": np.zeros((3, 12)),
         "class_std": np.ones((3, 12))}, g) is None


def test_gate_freeze_threshold_and_host_labels_equal_jax():
    j, t = _gates()
    assert np.float64(j.threshold).tobytes() == \
        np.float64(t.threshold).tobytes()
    _same_dict(j.reference_arrays(), t.reference_arrays())
    assert j.label_epoch == t.label_epoch
    for seed in range(3):
        X = _mixed(seed)
        out_j, out_t = j(None, X), t(None, torch.from_numpy(X))
        _same_labels(out_j, out_t)
        assert (np.asarray(out_t)[32:48] == t.unknown_index).all()
        assert (np.asarray(out_t)[48:52] != t.unknown_index).all()
    assert j.status() == t.status()
    assert t.status()["rejections"] >= 48


def test_gate_device_labels_equal_jax_away_from_threshold_ties():
    """A tensor-returning predict takes the float32 torch relabel; JAX's
    jitted relabel is its counterpart. Labels equal away from ties; the
    lazy rejection count lands at the next call."""
    def jax_device(params, X):
        return jnp.asarray(_teacher(params, X))

    def port_device(params, X):
        return torch.from_numpy(_teacher(params, X))

    j, t = _gates((jax_device, port_device))
    ref = t.reference_arrays()
    for seed in range(4):
        X = _mixed(seed)
        out_j = np.asarray(j(None, jnp.asarray(X)))
        out_t = t(None, torch.from_numpy(X))
        assert isinstance(out_t, torch.Tensor) and out_t.dtype == torch.int32
        s64 = tos.openset_scores(X, ref["openset_mean"],
                                 ref["openset_inv_std"])
        thr = float(ref["openset_threshold"])
        ties = np.abs(s64 - thr) <= TIE_RTOL * thr
        assert not ties.any(), np.nonzero(ties)[0]
        assert np.array_equal(out_j[~ties], out_t.numpy()[~ties])
        # and the float64 host rule on the same rows
        host = np.where(X.any(1) & (s64 > thr), 2, _teacher(None, X))
        assert np.array_equal(host[~ties], out_t.numpy()[~ties])
    t(None, torch.from_numpy(_batch(10.0, 1000.0, seed=99)))
    j(None, jnp.asarray(_batch(10.0, 1000.0, seed=99)))
    assert t.status()["rejections"] == j.status()["rejections"] >= 64


def test_device_stats_upload_once_per_epoch():
    calls = []

    def port_device(params, X):
        return torch.from_numpy(_teacher(params, X))

    _, t = _gates((_teacher, port_device))
    real = torch.tensor

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    X = torch.from_numpy(_mixed(0))
    t(None, X)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tos.torch, "tensor", counting)
        for _ in range(3):
            t(None, X)
    assert calls == []  # cached: no upload a tick
    window = np.concatenate([_batch(10.0, 1000.0, seed=i)
                             for i in range(50, 54)])
    assert t.rebase(window, _teacher(None, window))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tos.torch, "tensor", counting)
        t(None, X)
        t(None, X)
    assert len(calls) == 3  # one upload (mean, inv_std, threshold)


def test_rebase_excludes_unknown_rows_as_jax_does():
    j, t = _gates()
    known = np.concatenate([_batch(10.0, 1000.0, seed=i)
                            for i in range(60, 64)])
    window = np.concatenate([known, _novel_batch(n=64, seed=60)])
    y = np.concatenate([_teacher(None, known), np.full(64, 2, np.int32)])
    e0 = t.label_epoch
    assert j.rebase(window, y) and t.rebase(window, y)
    assert t.label_epoch != e0 and t.label_epoch == j.label_epoch
    _same_dict(j.reference_arrays(), t.reference_arrays())
    X = _novel_batch(seed=61)
    _same_labels(j(None, X), t(None, X))
    assert (np.asarray(t(None, X)) == 2).all()
    assert not t.rebase(window[-8:], y[-8:])  # unknown rows only


def test_restored_reference_boots_armed():
    _, t = _gates()
    ref = t.reference_arrays()
    back = tos.OpenSetGate(_teacher, n_classes=2, reference=ref)
    assert back.state == tos.ARMED and back.threshold == t.threshold
    _same_dict(back.reference_arrays(), ref)
    with pytest.raises(ValueError, match="different layout"):
        tos.OpenSetGate(_teacher, n_classes=2, reference=dict(
            ref, openset_inv_std=np.ones((1, 12))))


def test_capture_is_opt_in_and_carries_the_relabels():
    _, t = _gates()
    X = _mixed(0)
    t(None, X)
    assert t.take_capture() is None
    t.enable_capture()
    out = t(None, X)
    cap = t.take_capture()
    assert cap[0] is X and np.array_equal(cap[1], out)
    assert t.take_capture() is None


@pytest.mark.parametrize("site", ["openset.score", "openset.calibrate"])
def test_fault_sites_are_absorbed(site):
    """``openset.score``: the tick serves the inner labels fresh;
    ``openset.calibrate``: the sample is dropped (arming takes longer) and
    a failed rebase keeps the previous stats."""
    if site == "openset.score":
        _, t = _gates()
        X = _mixed(1)
        plan = tfaults.FaultPlan([tfaults.FaultRule(site)])
        with tfaults.installed(plan):
            out = t(None, X)
        np.testing.assert_array_equal(out, _teacher(None, X))
        assert t.status()["score_faults"] == 1
        assert (np.asarray(t(None, X))[32:48] == 2).all()
        return
    t = tos.OpenSetGate(_teacher, n_classes=2, calibration_rows=64)
    plan = tfaults.FaultPlan([tfaults.FaultRule(site, times=None)])
    with tfaults.installed(plan):
        for i in range(6):
            X = _batch(10.0, 1000.0, seed=i)
            np.testing.assert_array_equal(t(None, X), _teacher(None, X))
        assert t.state == tos.CALIBRATING
    for i in range(6, 12):
        t(None, _batch(10.0, 1000.0, seed=i))
    assert t.state == tos.ARMED
    before = t.reference_arrays()
    with tfaults.installed(tfaults.FaultPlan([tfaults.FaultRule(site)])):
        assert not t.rebase(_novel_batch(n=64), np.zeros(64, np.int32))
    _same_dict(before, t.reference_arrays())
    # a tick folds the previous tick's pair: 6 ticks fold 5 samples,
    # then the rebase
    assert t.status()["calibrate_faults"] == 6


def _serve(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        summary = main(argv)
    return out.getvalue(), summary


@pytest.mark.parametrize("incremental", ["auto", "off"])
def test_novel_traffic_serve_prints_unknown_as_jax(tmp_path, incremental):
    """40 known conversations, then 8 novel ones from tick 6: the gate
    (calibrated on the first ticks) labels them ``unknown`` in the table,
    and stdout is the JAX serial serve's byte for byte."""
    capture = str(tmp_path / "novel.capture")
    chip_smoke.drift_capture(capture, 40, 10, shift_at=99, novel_at=5,
                             novel_flows=8)
    X = ft.features12(chip_smoke.synthetic_table(300, 3, "cpu")).numpy()
    d = chip_smoke.random_gnb(0, X)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jck.save_model(jdir, "gnb", jgnb.from_numpy(d), classes=CLASSES)
    tck.save_model(tdir, "gnb", interop.gnb_params_from_numpy(d, "cpu"),
                   classes=CLASSES)
    argv = ["gaussiannb", "--source", "replay", "--capture", capture,
            "--capacity", "64", "--print-every", "1", "--idle-timeout", "0",
            "--table-rows", "0", "--pipeline", "off", "--incremental",
            incremental, "--openset", "auto",
            "--openset-calibration-rows", "64"]
    want, _ = _serve(jcli.main, argv + ["--native-checkpoint", jdir])
    got, summary = _serve(tcli.main, argv + ["--native-checkpoint", tdir,
                                             "--device", "cpu"])
    assert got == want
    last = chip_smoke.parse_tables(got)[-1]
    unknown = [s for s, lab in last if lab == "unknown"]
    assert len(unknown) >= 8
    assert summary.openset["state"] == "ARMED"
    assert summary.openset["last_rejected"] >= 8
