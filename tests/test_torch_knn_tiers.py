"""The ``--knn-topk`` menu of the port: its exact tiers (``argmax``,
``hier[<group>]``, ``screened[<group>]``) against the same-named JAX tiers
(``models/knn._topk_*_idx``), ``resolve_knn_topk`` and the serving-path
resolution of ``TCSDN_KNN_TOPK``, ``TCSDN_SVC_KERNEL`` and
``TCSDN_FOREST_KERNEL``, and the CLI's ``--knn-topk`` serves against the
JAX serial serve.

Tolerances, stated: neighbor indices bitwise. Each tier is held to its own
JAX tier on the same similarity matrix, never to another tier: the JAX
tiers differ among themselves on signed zeros (``jnp.argmax`` ties +0 with
−0, ``lax.top_k`` orders +0 above −0) and on non-finite rows (argmax and
screened assume finite similarities). The similarity matrices are integer
valued with many ties and signed zeros; the model-level and serve checks
use an integer corpus, where every similarity is exact in both packages'
arithmetic, so serve stdout is byte-identical.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traffic_classifier_sdn_tpu import cli as jcli
from traffic_classifier_sdn_tpu import models as jmodels
from traffic_classifier_sdn_tpu.io import checkpoint as jck
from traffic_classifier_sdn_tpu.models import knn as jknn
from traffic_classifier_sdn_tpu.train import knn as jtknn
from traffic_classifier_sdn_tpu_torch import cli as tcli
from traffic_classifier_sdn_tpu_torch import interop
from traffic_classifier_sdn_tpu_torch import models as tmodels
from traffic_classifier_sdn_tpu_torch.ingest.protocol import (
    TelemetryRecord,
    format_line,
)
from traffic_classifier_sdn_tpu_torch.io import checkpoint as tck
from traffic_classifier_sdn_tpu_torch.models import knn as tknn
from traffic_classifier_sdn_tpu_torch.native import knn as native_knn

MENU_VARS = ("TCSDN_KNN_TOPK", "TCSDN_SVC_KERNEL", "TCSDN_FOREST_KERNEL")


@pytest.fixture(autouse=True)
def _menu_env(monkeypatch):
    """Each test starts with the menus unset and leaves them as it found
    them: both CLIs publish ``--knn-topk`` through TCSDN_KNN_TOPK."""
    for var in MENU_VARS:
        monkeypatch.setenv(var, "")
        monkeypatch.delenv(var)


def _tie_sim(seed: int, n: int, S: int) -> np.ndarray:
    """An integer similarity matrix in [−3, 2] with a fifth of its entries
    −0.0 (+0 elsewhere): heavy ties and signed zeros, all finite."""
    rng = np.random.RandomState(seed)
    sim = rng.randint(-3, 3, (n, S)).astype(np.float32)
    sim[rng.rand(n, S) < 0.2] = -0.0
    return sim


def _zero_sim(seed: int, n: int, S: int) -> np.ndarray:
    """Entries from {−2, −1, −0, +0}: group maxima are often a zero of
    either sign, where ``jnp.max`` takes +0 over −0."""
    rng = np.random.RandomState(seed)
    return rng.choice(np.array([-2, -1, -0.0, 0.0], np.float32), (n, S))


TIERS = {  # tier -> (JAX index function, port index function)
    "argmax": (lambda s, k, g: jknn._topk_argmax_idx(s, k),
               lambda s, k, g: tknn.topk_argmax_idx(s, k)),
    "hier": (lambda s, k, g: jknn._topk_hier_idx(s, k, group=g),
             lambda s, k, g: tknn.topk_hier_idx(s, k, group=g)),
    "screened": (lambda s, k, g: jknn._topk_screened_idx(s, k, group=g),
                 lambda s, k, g: tknn.topk_screened_idx(s, k, group=g)),
}


def _both_idx(tier: str, sim: np.ndarray, k: int, group: int):
    jf, tf = TIERS[tier]
    want = np.asarray(jf(jnp.asarray(sim), k, group))
    got = tf(torch.from_numpy(sim), k, group)
    assert got.dtype == torch.int32
    return got.numpy(), want


@pytest.mark.parametrize("tier,S,k,group", [
    ("argmax", 301, 5, 0), ("argmax", 5, 5, 0), ("argmax", 64, 1, 0),
    ("hier", 301, 5, 16), ("hier", 301, 5, 5), ("hier", 300, 5, 128),
    ("hier", 4448, 5, 128), ("hier", 37, 9, 10),
    ("screened", 301, 5, 8), ("screened", 301, 5, 1), ("screened", 300, 5, 32),
    ("screened", 4448, 5, 32), ("screened", 33, 5, 8),
    ("screened", 301, 5, 64),
], ids=lambda v: str(v))
@pytest.mark.parametrize("make", [_tie_sim, _zero_sim],
                         ids=["ties", "signed-zero-maxima"])
def test_tier_equals_jax_tier_bitwise(tier, S, k, group, make):
    """Each tier against the same-named JAX tier on the same similarity
    rows: several groups, group = k, S not a multiple of the group, and
    (screened, S = 33, group 8; S = 301, group 64) fewer than k groups,
    where the tier is the full sort."""
    sim = make(S + k + group, 40, S)
    got, want = _both_idx(tier, sim, k, group)
    np.testing.assert_array_equal(got, want)


def test_tiers_on_the_signed_zero_probe():
    """The sim row [−0, +0, −210, −0, +0] with k = 2 (Queue 3 item 2's
    probe): ``sort``, ``hier`` and ``screened`` take the two +0 (indices
    1 and 4), ``argmax`` the first two maxima under IEEE compare (0, 1),
    each as its JAX tier does."""
    sim = np.array([[-0.0, 0.0, -210.0, -0.0, 0.0]], np.float32)
    want = {"argmax": [[0, 1]], "hier": [[1, 4]], "screened": [[1, 4]]}
    for tier, group in (("argmax", 0), ("hier", 2), ("screened", 1)):
        got, jax_idx = _both_idx(tier, sim, 2, group)
        np.testing.assert_array_equal(got, jax_idx)
        np.testing.assert_array_equal(got, want[tier])
    np.testing.assert_array_equal(
        tknn.topk_stable(torch.from_numpy(sim), 2)[1].numpy(), [[1, 4]])


def test_hier_on_the_total_order_probe():
    """Queue 3 item 2's total-order probe [1, −NaN, −0, +0, +NaN, inf,
    −inf, +0, −0, 1]: the hier tier (no finiteness precondition) equals
    the JAX hier tier bitwise, −inf padding above −NaN included; argmax
    and screened assume finite similarities and are not held here."""
    a = np.array([1, 0, -0.0, 0, np.nan, np.inf, -np.inf, 0, -0.0, 1],
                 np.float32)
    a.view(np.uint32)[1] = 0xFFC00000
    for group in (10, 16):
        got, want = _both_idx("hier", a[None], 10, group)
        np.testing.assert_array_equal(got, want)
    got, _ = _both_idx("hier", a[None], 10, 10)
    np.testing.assert_array_equal(got[0], [4, 5, 0, 9, 3, 7, 2, 8, 6, 1])


def _int_knn(seed: int, S: int = 64, k: int = 3, n_classes: int = 2):
    """(JAX params, port model) of an integer corpus from the JAX trainer."""
    rng = np.random.RandomState(seed)
    X = rng.randint(0, 50, (S, 12)).astype(np.float64)
    y = rng.randint(0, n_classes, S)
    jp = jtknn.fit(X, y, n_neighbors=k, n_classes=n_classes)
    return jp, interop.knn_params_from_numpy(jp, device="cpu")


@pytest.mark.parametrize("impl", ["sort", "argmax", "hier", "hier5",
                                  "hier16", "screened", "screened4"])
def test_model_votes_equal_jax_per_tier(impl):
    """``KnnModel.neighbor_votes``/``predict``/``predict_scores``/
    ``predict_chunked`` with ``top_k_impl`` against JAX's on an integer
    corpus (every similarity exact): votes and labels bitwise."""
    jp, tp = _int_knn(3, S=200, k=5, n_classes=4)
    rng = np.random.RandomState(4)
    X = rng.randint(0, 50, (90, 12)).astype(np.float32)
    want = np.asarray(jknn.neighbor_votes(jp, jnp.asarray(X), top_k_impl=impl))
    Xt = torch.from_numpy(X)
    np.testing.assert_array_equal(
        tp.neighbor_votes(Xt, top_k_impl=impl).numpy(), want)
    labels = np.asarray(jknn.predict(jp, jnp.asarray(X), top_k_impl=impl))
    np.testing.assert_array_equal(tp.predict(Xt, top_k_impl=impl).numpy(),
                                  labels)
    lab, sc = tp.predict_scores(Xt, top_k_impl=impl)
    np.testing.assert_array_equal(lab.numpy(), labels)
    np.testing.assert_array_equal(sc.numpy(), want)
    np.testing.assert_array_equal(
        tp.predict_chunked(Xt, row_chunk=32, top_k_impl=impl).numpy(), labels)
    np.testing.assert_array_equal(
        tknn.serve_predict(tp, Xt, top_k_impl=impl).numpy(), labels)


def test_unknown_tier_raises():
    with pytest.raises(ValueError, match="unknown top_k_impl"):
        tknn.neighbor_idx(torch.zeros((1, 8)), 2, "bogus")
    with pytest.raises(ValueError, match="k=5 must be <= group=4"):
        tknn.topk_hier_idx(torch.zeros((1, 8)), 5, group=4)


# -- the menus -------------------------------------------------------------

def test_resolve_validates_names_as_jax(monkeypatch):
    """Names, numeric suffixes and errors as JAX's tests/test_knn_topk.py."""
    jres = jmodels.resolve_knn_topk
    assert tmodels.resolve_knn_topk() == "sort"
    assert tmodels.KNN_TOPK_CHOICES == jmodels.KNN_TOPK_CHOICES
    for ok in ("sort", "argmax", "hier", "hier512", "screened",
               "screened16", "pallas", "native", "ivf", "ivf4"):
        assert tmodels.resolve_knn_topk(ok) == ok == jres(ok)
    for bad in ("bogus", "hier512x", "screened-8", "ivf4.5", "IVF", "hier0",
                "screened0", "ivf0"):
        with pytest.raises(ValueError, match="unknown KNN top-k"):
            tmodels.resolve_knn_topk(bad)
        with pytest.raises(ValueError, match="unknown KNN top-k"):
            jres(bad)
    monkeypatch.setenv("TCSDN_KNN_TOPK", "screened64")
    assert tmodels.resolve_knn_topk() == "screened64"
    assert tmodels.resolve_knn_topk("argmax") == "argmax"  # value wins


def test_notes_print_once_per_process(capsys):
    for tier in ("native", "ivf"):
        tmodels._KNN_TOPK_WARNED.discard(tier)
    for _ in range(2):
        tmodels.resolve_knn_topk("native")
        tmodels.resolve_knn_topk("ivf8")
        tmodels.resolve_knn_topk("ivf")
    err = capsys.readouterr().err
    assert err.count("NOTE: TCSDN_KNN_TOPK=native ranks by exact f64") == 1
    assert err.count("APPROXIMATE") == 1


def test_knn_serving_path_per_tier(monkeypatch):
    """``sort``/``pallas`` serve the kernel module, the torch tiers
    ``knn.serve_predict``, ``native`` and ``ivf`` (with g++) a
    ``host_native`` predict; every exact tier's labels equal ``sort``'s
    on an integer corpus; group bounds are checked against the corpus."""
    from traffic_classifier_sdn_tpu_torch.ops import knn_ivf, knn_kernel

    _, tp = _int_knn(5, S=120, k=5, n_classes=3)
    X = torch.from_numpy(np.random.RandomState(6).randint(
        0, 50, (70, 12)).astype(np.float32))
    want = knn_kernel.predict(knn_kernel.compile_knn(tp), X).numpy()
    for impl in ("sort", "pallas", "argmax", "hier", "hier5", "screened",
                 "screened64", "native", "ivf", "ivf200"):
        monkeypatch.setenv("TCSDN_KNN_TOPK", impl)
        fn, p = tmodels._build_serving_path("knn", tp)
        host = getattr(fn, "host_native", False)
        assert host == (impl == "native" or (
            impl.startswith("ivf") and native_knn.available())), impl
        if impl in ("sort", "pallas"):
            assert fn is knn_kernel.predict
        elif not host and impl.startswith("ivf"):
            assert fn is knn_ivf.predict_chunked
        labels = np.asarray(fn(p, X))
        if impl != "ivf":  # ivf200 probes every list: the exact search
            np.testing.assert_array_equal(labels, want, err_msg=impl)
    for bad in ("hier4", "hier70000", "screened70000"):
        monkeypatch.setenv("TCSDN_KNN_TOPK", bad)
        with pytest.raises(ValueError, match="group must be in"):
            tmodels._build_serving_path("knn", tp)
    monkeypatch.setenv("TCSDN_KNN_TOPK", "wat")
    with pytest.raises(ValueError, match="unknown KNN top-k"):
        tmodels._build_serving_path("knn", tp)


def test_svc_and_forest_menus(monkeypatch):
    """``TCSDN_SVC_KERNEL``: chunked → the kernel module, dot →
    ``svc.serve_predict_dot``, anything else raises. ``TCSDN_FOREST_KERNEL``:
    every TPU layout name → the forest kernel module, native → a
    ``host_native`` C++ walk (labels equal), anything else raises. The
    degrade ladder's rung ignores both: it is the kernel path's plain
    version (SVC's with its loops in C++, the same labels)."""
    import chip_smoke
    from traffic_classifier_sdn_tpu_torch.models import svc
    from traffic_classifier_sdn_tpu_torch.native import forest as nforest
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel, rbf_kernel

    rng = np.random.RandomState(2)
    Xs = np.abs(rng.gamma(1.0, 100.0, (300, 12))).astype(np.float32)
    sp = interop.svc_params_from_numpy(
        chip_smoke.random_svc(0, Xs, n_sv=64), device="cpu")
    fp = interop.forest_params_from_numpy(
        chip_smoke.random_forest(0, Xs, n_trees=8), device="cpu")
    X = torch.from_numpy(Xs[:50])
    monkeypatch.setenv("TCSDN_SVC_KERNEL", "chunked")
    assert tmodels._build_serving_path("svc", sp)[0] is rbf_kernel.predict
    monkeypatch.setenv("TCSDN_SVC_KERNEL", "dot")
    fn, p = tmodels._build_serving_path("svc", sp)
    assert fn is svc.serve_predict_dot and p is sp
    np.testing.assert_array_equal(fn(p, X).numpy(), sp.predict_dot(X).numpy())
    assert tmodels.resolve_fallback("svc", sp).kind == "native-svc"
    np.testing.assert_array_equal(
        tmodels.resolve_fallback("svc", sp).predict(X.numpy()),
        rbf_kernel.predict(rbf_kernel.compile_svc(sp), X).numpy())
    monkeypatch.setenv("TCSDN_SVC_KERNEL", "bogus")
    with pytest.raises(ValueError, match="TCSDN_SVC_KERNEL"):
        tmodels._build_serving_path("svc", sp)
    kernel_fn, ops = tmodels._kernel_serving_path("forest", fp)
    want = kernel_fn(ops, X).numpy()
    for layout in ("gemm", "pallas", "pallas_fast", "gemm_v2_dot",
                   "gemm_v2_gather"):
        monkeypatch.setenv("TCSDN_FOREST_KERNEL", layout)
        fn, p = tmodels._build_serving_path("forest", fp)
        assert fn is forest_kernel.predict
        np.testing.assert_array_equal(fn(p, X).numpy(), want)
    if nforest.available():
        monkeypatch.setenv("TCSDN_FOREST_KERNEL", "native")
        fn, p = tmodels._build_serving_path("forest", fp)
        assert fn.host_native and p is None
        np.testing.assert_array_equal(fn(p, X), want)
    monkeypatch.setenv("TCSDN_FOREST_KERNEL", "bogus")
    with pytest.raises(ValueError, match="TCSDN_FOREST_KERNEL"):
        tmodels._build_serving_path("forest", fp)


# -- the CLI serves ----------------------------------------------------------

def _rec(t, i, pkts, bts):
    return TelemetryRecord(
        time=t, datapath="1", in_port=1, eth_src=f"f{i:03d}",
        eth_dst="gw", out_port=2, packets=pkts, bytes=bts,
    )


@pytest.fixture(scope="module")
def knn_serve(tmp_path_factory):
    """(JAX checkpoint, port checkpoint, capture): the integer KNN corpus
    and varying-churn capture of JAX's tests/test_knn_topk.py, the port's
    checkpoint carried from the same JAX params."""
    tmp = tmp_path_factory.mktemp("knn_tiers")
    jp, tp = _int_knn(0)
    jdir, tdir = str(tmp / "jax_ckpt"), str(tmp / "port_ckpt")
    jck.save_model(jdir, "knn", jp, classes=("ping", "voice"))
    tck.save_model(tdir, "knn", tp, classes=("ping", "voice"))
    cum, lines = {}, []
    for t, flows in enumerate([range(24), range(4), range(16)], start=1):
        for i in flows:
            p, b = cum.get(i, (0, 0))
            cum[i] = (p + 5 + i, b + 900 + 17 * i)
            lines.append(format_line(_rec(t, i, *cum[i])))
    cap = tmp / "churn.capture"
    cap.write_bytes(b"".join(lines))
    return jdir, tdir, str(cap)


SERVE = ["--source", "replay", "--capacity", "64", "--print-every", "1",
         "--idle-timeout", "0", "--table-rows", "8"]


def _jax_serve(knn_serve, extra):
    jdir, _, cap = knn_serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jcli.main(["knearest", "--native-checkpoint", jdir, "--capture", cap,
                   *SERVE, "--pipeline", "off", *extra])
    return buf.getvalue()


def _port_serve(knn_serve, extra):
    _, tdir, cap = knn_serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tcli.main(["knearest", "--native-checkpoint", tdir, "--capture", cap,
                   *SERVE, "--device", "cpu", *extra])
    return buf.getvalue()


@pytest.mark.parametrize("impl", ["sort", "argmax", "hier", "screened",
                                  "screened16", "native"])
def test_exact_tier_serve_stdout_equals_jax(knn_serve, impl):
    """Every exact tier's port serve — serial, and the no-flag pipelined
    serve — prints the JAX serial serve's stdout byte for byte (the
    integer corpus makes the native tier's f64 ranking agree too)."""
    if impl == "native" and not native_knn.available():
        pytest.skip("g++ cannot build the native KNN evaluator here")
    want = _jax_serve(knn_serve, ["--knn-topk", impl])
    assert want.count("Flow ID") == 3
    assert want == _jax_serve(knn_serve, ["--knn-topk", "sort"])
    for extra in (["--pipeline", "off", "--degrade", "off"],
                  ["--pipeline", "off", "--incremental", "off"], []):
        tcli.PIPELINE_DEPTH, depth = 64, tcli.PIPELINE_DEPTH
        try:
            got = _port_serve(knn_serve, ["--knn-topk", impl, *extra])
        finally:
            tcli.PIPELINE_DEPTH = depth
        assert got == want, (impl, extra)


def test_ivf_serve_opt_in(knn_serve, capsys):
    """``--knn-topk ivf`` serves with the APPROXIMATE note on stderr; at
    an nprobe past K (every list) it prints the exact serve's stdout."""
    tmodels._KNN_TOPK_WARNED.discard("ivf")
    out = _port_serve(knn_serve, ["--knn-topk", "ivf", "--pipeline", "off"])
    assert "Flow ID" in out
    assert "APPROXIMATE" in capsys.readouterr().err
    want = _jax_serve(knn_serve, ["--knn-topk", "sort"])
    assert _port_serve(knn_serve, ["--knn-topk", "ivf64", "--pipeline",
                                   "off"]) == want


def test_unknown_flag_value_is_a_clean_usage_error(knn_serve, capsys):
    with pytest.raises(SystemExit) as ei:
        _port_serve(knn_serve, ["--knn-topk", "bogus"])
    assert ei.value.code == 2
    assert "unknown KNN top-k" in capsys.readouterr().err


def test_flag_wins_over_env(knn_serve, monkeypatch):
    base = _port_serve(knn_serve, ["--knn-topk", "sort", "--pipeline", "off"])
    monkeypatch.setenv("TCSDN_KNN_TOPK", "ivf1")
    assert _port_serve(knn_serve, ["--knn-topk", "sort", "--pipeline",
                                   "off"]) == base
    monkeypatch.setenv("TCSDN_KNN_TOPK", "wat")
    with pytest.raises(ValueError, match="unknown KNN top-k"):
        _port_serve(knn_serve, [])
