"""CPU rehearsal of ``chip_smoke.py``'s helpers (the script itself needs a
CUDA card): the seeded forest, KNN and SVC have the reference checkpoints'
shapes, the bulk synthetic table equals the one the Python ingest path
builds, the table parser reads what the CLI prints, the node-visit count
matches a walk, the bounds follow their operation counts, the plain-label
helpers agree with the serving predicts, the churn capture and its
emitter carry the schedule, and the script refuses to run without a
card."""

import copy
import dataclasses
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import chip_smoke
from traffic_classifier_sdn_tpu_torch import cli, interop
from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
from traffic_classifier_sdn_tpu_torch.ingest.batcher import FlowStateEngine
from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows
from traffic_classifier_sdn_tpu_torch.io import checkpoint
from traffic_classifier_sdn_tpu_torch.models import knn, svc
from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk
from traffic_classifier_sdn_tpu_torch.ops import knn_kernel as kk
from traffic_classifier_sdn_tpu_torch.ops import rbf_kernel as rk
from traffic_classifier_sdn_tpu_torch.ops import tree_gemm
from traffic_classifier_sdn_tpu_torch.serving import degrade as tdegrade
from traffic_classifier_sdn_tpu_torch.utils import faults as tfaults


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


@pytest.fixture(scope="module")
def table():
    return chip_smoke.synthetic_table(200, 3, "cpu")


@pytest.fixture(scope="module")
def forest(table):
    return chip_smoke.random_forest(0, ft.features12(table).numpy())


def test_bulk_table_equals_ingest_path(table):
    engine = FlowStateEngine(200, device="cpu")
    syn = SyntheticFlows(200)
    for _ in range(3):
        engine.mark_tick()
        engine.ingest(syn.tick())
        engine.step()
    for name in ("time_start", "in_use"):
        assert torch.equal(getattr(table, name), getattr(engine.table, name))
    for d in ("fwd", "rev"):
        for f in dataclasses.fields(ft.DirState):
            assert torch.equal(
                getattr(getattr(table, d), f.name),
                getattr(getattr(engine.table, d), f.name),
            ), f"{d}.{f.name}"


def test_random_forest_has_reference_shape(forest):
    left = forest["left"]
    assert left.shape == (100, 101) and forest["values"].shape[2] == 6
    assert forest["max_depth"] <= 14
    for t in range(100):
        reach = tree_gemm._reachable_nodes(left, forest["right"], t)
        assert 25 <= len(reach) <= 101 and len(reach) % 2 == 1
        leaves = [n for n in reach if left[t, n] == -1]
        assert (forest["values"][t, leaves].sum(1) > 0).all()


def _walk_visits(k, X) -> int:
    feat, thr, left, right = (a.numpy() for a in fk.unpack_records(k))
    visits = 0
    for x in fk.effective_features(torch.from_numpy(X)).numpy():
        for t in range(k.n_trees):
            code = 0
            while code < k.n_internal:
                code = (left if x[feat[t, code]] <= thr[t, code] else right)[t, code]
                visits += 1
    return visits


def test_node_visits_and_bound(table, forest):
    k = fk.compile_forest(forest, n_features=12, device="cpu")
    X = ft.features12(table)[:40]
    visits = chip_smoke.node_visits(k, X)
    assert visits == _walk_visits(k, X.numpy())
    ms, by = chip_smoke.forest_bound(k, X, visits)
    assert by in ("bytes", "operations") and ms > 0
    Xn = chip_smoke.with_nonfinite(X, every=3)
    assert chip_smoke.node_visits(k, Xn) == _walk_visits(k, Xn.numpy())


def test_with_nonfinite_marks_one_or_two_features(table):
    X = ft.features12(table)[:70]
    Xn = chip_smoke.with_nonfinite(X)
    bad = ~torch.isfinite(Xn)
    assert torch.equal(bad.any(1), torch.arange(70) % 7 == 0)
    assert set(bad.sum(1)[::7].tolist()) == {1, 2}
    assert torch.isnan(Xn).any() and torch.isposinf(Xn).any()
    assert torch.isneginf(Xn).any()
    assert torch.equal(Xn[~bad.any(1)], X[~bad.any(1)])


def test_parse_tables_reads_cli_output(tmp_path, capsys, forest):
    classes = chip_smoke.CLASSES
    checkpoint.save_model(str(tmp_path), "forest",
                          interop.forest_params_from_numpy(forest, device="cpu"),
                          classes=classes)
    summary = cli.main([
        "Randomforest", "--source", "synthetic", "--synthetic-flows", "90",
        "--capacity", "128", "--max-ticks", "4", "--print-every", "2",
        "--table-rows", "16", "--native-checkpoint", str(tmp_path),
        "--device", "cpu", "--pipeline", "off", "--degrade", "off",
    ])
    tables = chip_smoke.parse_tables(capsys.readouterr().out)
    assert [len(t) for t in tables] == [16, 16]
    k = fk.compile_forest(forest, n_features=12, device="cpu")
    labels = fk.predict(k, summary.engine.features()).numpy()
    assert all(classes[labels[s]] == lab for s, lab in tables[-1])


def test_random_knn_and_svc_have_reference_shapes(table):
    X = ft.features12(table).numpy()
    d = chip_smoke.random_knn(0, X)
    assert d["fit_X"].shape == (4448, 12) and d["n_neighbors"] == 5
    assert set(np.unique(d["y"])) == set(range(6))
    s = chip_smoke.random_svc(0, X)
    n_support = s["n_support"]
    assert s["support_vectors"].shape == (2281, 12) and n_support.sum() == 2281
    assert len(n_support) == 6 and (n_support >= 1).all()
    assert s["dual_coef"].shape == (5, 2281) and s["intercept"].shape == (15,)
    assert np.abs(s["dual_coef"]).max() <= 1.0
    # libsvm's signs: a class-c vector is positive in the pairs (c, o > c)
    # and negative in (o < c, c); row r of dual_coef pairs c with o
    starts = np.concatenate([[0], np.cumsum(n_support)])
    for c in range(6):
        block = s["dual_coef"][:, starts[c]:starts[c + 1]]
        for r in range(5):
            o = r if r < c else r + 1
            assert (np.sign(block[r]) == (1 if c < o else -1)).all()
    var = X.astype(np.float64).var()
    assert s["gamma"] == 1.0 / (12 * var)
    # near the served rows: the RBF values reach the decisions
    m = svc.SvcModel.from_numpy(s, device="cpu")
    K = m.rbf_kernel(torch.from_numpy(X[:50]))
    assert float(K.max(1).values.min()) > 0.1


def test_knn_svc_bounds_and_plain_labels(table):
    X = ft.features12(table)
    g = kk.compile_knn(knn.KnnModel.from_numpy(
        chip_smoke.random_knn(0, X.numpy(), n_rows=300), device="cpu"))
    ms, by = chip_smoke.knn_bound(g, X)
    ops = X.shape[0] * 300 * 25
    assert (ms, by) == (ops / chip_smoke.PEAK_F32_OPS_S * 1e3, "operations")
    assert torch.equal(chip_smoke.knn_plain_predict(g, X),
                       kk.predict(g, X).long())
    gs = rk.compile_svc(svc.SvcModel.from_numpy(
        chip_smoke.random_svc(0, X.numpy(), n_sv=120), device="cpu"))
    ms, by = chip_smoke.svc_bound(gs, X)
    assert (ms, by) == (X.shape[0] * 120 * 80 / chip_smoke.PEAK_F32_OPS_S * 1e3,
                        "operations")
    assert torch.equal(chip_smoke.svc_plain_predict(gs, X),
                       rk.predict(gs, X).long())


def test_kernel_entries_carry_every_key():
    """Each ``{"kernels": ...}`` entry has the keys the contract names,
    the back-to-back time beside the single-call median, taken at the
    main path's rows."""
    results = {
        family: {n: {"max_abs_err": 0.0, "ms": n * 1e-6,
                     "back_to_back_ms": n * 5e-7, "plain_ms": 1.0,
                     "bound_ms": 1e-3, "bound_by": "bytes"}
                 for n in chip_smoke.SHAPES}
        for family in chip_smoke.KERNEL_ROWS
    }
    entries = chip_smoke.kernel_entries(results, {f: 3 for f in results})
    assert [e["name"] for e in entries] == ["forest_proba", "knn_topk",
                                            "rbf_decision"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "back_to_back_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"}
    for e in entries:
        assert keys <= set(e)
        assert e["ms"] == chip_smoke.CAPACITY * 1e-6
        assert e["back_to_back_ms"] == chip_smoke.CAPACITY * 5e-7
        assert e["launches"] == 3 and e["route"] == "cuda"
        assert [r["back_to_back_ms"] for r in e["by_rows"]] == [
            n * 5e-7 for n in chip_smoke.SHAPES]


def test_kernel_entries_carry_paths_and_buckets():
    results = {
        family: {n: {"max_abs_err": 0.0, "ms": 1.0, "back_to_back_ms": 1.0,
                     "plain_ms": 1.0, "bound_ms": 1e-3, "bound_by": "bytes"}
                 for n in chip_smoke.SHAPES}
        for family in chip_smoke.KERNEL_ROWS
    }
    paths = {"serve Randomforest": {"forest": 3, "knn": 0, "svc": 0},
             "incremental Randomforest": {"forest": 5, "knn": 0, "svc": 0}}
    buckets = [{"rows": 16, "ms": 0.01}]
    entries = chip_smoke.kernel_entries(results, {"forest": 3, "knn": 3,
                                                  "svc": 3}, paths, buckets)
    assert entries[0]["launches_by_path"] == {
        "serve Randomforest": 3, "incremental Randomforest": 5}
    assert entries[0]["by_dirty_bucket"] == buckets
    assert entries[1]["launches_by_path"]["incremental Randomforest"] == 0
    assert "by_dirty_bucket" not in entries[1]


def test_churn_capture_and_its_emitter(tmp_path):
    """The capture holds the schedule's share of the conversations per
    tick (both directions), one line of an outside conversation on the
    0 % tick, and the emitter prints it, after one log line."""
    path = tmp_path / "capture"
    reporting = chip_smoke.churn_capture(str(path), 200)
    assert reporting == [200, 200, 2, 0, 40, 200]
    lines = path.read_bytes().splitlines(True)
    times = [int(line.split(b"\t")[1]) for line in lines]
    assert [times.count(t) for t in range(1, 7)] == [400, 400, 4, 1, 80, 400]
    outside = lines[times.index(4)].split(b"\t")[4].decode()
    assert outside == SyntheticFlows(200)._mac(200, 0)
    emitter = tmp_path / "emitter.py"
    emitter.write_text(chip_smoke.EMITTER)
    out = subprocess.run([sys.executable, str(emitter), str(path), "0"],
                         capture_output=True, timeout=60, check=True).stdout
    assert out == b"loading app simple_monitor_13.py\n" + path.read_bytes()


def test_main_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() == 1
    io = capsys.readouterr()
    assert io.out == "" and "no CUDA device" in io.err


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115knn_topk_kernelILi1ELi12EEEvPKfiiPK6float4iiiPfPi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115knn_topk_kernelILi1ELi12EEEvPKfiiPK6float4iiiPfPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 115 registers, used 1 barriers, 32 bytes smem
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__490736b2_15_rbf_decision_cu_71902b5219rbf_decision_kernelILi64ELi12ELi15ELb0EEEvPKfS2_iiPK6float4iifPf' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__490736b2_15_rbf_decision_cu_71902b5219rbf_decision_kernelILi64ELi12ELi15ELb0EEEvPKfS2_iiPK6float4iifPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 54 registers, used 1 barriers, 36352 bytes smem
"""


FOREST_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119forest_proba_kernelILb1EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119forest_proba_kernelILb1EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119forest_proba_kernelILb0EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119forest_proba_kernelILb0EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers
"""


def test_ptxas_instances_name_the_forest_instance():
    """The forest kernel's instances are keyed by the design, as
    ``forest_kernel.instance`` writes it for a launch's rows per tile."""
    found = chip_smoke.ptxas_instances({"forest_proba": FOREST_PTXAS_LOG})
    assert [fk.instance(r) for r in (32, 128, 1024)] == ["false", "false",
                                                         "true"]
    assert "Used 40 registers" in found[("forest_proba", fk.instance(32))]
    assert "Used 56 registers" in found[("forest_proba", fk.instance(1024))]


def test_ptxas_instances_name_what_the_wrappers_launch(table):
    """The build report is keyed by the template arguments as the
    wrappers' ``instance`` writes them, so each timed launch prints its
    own instance's registers and spills."""
    cut = PTXAS_LOG.index("ptxas info    : Compiling entry function '_ZN48")
    found = chip_smoke.ptxas_instances({"knn_topk": PTXAS_LOG[:cut],
                                        "rbf_decision": PTXAS_LOG[cut:]})
    X = ft.features12(table).numpy()
    gk = kk.compile_knn(knn.KnnModel.from_numpy(
        chip_smoke.random_knn(0, X, n_rows=40), device="cpu"))
    gs = rk.compile_svc(svc.SvcModel.from_numpy(
        chip_smoke.random_svc(0, X, n_sv=40), device="cpu"))
    knn_key = ("knn_topk", kk.instance(gk))
    svc_key = ("rbf_decision", rk.instance(gs, 64, has_xlo=False))
    assert knn_key == ("knn_topk", "1, 12")
    assert svc_key == ("rbf_decision", "64, 12, 15, false")
    assert found[knn_key] == ("0 bytes stack frame, 0 bytes spill stores, 0 "
                              "bytes spill loads; ptxas info    : Used 115 "
                              "registers, used 1 barriers, 32 bytes smem")
    assert "Used 54 registers" in found[svc_key]
    assert kk.instance(dataclasses.replace(gk, n_neighbors=33)) == "4, 12"
    assert rk.instance(dataclasses.replace(gs, n_pairs=3), 4, True) == "4, 0, 0, true"


@pytest.fixture
def small_card_phases(monkeypatch):
    """The script's serve phases on the CPU at a small size: serves get
    ``--device cpu``, and each plain version counts a call in its kernel
    wrapper's ``launches`` as a launch would."""
    serve = chip_smoke._serve
    monkeypatch.setattr(chip_smoke, "_serve",
                        lambda argv: serve(list(argv) + ["--device", "cpu"]))
    until_signal = chip_smoke._serve_until_signal
    monkeypatch.setattr(chip_smoke, "_serve_until_signal",
                        lambda argv: until_signal(list(argv)
                                                  + ["--device", "cpu"]))
    monkeypatch.setattr(chip_smoke, "CAPACITY", 256)
    monkeypatch.setattr(chip_smoke, "DRILL_FLOWS",
                        {f: 128 for f in chip_smoke.DRILL_FLOWS})
    # the card's rule: only an injected fault (or a missed deadline) moves
    # the ladder, so the kernel-fault drill ends its serve here too
    monkeypatch.setattr(tdegrade.DegradeLadder, "_absorbs",
                        lambda self, e, X: isinstance(e, tfaults.FaultInjected))
    monkeypatch.setattr(chip_smoke, "BIG_FLOWS", 512)
    # shard_capture's ticks at this size, paced for the CPU
    monkeypatch.setattr(chip_smoke, "_CAPTURES", {})
    monkeypatch.setattr(chip_smoke, "RYU_BASELINES", {})
    monkeypatch.setattr(chip_smoke, "SHARD_SUB", 16)
    monkeypatch.setattr(chip_smoke, "SHARD_PAUSE", 0.3)
    monkeypatch.setattr(chip_smoke, "SHARD_FIRST_PAUSE", (0.3, 0.3))
    for mod, plain, wrapper in ((fk, "forest_proba_plain", fk.forest_proba),
                                (kk, "topk_sim_idx_plain", kk.topk_sim_idx),
                                (rk, "partial_decision_plain",
                                 rk.partial_decision)):
        def counted(*a, _plain=getattr(mod, plain), _w=wrapper, **kw):
            _w.launches += 1
            return _plain(*a, **kw)
        monkeypatch.setattr(mod, plain, counted)
    X = ft.features12(chip_smoke.synthetic_table(256, 3, "cpu"))
    sample = X.numpy()
    models = {"forest": chip_smoke.random_forest(0, sample, n_trees=8),
              "knn": chip_smoke.random_knn(0, sample, n_rows=200),
              "svc": chip_smoke.random_svc(0, sample, n_sv=60),
              **{f: build(0, sample) for f, (_, _, build)
                 in chip_smoke.FAMILY_SERVES.items()}}
    ops = {"forest": fk.compile_forest(models["forest"], n_features=12,
                                       device="cpu"),
           "knn": kk.compile_knn(interop.knn_params_from_numpy(
               models["knn"], "cpu")),
           "svc": rk.compile_svc(interop.svc_params_from_numpy(
               models["svc"], "cpu"))}
    return models, ops


@pytest.mark.parametrize("family", ["forest", "knn", "svc"])
def test_default_serve_and_drill_phases_run_on_cpu(small_card_phases,
                                                   capsys, family):
    """``phase_default_serve`` (no flag: pipelined, the ladder) and
    ``phase_drills`` (armed dispatch error and stall, an unarmed kernel
    fault, the host rung at size) pass their own checks: labels of every
    printed table against the plain version on the table it was
    dispatched against, one launch per render, the transitions of a
    demotion and a re-promotion, a kernel fault ending the serve."""
    models, ops = small_card_phases
    device = torch.device("cpu")
    assert chip_smoke.phase_default_serve(family, models[family],
                                          ops[family], device) == 3
    assert chip_smoke.phase_drills(family, models[family], ops[family],
                                   device) > 0
    out = capsys.readouterr().out
    assert "stayed HEALTHY" in out and out.count("re-promoted") == 2
    assert "the ladder did not demote" in out and "[demoted " in out


def test_warmup_and_big_serve_phases_run_on_cpu(small_card_phases, capsys):
    models, ops = small_card_phases
    device = torch.device("cpu")
    assert chip_smoke.phase_warmup(models["forest"], ops["forest"],
                                   device) > 0
    assert chip_smoke.phase_big_serve(models["forest"], ops["forest"],
                                      device) > 0
    out = capsys.readouterr().out
    assert "warmup warmed" in out and "equals the plain version" in out


def test_near_ties_tells_rounding_ties_from_real_disagreements():
    """``chip_smoke.near_ties`` explains a differing label only where the
    two arithmetics may order the classes differently: top two forest
    probabilities within ``T · 2⁻²³ · p_max``, k-th and (k+1)-th KNN
    distances within ``1e-6 · (‖x‖² + max ‖s‖²)``."""

    class _Scores:
        def __init__(self, p):
            self.p = np.asarray(p, np.float64)

        def scores(self, X):
            return self.p[: len(X)]

    T = 100
    forest = {"values": np.zeros((T, 3, 2))}
    gap_ok = 0.5 * T * 2.0 ** -23 * 0.4
    probs = [[0.4, 0.4 - gap_ok, 0.2], [0.4, 0.39, 0.21]]
    X = torch.zeros((2, 12))
    got = chip_smoke.near_ties("forest", forest, None, X, _Scores(probs),
                               np.arange(2))
    assert got.tolist() == [True, False]

    fit = np.zeros((4, 12), np.float32)
    fit[:, 0] = [1.0, 2.0, 3.0, 3.0]  # rows 2 and 3 tie for x = 0
    knn_model = {"fit_X": fit, "n_neighbors": 3}
    got = chip_smoke.near_ties("knn", knn_model, None, X, None, np.arange(2))
    assert got.tolist() == [True, True]
    knn_model["n_neighbors"] = 2  # 2nd nearest 4.0 against 3rd 9.0
    got = chip_smoke.near_ties("knn", knn_model, None, X, None, np.arange(1))
    assert got.tolist() == [False]


def test_fanin_phase_runs_on_cpu(small_card_phases, capsys):
    """``phase_fanin`` passes its own checks at 256 flows: source 1's
    namespace (85 flows) evicted, sources 0 and 2 rendering on with the
    plain version's labels, the roster HEALTHY, DEAD, HEALTHY."""
    models, ops = small_card_phases
    assert chip_smoke.phase_fanin(models["forest"], ops["forest"],
                                  torch.device("cpu")) > 0
    out = capsys.readouterr().out
    assert "source 1's namespace (85 flows) evicted" in out


def test_families_phase_runs_on_cpu(small_card_phases, monkeypatch, capsys):
    """``phase_families`` passes its own checks at 256 flows: each family's
    no-flag serve prints the CPU module's labels, launches no kernel, and
    the gaussiannb drill demotes to ``plain-cpu`` and re-promotes."""
    models, _ = small_card_phases
    monkeypatch.setattr(chip_smoke, "cuda_median_ms",
                        lambda fn, runs: (fn(), 0.0)[1])
    times = chip_smoke.phase_families(models, torch.device("cpu"))
    assert sorted(times) == ["gnb", "kmeans", "logreg"]
    out = capsys.readouterr().out
    assert out.count("no kernel launched") == 3
    assert "re-promoted" in out and "(plain-cpu)" in out


def test_random_family_models_have_reference_shapes(table):
    X = ft.features12(table).numpy()
    lr = chip_smoke.random_logreg(0, X)
    assert lr["coef"].shape == (6, 12) and lr["intercept"].shape == (6,)
    g = chip_smoke.random_gnb(0, X)
    assert g["theta"].shape == g["var"].shape == (6, 12)
    assert (g["var"] > 0).all() and np.isclose(g["class_prior"].sum(), 1.0)
    km = chip_smoke.random_kmeans(0, X)
    assert km["cluster_centers"].shape == (chip_smoke.KMEANS_CLUSTERS, 12)
    assert chip_smoke.family_classes("kmeans") == ("dns", "ping", "telnet",
                                                   "voice")


@pytest.mark.parametrize("family", ["logreg", "gnb", "kmeans"])
def test_family_scores_are_the_modules_scores(table, family):
    """``family_scores`` is the float64 image of the port module's scores
    (the float32 module agrees to its rounding), and its scale bounds
    each score."""
    X = ft.features12(table).numpy()
    model = chip_smoke.FAMILY_SERVES[family][2](0, X)
    m = getattr(interop, chip_smoke.FAMILY_SERVES[family][1])(model, "cpu")
    S, scale = chip_smoke.family_scores(family, model, X)
    got = m.scores(torch.from_numpy(X)).numpy().astype(np.float64)
    assert (np.abs(got - S) <= 24 * 2.0 ** -24 * scale).all()
    assert (np.abs(S) <= scale + 1e-9).all()


def test_near_ties_of_the_families():
    """A family row is a near-tie only when its top two float64 scores lie
    within ``2 · 12 · 2⁻²⁴`` of the row's scale."""
    X = torch.zeros((3, 12))
    X[:, 0] = torch.tensor([1.0, 2.0, 3.0])
    eps = 24 * 2.0 ** -24
    # kmeans: centers at 0 and 2 along feature 0 tie exactly for x = 1;
    # a third center just off the tie
    km = {"cluster_centers": np.zeros((3, 12))}
    km["cluster_centers"][:, 0] = [0.0, 2.0, 2.0 + 4.0]
    got = chip_smoke.near_ties("kmeans", km, None, X, None, np.arange(3))
    assert got.tolist() == [True, False, False]
    lr = {"coef": np.zeros((2, 12)), "intercept": np.asarray([0.0, 0.0])}
    lr["coef"][:, 0] = [1.0, 1.0 + 0.5 * eps]
    got = chip_smoke.near_ties("logreg", lr, None, X, None, np.arange(1))
    assert got.tolist() == [True]
    lr["coef"][1, 0] = 1.0 + 4 * eps
    got = chip_smoke.near_ties("logreg", lr, None, X, None, np.arange(1))
    assert got.tolist() == [False]


def test_kill_after_kills_the_source_once_the_tick_is_consumed():
    from traffic_classifier_sdn_tpu_torch.ingest import fanin

    specs = [fanin.SourceSpec(kind="synthetic", sid=i, n_flows=2, seed=i,
                              mac_base=2 * i, lockstep=True) for i in range(2)]
    tier = fanin.FanInIngest(specs, quarantine_s=60.0)
    with chip_smoke.kill_after(1, 1):
        gen = tier.ticks(tick_timeout=5.0)
        try:
            first = next(gen)
            assert {r.source for r in first} == {0, 1}
            later = [next(gen) for _ in range(3)]
        finally:
            gen.close()
    assert all({r.source for r in b} == {0} for b in later[1:])
    assert tier.roster()[1]["ticks"] == 1
    assert fanin.FanInIngest.ticks.__name__ == "ticks"


def test_reference_csvs_are_in_the_reference_layout(tmp_path):
    """Five classes (the reference's datasets/ has no quake file), game
    comma-delimited and the rest tab-delimited, every column the header
    names, and ``io/datasets.py`` loads them."""
    from traffic_classifier_sdn_tpu_torch.core.features import CSV_COLUMNS_16
    from traffic_classifier_sdn_tpu_torch.io.datasets import (
        load_reference_datasets,
    )

    tables = chip_smoke.reference_csvs(str(tmp_path), rows=32)
    for name, (fname, delim) in chip_smoke.REFERENCE_CSVS.items():
        head, first = (tmp_path / fname).read_text().splitlines()[:2]
        assert head.split(delim) == list(CSV_COLUMNS_16) + ["Traffic Type"]
        assert len(first.split(delim)) == 17 and first.endswith(name)
        assert tables[name].shape == (32, 16)
    ds = load_reference_datasets(str(tmp_path))
    assert ds.classes == tuple(sorted(chip_smoke.REFERENCE_CSVS))
    assert ds.X.shape == (160, 12) and np.isfinite(ds.X).all()


def test_serving_env_sets_and_restores(monkeypatch):
    monkeypatch.setenv("TCSDN_KNN_TOPK", "argmax")
    monkeypatch.delenv("TCSDN_SVC_KERNEL", raising=False)
    with chip_smoke.serving_env(TCSDN_SVC_KERNEL="dot"):
        import os

        assert "TCSDN_KNN_TOPK" not in os.environ
        assert os.environ["TCSDN_SVC_KERNEL"] == "dot"
        os.environ["TCSDN_KNN_TOPK"] = "hier"  # as a CLI's --knn-topk does
    assert os.environ["TCSDN_KNN_TOPK"] == "argmax"
    assert "TCSDN_SVC_KERNEL" not in os.environ


def test_dot_rule_rows_widen_with_the_feature_scale(table):
    """``dot_rule_rows`` flags the rows where the float32 dot expansion's
    error bound reaches a decision's sign: few at the served scale, more
    when the same rows sit far from the origin (‖x‖² ≫ d², where the
    expansion cancels), and every row whose float32 dot-form label
    differs from the exact (float64 difference-form) label."""
    from traffic_classifier_sdn_tpu_torch.models import svc

    X = ft.features12(table)
    X = X[X.abs().sum(1) > 0][:300]
    sp = interop.svc_params_from_numpy(
        chip_smoke.random_svc(0, X.numpy(), n_sv=80), "cpu")
    base = chip_smoke.dot_rule_rows(sp, X)
    assert base.shape == (X.shape[0],) and base.sum() < X.shape[0] // 10
    big = X + 1e6
    sp_big = interop.svc_params_from_numpy(
        chip_smoke.random_svc(0, big.numpy(), n_sv=80), "cpu")
    flagged = chip_smoke.dot_rule_rows(sp_big, big)
    assert flagged.sum() > base.sum()
    exact = copy.deepcopy(sp_big).double().predict(big.double()).numpy()
    differ = sp_big.predict_dot(big).numpy() != exact
    assert flagged[differ].all()
    # the bound holds the kernel values themselves: |K_dot − K| ≤ K⁺ − K⁻
    x, sv = big.double(), sp_big.sv_hi.double() + sp_big.sv_lo.double()
    gamma = float(sp_big.gamma)
    d2 = ((x[:, None, :] - sv[None]) ** 2).sum(-1)
    E = 44 * 2.0 ** -24 * ((x * x).sum(1)[:, None]
                           + (sp_big.sv_hi.double() ** 2).sum(1)[None])
    k_hi = torch.exp(-gamma * torch.clamp(d2 - E, min=0) * (1 - 2.0 ** -24))
    err = (sp_big.rbf_kernel_dot(big).double() - torch.exp(-gamma * d2)).abs()
    assert bool((err <= k_hi - torch.exp(-gamma * (d2 + E))).all())
    assert isinstance(sp_big, svc.SvcModel)


@pytest.fixture
def cpu_timers(monkeypatch):
    monkeypatch.setattr(chip_smoke, "cuda_median_ms",
                        lambda fn, runs, warmup=3: (fn(), 0.0)[1])
    monkeypatch.setattr(chip_smoke, "HOST_RUNS", 1)


def test_knn_tiers_ivf_and_svc_dot_phases_run_on_cpu(small_card_phases,
                                                     cpu_timers, capsys):
    """``phase_knn_tiers``, ``phase_ivf`` and ``phase_svc_dot`` pass their
    own checks at 256 served rows against a 200-row corpus (K = 14) and
    60 support vectors."""
    models, ops = small_card_phases
    cpu = torch.device("cpu")
    tiers = chip_smoke.phase_knn_tiers(models["knn"], ops["knn"], cpu)
    assert set(tiers) == {"kernel", *chip_smoke.KNN_TIERS, "native",
                          "matmul_topk"}
    ivf = chip_smoke.phase_ivf(models["knn"], ops["knn"], cpu)
    assert ivf["K"] == 14 and ivf["recall"][4] >= ivf["recall"][1]
    dot = chip_smoke.phase_svc_dot(models["svc"], ops["svc"], cpu)
    assert dot["card_vs_cpu"] == 0  # one device: the same arithmetic
    out = capsys.readouterr().out
    assert "every exact tier's neighbor indices equal the kernel's" in out
    assert "labels and ivf_top1 equal the exact tier's bitwise" in out


def test_menu_serve_phases_run_on_cpu(small_card_phases, capsys):
    models, ops = small_card_phases
    found = chip_smoke.phase_menu_serves(models, ops, torch.device("cpu"))
    assert sorted(found) == ["menus Randomforest native", "menus knearest hier",
                             "menus knearest ivf", "menus svm dot"]
    assert not any(n for f in found.values() for n in f.values())
    out = capsys.readouterr().out
    assert "labels equal the C++ walk's" in out


def test_controller_and_workload_phases_run_on_cpu(small_card_phases,
                                                   monkeypatch, capsys):
    """The controller phase spawns the port's controller through the
    serve and ends it; the workload phase serves seeded reference-layout
    CSVs (100 flows here)."""
    models, ops = small_card_phases
    monkeypatch.setattr(chip_smoke, "CONTROLLER_PAIRS", 4)
    monkeypatch.setattr(chip_smoke, "CONTROLLER_TICKS", 3)
    monkeypatch.setattr(chip_smoke, "WORKLOAD_FLOWS", 100)
    cpu = torch.device("cpu")
    assert chip_smoke.phase_controller(models["forest"], ops["forest"],
                                       cpu) > 0
    assert chip_smoke.phase_workload(models["forest"], ops["forest"],
                                     cpu) > 0
    out = capsys.readouterr().out
    assert "4 conversations tracked from the port's controller" in out
    assert "labels per class" in out and "100 conversations" in out


def test_obs_phase_runs_on_cpu(small_card_phases, monkeypatch, capsys):
    """``phase_obs`` at 256 flows: the scrapes during the serve, /healthz
    and /events, the budget guard's saves and skips, the SIGTERM dump,
    stdout with the obs surfaces on against off, tick p50 with latency
    provenance on and off, and the drill whose rung /healthz shows."""
    models, ops = small_card_phases
    snapshot = cli._snapshot_if_due

    def slow_snapshot(*a, **kw):
        # a snapshot as long as a save on the card: the last tick ends well
        # after its render, and the watcher must wait for it
        time.sleep(0.3)
        return snapshot(*a, **kw)

    monkeypatch.setattr(cli, "_snapshot_if_due", slow_snapshot)
    assert chip_smoke.phase_obs(models["forest"], ops["forest"],
                                torch.device("cpu")) > 0
    out = capsys.readouterr().out
    assert "then SIGTERM (exit 143)" in out
    assert "under the default budget" in out
    assert "stdout equal with the obs plane on and off" in out
    assert "/healthz 200 with rung DEGRADED" in out


def test_checkpoint_phase_runs_on_cpu(small_card_phases, monkeypatch,
                                      capsys):
    """``phase_checkpoint`` at 256 flows (and 512 for the large save):
    continuation byte for byte, rollback past a truncated newest member,
    the round trip (CPU to CPU here) and the large save and restore."""
    models, ops = small_card_phases
    monkeypatch.setattr(chip_smoke, "CKPT_BIG_FLOWS", 512)
    assert chip_smoke.phase_checkpoint(models["forest"], ops["forest"],
                                       torch.device("cpu")) > 0
    out = capsys.readouterr().out
    assert "print the uninterrupted serve's stdout byte for byte" in out
    assert "the restore rolled back to ckpt-000000002.npz" in out
    assert "512 flows: save" in out


def test_frames_and_the_subsequence_rule():
    table = ("+-----+\n| Flow ID |\n+-----+\n| 1 |\n+-----+\n"
             "... showing 1 of 2 tracked flows\n")
    other = table.replace("| 1 |", "| 2 |")
    assert chip_smoke.frames(table + other) == [table, other]
    assert chip_smoke.subsequence(other, table + other)
    assert not chip_smoke.subsequence(table, table + other)
    assert not chip_smoke.subsequence("", table)



def test_drift_stream_shifts_and_adds_novel_conversations():
    """``drift_ticks``: every conversation reports every tick; the packet
    deltas jump by ``DRIFT_FACTOR`` at the shift; the novel conversations
    (MACs above the population) report from their tick on, at the same
    poll time."""
    ticks = list(chip_smoke.drift_ticks(8, 5, shift_at=3, novel_at=4,
                                        novel_flows=2))
    lines = [t.splitlines() for t in ticks]
    assert [len(x) for x in lines] == [16, 16, 16, 16, 20]
    assert {ln.split(b"\t")[1] for ln in lines[4]} == {b"5"}

    def fwd_pkts(k):
        return [int(ln.split(b"\t")[7]) for ln in lines[k][:16:2]]

    d1 = np.subtract(fwd_pkts(2), fwd_pkts(1))
    d3 = np.subtract(fwd_pkts(3), fwd_pkts(2))
    assert d3.sum() > 3 * d1.sum()
    novel_src = {ln.split(b"\t")[4] for ln in lines[4][16::2]}
    assert novel_src == {b"00:00:00:00:00:10", b"00:00:00:00:00:12"}


def test_drift_phase_runs_on_cpu(small_card_phases, cpu_timers, monkeypatch,
                                 capsys, request):
    """``phase_drift`` at 256 flows (240 drifting, 16 novel; ticks 0.1 s
    apart; 10-tree refits): PROMOTED with the refit, every table against its model's plain
    labels with the open-set relabel, the promoted kernel against its
    plain version, the gate's torch labels against the float64 rule, the
    novel window, /healthz, and the ``promote.swap`` drill's rollback."""
    from traffic_classifier_sdn_tpu_torch.serving import retrain

    models, ops = small_card_phases
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the refits' small ops, beside other workers
    request.addfinalizer(lambda: torch.set_num_threads(threads))
    fit = retrain.fit_family
    # 10 trees, not the default 100: the refits run on the CPU here
    monkeypatch.setattr(retrain, "fit_family",
                        lambda *a, **kw: fit(*a, n_trees=10, **kw))
    monkeypatch.setattr(chip_smoke, "DRIFT_NOVEL", 16)
    monkeypatch.setattr(chip_smoke, "DRIFT_BASE", 240)
    monkeypatch.setattr(chip_smoke, "DRIFT_PAUSE", 0.1)
    monkeypatch.setattr(chip_smoke, "DRIFT_MAX_TICKS", 400)
    launches, promoted = chip_smoke.phase_drift(
        models["forest"], ops["forest"], torch.device("cpu"))
    assert launches > 0 and promoted["max_abs_err"] == 0.0
    assert promoted["trees"] == 10 and promoted["fit_s"] > 0
    out = capsys.readouterr().out
    assert "drift.probe events" in out and "ok=True" in out
    assert "promoted forest kernel bitwise equal to its plain version" in out
    assert "/healthz drift:" in out and "/healthz openset:" in out
    assert "ROLLED_BACK after" in out


def test_steady_capture_holds_rates(tmp_path):
    """``steady_capture``: every conversation reports every tick, its
    counters growing by the same deltas each tick."""
    path = tmp_path / "steady"
    chip_smoke.steady_capture(str(path), 8, 4)
    lines = [ln.split(b"\t") for ln in path.read_bytes().splitlines()]
    assert len(lines) == 8 * 2 * 4
    by_tick = {}
    for ln in lines:
        by_tick.setdefault(int(ln[1]), []).append((int(ln[7]), int(ln[8])))
    assert sorted(by_tick) == [1, 2, 3, 4]
    first = np.asarray(by_tick[1])
    for t in (2, 3, 4):
        np.testing.assert_array_equal(np.asarray(by_tick[t]), t * first)
    assert (first > 0).all()


def test_parse_rows_reads_the_pairs(tmp_path, capsys, forest):
    ckpt = str(tmp_path / "ckpt")
    checkpoint.save_model(ckpt, "forest",
                          interop.forest_params_from_numpy(forest, "cpu"),
                          classes=chip_smoke.CLASSES)
    cli.main(["Randomforest", "--native-checkpoint", ckpt, "--source",
              "synthetic", "--synthetic-flows", "8", "--capacity", "16",
              "--max-ticks", "2", "--print-every", "2", "--device", "cpu",
              "--pipeline", "off"])
    out = capsys.readouterr().out
    rows = chip_smoke.parse_rows(out)
    assert [[(s, lab) for s, _, _, lab in t] for t in rows] == \
        chip_smoke.parse_tables(out)
    assert all(src.count(":") == 5 and dst.count(":") == 5
               for t in rows for _, src, dst, _ in t)


def test_flow_table_bytes_counts_every_field():
    # 2 int32/bool table fields (5 bytes) and 2 directions of 11 four-byte
    # fields and one bool (45 bytes each), for capacity + 1 rows
    assert chip_smoke.flow_table_bytes(65536) == 95 * 65537
    assert chip_smoke.nearest_rank_p50([3.0, 1.0, 2.0, 4.0]) == 3.0


def test_actuation_phase_runs_on_cpu(small_card_phases, capsys):
    """``phase_actuation`` at 256 flows: tables against the plain forest,
    one launch a render, the switch against the ledger and the rendered
    labels (bytes included), stdout against ``--actuation off``, the
    /healthz block, and the refusal and withheld-barrier drills."""
    models, ops = small_card_phases
    assert chip_smoke.phase_actuation(models["forest"], ops["forest"],
                                      torch.device("cpu")) > 0
    out = capsys.readouterr().out
    assert "FLOW_MOD bytes equal compile_install's" in out
    assert "/healthz actuation:" in out
    assert "[actuation drill refuse]" in out
    assert "[actuation drill stall]" in out


def test_scenarios_phase_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "SCENARIO_PROFILE", "t1")
    chip_smoke.phase_scenarios(torch.device("cpu"))
    out = capsys.readouterr().out
    assert out.count("[scenarios ") == 8 and "FAILED" not in out


def test_fleet_phase_runs_on_cpu(small_card_phases, monkeypatch, capsys):
    models, _ = small_card_phases
    monkeypatch.setattr(chip_smoke, "FLEET_FLOWS", 64)
    chip_smoke.phase_fleet(models["forest"], torch.device("cpu"))
    out = capsys.readouterr().out
    assert "both exit 0" in out
    assert "member 1 sid 1" in out


def test_shard_capture_and_its_emitter(tmp_path, monkeypatch):
    """``shard_capture``: one tick of every conversation, then small ticks
    of ``SHARD_SUB``; the replay emitter writes them in order."""
    monkeypatch.setattr(chip_smoke, "_CAPTURES", {})
    monkeypatch.setattr(chip_smoke, "SHARD_SUB", 8)
    paths = chip_smoke.shard_capture(64)
    assert len(paths) == chip_smoke.SHARD_TICKS
    lines = [open(p, "rb").read().count(b"\n") for p in paths]
    assert lines == [128] + [16] * (chip_smoke.SHARD_TICKS - 1)
    assert sum(lines) == chip_smoke.shard_lines(64)
    argv = chip_smoke.ryu_capture_argv(64, "ckpt", str(tmp_path))
    cmd = argv[argv.index("--monitor-cmd") + 1].split()
    cmd[2:4] = ["0", "0"]  # no pauses
    out = subprocess.run(cmd, capture_output=True, check=True,
                         timeout=60).stdout
    assert out.startswith(b"loading app")
    assert out.count(b"\n") == 1 + sum(lines)


def test_shards_phase_runs_on_cpu(small_card_phases, cpu_timers,
                                  monkeypatch, capsys):
    """``phase_shards`` passes its own checks on the CPU at 256 and 512
    flows: the --shards 1 and 4-shard serves against the un-sharded one,
    the fused KNN and SVC predicts over 4 shards (shards of padding
    alone), the kernel-fault drill and the --shards 2 refusal."""
    monkeypatch.setattr(chip_smoke, "SHARD_GATHER_RUNS", 1)
    # ticks far enough apart that each small one is one poll of the serve,
    # however loaded the CPU (the byte-identity rests on it)
    monkeypatch.setattr(chip_smoke, "SHARD_PAUSE", 0.8)
    monkeypatch.setattr(chip_smoke, "SHARD_FIRST_PAUSE", (1.5, 1.5))
    models, ops = small_card_phases
    paths, numbers = chip_smoke.phase_shards(models, ops,
                                             torch.device("cpu"))
    assert paths["shards knn_sharded.fused_predict"]["knn"] == 12
    assert paths["shards svc_sharded.fused_predict"]["svc"] == 4
    for n in (256, 512):
        one = paths[f"shards 1 Randomforest {n}"]["forest"]
        four = paths[f"shards 4 Randomforest {n}"]["forest"]
        assert four == 4 * numbers["forest"][str(n)]["shards 4"]["renders"]
        assert one == numbers["forest"][str(n)]["shards 1"]["renders"] > 0
    assert [x["real_rows"] for x in numbers["knn"]["per_shard"]] == [
        200, 0, 0, 0]
    assert [x["real_svs"] for x in numbers["svc"]["per_shard"]] == [
        60, 0, 0, 0]
    out = capsys.readouterr().out
    assert out.count("byte-identical to the un-sharded serve's") == 4
    assert "refused with the JAX CLI's message" in out
