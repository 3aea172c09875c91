"""CPU rehearsal of ``chip_smoke.py``'s helpers (the script itself needs a
CUDA card): the seeded forest, KNN and SVC have the reference checkpoints'
shapes, the bulk synthetic table equals the one the Python ingest path
builds, the table parser reads what the CLI prints, the node-visit count
matches a walk, the bounds follow their operation counts, the plain-label
helpers agree with the serving predicts, the churn capture and its
emitter carry the schedule, and the script refuses to run without a
card."""

import dataclasses
import subprocess
import sys

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
        "--device", "cpu",
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
