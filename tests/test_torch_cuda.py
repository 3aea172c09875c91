"""Card-only checks of the port (``requires_cuda``): the CUDA forest, KNN
top-k and RBF-SVC kernels against their plain versions, and the CUDA flow
table and serves against the same code on the CPU. The CPU side is held to the JAX
reference by the other ``test_torch_*`` files, so these carry that parity
onto the card.

This file imports nothing of JAX, so it runs on a machine with a card and
no JAX: ``python -m pytest --noconftest -m requires_cuda
tests/test_torch_cuda.py`` (``--noconftest`` skips ``tests/conftest.py``,
which configures JAX). Without a card every test skips.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import chip_smoke
from __graft_entry__ import _synth_forest
from traffic_classifier_sdn_tpu_torch import cli, interop
from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows
from traffic_classifier_sdn_tpu_torch.io import checkpoint
from traffic_classifier_sdn_tpu_torch.models import knn, svc
from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk
from traffic_classifier_sdn_tpu_torch.ops import knn_kernel as kk
from traffic_classifier_sdn_tpu_torch.ops import rbf_kernel as rk

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    return torch.device("cuda")


@functools.cache
def _forests():
    """Stumps, a root-leaf tree, a reference-shaped random forest, a deep
    one (up to 150 internal nodes per tree, depth up to 20), and one
    larger than a shared-memory stage (60 such trees)."""
    rng = np.random.RandomState(0)
    sample = (rng.gamma(1.0, 100.0, (2000, 12))).astype(np.float32)
    root_leaf = _synth_forest(n_trees=3)
    root_leaf["left"][1] = -1
    root_leaf["right"][1] = -1
    return {
        "stumps": _synth_forest(),
        "root_leaf": root_leaf,
        "random": chip_smoke.random_forest(1, sample, n_trees=40),
        "deep": chip_smoke.random_forest(
            2, sample, n_trees=10, node_count=(129, 301), max_depth=20
        ),
        "multistage": chip_smoke.random_forest(
            4, sample, n_trees=60, node_count=(201, 301), max_depth=20
        ),
    }


FOREST_ROWS = (1, 33, 777, 4097, 65536)


@pytest.mark.parametrize("n_rows", FOREST_ROWS)
@pytest.mark.parametrize("name", ["stumps", "root_leaf", "random", "deep",
                                  "multistage"])
def test_kernel_bitwise_equals_plain(cuda, name, n_rows):
    """The wrapper's launch and every forced shape (32, 128 and 1024 rows
    per tile; the most trees per stage, a third of that, and one), on rows
    with inputs exactly on thresholds and on a copy with NaN/+inf/-inf
    features: bitwise equal to the plain version on the card, and to the
    CPU's plain version up to 4,097 rows."""
    d = _forests()[name]
    k = fk.compile_forest(d, n_features=12, device=cuda)
    if name == "multistage":
        assert all(fk.trees_per_chunk(k, r) < k.n_trees for r in fk.ROWS_PER_TILE)
    rng = np.random.RandomState(3)
    X = (rng.gamma(1.0, 100.0, (n_rows, 12))).astype(np.float32)
    # some inputs exactly on split thresholds (the <= edge)
    internal = np.argwhere(d["left"] != -1)
    for i, (t, n) in enumerate(internal[:min(300, n_rows)]):
        X[i, d["feature"][t, n]] = np.float32(d["threshold"][t, n])
    Xc = torch.from_numpy(X).to(cuda)
    cpu = fk.compile_forest(d, n_features=12, device="cpu")
    for x in (Xc, chip_smoke.with_nonfinite(Xc, every=3)):
        want = fk.forest_proba_plain(k, x)
        launches = fk.forest_proba.launches
        got = fk.forest_proba(k, x)
        torch.cuda.synchronize()
        assert fk.forest_proba.launches == launches + 1
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        for R in fk.ROWS_PER_TILE:
            most = fk.trees_per_chunk(k, R)
            for per_chunk in sorted({most, max(1, most // 3), 1}):
                got = fk._launch(k, x, R, per_chunk)
                torch.cuda.synchronize()
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)), (R, per_chunk)
        if n_rows <= 4097:
            np.testing.assert_array_equal(
                want.cpu().numpy().view(np.uint32),
                fk.forest_proba(cpu, x.cpu()).numpy().view(np.uint32),
            )


def test_wrapper_on_card(cuda):
    k = fk.compile_forest(_synth_forest(), n_features=12, device=cuda)
    launches = fk.forest_proba.launches
    assert fk.forest_proba(k, torch.zeros((0, 12), device=cuda)).shape == (0, 6)
    assert fk.forest_proba.launches == launches  # no rows, no launch
    with pytest.raises(ValueError, match="operands"):
        fk.forest_proba(k, torch.zeros((4, 12)))
    with pytest.raises(ValueError, match="contiguous"):
        fk.forest_proba(k, torch.zeros((12, 4), device=cuda).t())


def test_flow_table_cuda_bitwise_equals_cpu(cuda):
    """The same synthetic wires through the table on both devices."""
    wires = []
    syn = SyntheticFlows(n_flows=3000, seed=4)
    for k in range(4):
        wires.append(chip_smoke.tick_wire(syn, k == 0))
    tables = {d: ft.make_table(4096, d) for d in ("cpu", cuda)}
    for w in wires:
        for d in tables:
            tables[d] = ft.apply_wire(tables[d], ft.wire_tensor(w, d))
    clear = torch.tensor([5, 17, 4096, 4096])
    for d in tables:
        tables[d] = ft.clear_slots(tables[d], clear.to(d))
    a, b = tables["cpu"], tables[cuda]
    for d in ("fwd", "rev"):
        for f in dataclasses.fields(ft.DirState):
            x = getattr(getattr(a, d), f.name)
            y = getattr(getattr(b, d), f.name).cpu()
            assert torch.equal(x, y), f"{d}.{f.name}"
    assert torch.equal(ft.features12(a), ft.features12(b).cpu())
    ra = ft.top_active_render(a, torch.zeros(4096, dtype=torch.int32), 64, 2)
    rb = ft.top_active_render(
        b, torch.zeros(4096, dtype=torch.int32, device=cuda), 64, 2
    )
    for x, y in zip(ra, rb):
        assert torch.equal(x, y.cpu())


def test_serve_on_card_prints_what_the_cpu_serve_prints(cuda, tmp_path, capsys):
    """The port CLI on CUDA (kernel path) and on the CPU (plain path) print
    the same tables; the kernel launches once per render tick."""
    table = chip_smoke.synthetic_table(300, 2, "cpu")
    d = chip_smoke.random_forest(0, ft.features12(table).numpy(), n_trees=16)
    checkpoint.save_model(
        str(tmp_path), "forest", interop.forest_params_from_numpy(d, "cpu"),
        classes=chip_smoke.CLASSES,
    )
    argv = ["Randomforest", "--native-checkpoint", str(tmp_path),
            "--source", "synthetic", "--synthetic-flows", "300",
            "--capacity", "512", "--max-ticks", "4", "--print-every", "2",
            "--pipeline", "off", "--degrade", "off"]
    launches = fk.forest_proba.launches
    summary = cli.main(argv)  # CUDA by default
    on_card = capsys.readouterr().out
    assert fk.forest_proba.launches == launches + len(summary.render_ticks) == launches + 2
    cli.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out == on_card


def _served(n_flows=3000, ticks=3):
    """Served features (nonzero rows) of a synthetic table."""
    X = ft.features12(chip_smoke.synthetic_table(n_flows, ticks, "cpu")).numpy()
    return X[np.abs(X).sum(1) > 0]


def _knn_cases():
    """The integer tie corpus (every similarity exact, massively tied) and
    a corpus drawn near served features, at k = 1, 5 (the reference) and
    20 (the kernel's large-k instance), with ragged query counts."""
    rng = np.random.RandomState(0)
    X = _served()
    cases = {}
    for k in (1, 5, 20):
        cases[f"ties-k{k}"] = (
            {"fit_X": rng.randint(0, 4, (333, 12)).astype(np.float64),
             "y": rng.randint(0, 6, 333), "n_neighbors": k,
             "classes": np.arange(6)},
            rng.randint(0, 4, (777, 12)).astype(np.float32),
        )
        cases[f"served-k{k}"] = (
            chip_smoke.random_knn(k, X, n_rows=1000, n_neighbors=k), X[:999],
        )
    cases["ties-S==k"] = (
        {"fit_X": rng.randint(0, 4, (5, 12)).astype(np.float64),
         "y": rng.randint(0, 6, 5), "n_neighbors": 5, "classes": np.arange(6)},
        rng.randint(0, 4, (130, 12)).astype(np.float32),
    )
    # NaN/±inf features in every third row, at k = 5 and k = 40 (the
    # four-slot lists), and signed zeros: x = −1 against rows 0 and 2x
    for k in (5, 40):
        cases[f"nonfinite-k{k}"] = (
            chip_smoke.random_knn(k, X, n_rows=300, n_neighbors=k),
            chip_smoke.with_nonfinite(torch.from_numpy(X[:777].copy()),
                                      every=3).numpy(),
        )
    x = -np.ones(12)
    cases["signed-zeros"] = (
        {"fit_X": np.stack([np.zeros(12), 2 * x, 5 * np.ones(12)] * 60),
         "y": np.arange(180) % 6, "n_neighbors": 7, "classes": np.arange(6)},
        np.stack([x, np.zeros(12), -x]).astype(np.float32),
    )
    return cases


@pytest.mark.parametrize("name", ["ties-k1", "ties-k5", "ties-k20",
                                  "served-k1", "served-k5", "served-k20",
                                  "ties-S==k", "nonfinite-k5",
                                  "nonfinite-k40", "signed-zeros"])
def test_knn_kernel_bitwise_equals_plain(cuda, name):
    """Indices and similarities bitwise equal to the plain version on the
    card and on the CPU, under the total order (NaN rows and signed zeros
    included), at the wrapper's launch and at every rows-per-warp shape;
    every index a corpus row."""
    d, X = _knn_cases()[name]
    g = kk.compile_knn(knn.KnnModel.from_numpy(d, device=cuda))
    Xc = torch.from_numpy(X).to(cuda)
    launches = kk.topk_sim_idx.launches
    vals, idx = kk.topk_sim_idx(g, Xc)
    torch.cuda.synchronize()
    assert kk.topk_sim_idx.launches == launches + 1
    want_v, want_i = kk.topk_sim_idx_plain(g, Xc)
    assert torch.equal(idx, want_i)
    assert torch.equal(vals.view(torch.int32), want_v.view(torch.int32))
    assert bool(((idx >= 0) & (idx < g.n_rows)).all())
    for rw in kk.rows_per_warp_choices(g.n_neighbors):
        v, i = kk._launch(g, Xc, rw)
        assert torch.equal(i, want_i), rw
        assert torch.equal(v.view(torch.int32), want_v.view(torch.int32)), rw
    # against the CPU on finite rows: a NaN the arithmetic makes (inf·0)
    # has the CPU's sign and payload there and the card's here, and the
    # total order ranks NaNs by their bits
    finite = np.isfinite(X).all(1)
    cpu = kk.compile_knn(knn.KnnModel.from_numpy(d, device="cpu"))
    cv, ci = kk.topk_sim_idx(cpu, torch.from_numpy(X[finite]))
    np.testing.assert_array_equal(idx.cpu().numpy()[finite], ci.numpy())
    np.testing.assert_array_equal(vals.cpu().numpy()[finite].view(np.uint32),
                                  cv.numpy().view(np.uint32))


@pytest.mark.parametrize("lo", [False, True, "nonfinite"],
                         ids=["no-X_lo", "X_lo", "nonfinite"])
def test_svc_kernel_bitwise_equals_plain(cuda, lo):
    """Decisions on the card against the plain version on the card
    (the same ``expf``), bitwise, at the wrapper's launch and every
    rows-per-block shape; against the plain version on the CPU (another
    ``exp``) within 1e-5 of the largest possible sum, labels equal off
    that rounding. ``nonfinite``: NaN/±inf in every third row."""
    X = _served()[:1111]
    d = chip_smoke.random_svc(0, X, n_sv=700)
    if lo == "nonfinite":
        X = chip_smoke.with_nonfinite(torch.from_numpy(X.copy()),
                                      every=3).numpy()
        lo = False
    Xh, Xl = X, None
    if lo:
        X64 = X.astype(np.float64) * (1 + 1e-4 * np.random.RandomState(1).rand(*X.shape))
        Xh, Xl = svc.split_hilo(X64)
    g = rk.compile_svc(svc.SvcModel.from_numpy(d, device=cuda))
    Xc = torch.from_numpy(Xh).to(cuda)
    Xlc = None if Xl is None else torch.from_numpy(Xl).to(cuda)
    launches = rk.partial_decision.launches
    got = rk.partial_decision(g, Xc, Xlc)
    torch.cuda.synchronize()
    assert rk.partial_decision.launches == launches + 1
    want = rk.partial_decision_plain(g, Xc, Xlc)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    for R in rk.ROWS_PER_BLOCK:
        shaped = rk._launch(g, Xc, Xlc, R)
        assert torch.equal(shaped.view(torch.int32), want.view(torch.int32)), R
    plain_labels = torch.argmax(svc.votes_from_decision(
        want + g.intercept, g.vote_i, g.vote_j, g.n_classes), dim=-1)
    assert torch.equal(rk.predict(g, Xc, Xlc).long(), plain_labels)
    cpu = rk.compile_svc(svc.SvcModel.from_numpy(d, device="cpu"))
    Xl_cpu = None if Xl is None else torch.from_numpy(Xl)
    D_cpu = rk.decision_ovo(cpu, torch.from_numpy(Xh), Xl_cpu).numpy()
    atol = 1e-5 * float(cpu.coef_t.abs().sum(0).max())
    D = rk.decision_ovo(g, Xc, Xlc).cpu().numpy()
    np.testing.assert_allclose(D, D_cpu, atol=atol, rtol=0)
    clear = np.abs(D_cpu).min(1) > atol
    np.testing.assert_array_equal(
        rk.predict(g, Xc, Xlc).cpu().numpy()[clear],
        rk.predict(cpu, torch.from_numpy(Xh), Xl_cpu).numpy()[clear],
    )


def test_knn_svc_wrappers_on_card(cuda):
    X = _served()[:50]
    gk = kk.compile_knn(knn.KnnModel.from_numpy(
        chip_smoke.random_knn(0, X, n_rows=40), device=cuda))
    gs = rk.compile_svc(svc.SvcModel.from_numpy(
        chip_smoke.random_svc(0, X, n_sv=40), device=cuda))
    lk, ls = kk.topk_sim_idx.launches, rk.partial_decision.launches
    assert kk.topk_sim_idx(gk, torch.zeros((0, 12), device=cuda))[1].shape == (0, 5)
    assert rk.partial_decision(gs, torch.zeros((0, 12), device=cuda)).shape == (0, 15)
    assert (kk.topk_sim_idx.launches, rk.partial_decision.launches) == (lk, ls)
    for fn, g in ((kk.topk_sim_idx, gk), (rk.partial_decision, gs)):
        with pytest.raises(ValueError, match="operands"):
            fn(g, torch.zeros((4, 12)))
        with pytest.raises(ValueError, match="contiguous"):
            fn(g, torch.zeros((12, 4), device=cuda).t())


@pytest.mark.parametrize("family", ["knn", "svc"])
def test_knn_svc_serve_on_card_prints_what_the_cpu_serve_prints(
        cuda, tmp_path, capsys, family):
    """The port CLI on CUDA (kernel path) and on the CPU (plain path) print
    the same tables for ``knearest`` and ``svm``; the kernel launches once
    per render tick."""
    X = ft.features12(chip_smoke.synthetic_table(300, 2, "cpu")).numpy()
    X = X[np.abs(X).sum(1) > 0]
    if family == "knn":
        model = interop.knn_params_from_numpy(
            chip_smoke.random_knn(0, X, n_rows=400), "cpu")
        sub, counter = "knearest", kk.topk_sim_idx
    else:
        model = interop.svc_params_from_numpy(
            chip_smoke.random_svc(0, X, n_sv=200), "cpu")
        sub, counter = "svm", rk.partial_decision
    checkpoint.save_model(str(tmp_path), family, model,
                          classes=chip_smoke.CLASSES)
    argv = [sub, "--native-checkpoint", str(tmp_path),
            "--source", "synthetic", "--synthetic-flows", "300",
            "--capacity", "512", "--max-ticks", "4", "--print-every", "2",
            "--pipeline", "off", "--degrade", "off"]
    launches = counter.launches
    summary = cli.main(argv)  # CUDA by default
    on_card = capsys.readouterr().out
    assert counter.launches == launches + len(summary.render_ticks) == launches + 2
    cli.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out == on_card


CARD_ROWS = (1, 33, 777, 4097)


@pytest.mark.parametrize("k", [1, 5, 20, 128])
def test_knn_kernel_every_launch_shape_bitwise_on_ties(cuda, k):
    """Every rows-per-warp choice for this k (16 down to 1 for k <= 32, 2
    and 1 above), and the wrapper's own choice, at ragged N on the integer
    tie corpus: indices and values bitwise equal to the plain version,
    one counted launch per call."""
    rng = np.random.RandomState(k)
    d = {"fit_X": rng.randint(0, 4, (600, 12)).astype(np.float64),
         "y": rng.randint(0, 6, 600), "n_neighbors": k,
         "classes": np.arange(6)}
    g = kk.compile_knn(knn.KnnModel.from_numpy(d, device=cuda))
    Xall = torch.from_numpy(
        rng.randint(0, 4, (max(CARD_ROWS), 12)).astype(np.float32)).to(cuda)
    for N in CARD_ROWS:
        X = Xall[:N].contiguous()
        want_v, want_i = kk.topk_sim_idx_plain(g, X)
        for rw in (*kk.rows_per_warp_choices(k), None):
            launches = kk.topk_sim_idx.launches
            vals, idx = (kk.topk_sim_idx(g, X) if rw is None
                         else kk._launch(g, X, rw))
            torch.cuda.synchronize()
            assert kk.topk_sim_idx.launches == launches + 1
            assert torch.equal(idx, want_i), (N, rw)
            assert torch.equal(vals.view(torch.int32),
                               want_v.view(torch.int32)), (N, rw)


@pytest.mark.parametrize("n_sv", [15, 129, 2281])
@pytest.mark.parametrize("lo", [False, True], ids=["no-X_lo", "X_lo"])
def test_svc_kernel_every_launch_shape_bitwise(cuda, n_sv, lo):
    """Every rows-per-block instance at ragged N and SV counts below,
    across and far above a 32-SV stage, with and without ``X_lo``:
    decisions bitwise equal to the plain version on the card."""
    X = _served(n_flows=6000)[: max(CARD_ROWS)]
    assert X.shape[0] == max(CARD_ROWS)
    d = chip_smoke.random_svc(n_sv, X, n_sv=n_sv)
    Xh, Xl = X, None
    if lo:
        X64 = X.astype(np.float64) * (
            1 + 1e-4 * np.random.RandomState(2).rand(*X.shape))
        Xh, Xl = svc.split_hilo(X64)
    g = rk.compile_svc(svc.SvcModel.from_numpy(d, device=cuda))
    for N in CARD_ROWS:
        Xc = torch.from_numpy(np.ascontiguousarray(Xh[:N])).to(cuda)
        Xlc = None if Xl is None else torch.from_numpy(
            np.ascontiguousarray(Xl[:N])).to(cuda)
        want = rk.partial_decision_plain(g, Xc, Xlc)
        for r in rk.ROWS_PER_BLOCK:
            got = rk._launch(g, Xc, Xlc, r)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), (N, r)


def test_kernels_generic_instances_bitwise(cuda):
    """The instances for other widths than the reference's (KNN with 7
    features; SVC with 7 features and 3 classes): bitwise equal to their
    plain versions at every launch shape."""
    X = _served()[:777, :7].copy()
    dk = chip_smoke.random_knn(3, X, n_rows=500, n_neighbors=9)
    gk = kk.compile_knn(knn.KnnModel.from_numpy(dk, device=cuda))
    Xc = torch.from_numpy(X).to(cuda)
    want_v, want_i = kk.topk_sim_idx_plain(gk, Xc)
    for rw in kk.rows_per_warp_choices(9):
        vals, idx = kk._launch(gk, Xc, rw)
        assert torch.equal(idx, want_i), rw
        assert torch.equal(vals.view(torch.int32), want_v.view(torch.int32))
    ds = chip_smoke.random_svc(3, X, n_sv=300, n_classes=3)
    gs = rk.compile_svc(svc.SvcModel.from_numpy(ds, device=cuda))
    assert (gs.n_features, gs.n_pairs) == (7, 3)
    want = rk.partial_decision_plain(gs, Xc)
    for r in rk.ROWS_PER_BLOCK:
        got = rk._launch(gs, Xc, None, r)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), r


def _dirty_engines(cuda, churn_schedule=(1.0, 1.0, 0.03, 0.4)):
    """Engines on the CPU and on the card (native ingest, dirty tracking)
    after the same churned ticks, the masks cleared before the last; and
    their telemetry sources."""
    from traffic_classifier_sdn_tpu_torch.ingest.batcher import FlowStateEngine

    engines = {d: FlowStateEngine(4096, device=d, native=True,
                                  track_dirty=True) for d in ("cpu", cuda)}
    syn = {d: SyntheticFlows(n_flows=4000, seed=6) for d in engines}
    for i, churn in enumerate(churn_schedule):
        for d, eng in engines.items():
            if i == len(churn_schedule) - 1:
                eng.dirty.zero_()
            syn[d].churn = churn
            eng.ingest_bytes(syn[d].tick_bytes())
            eng.step()
    return engines["cpu"], engines[cuda], syn


def test_dirty_tracking_on_card_equals_cpu(cuda):
    """The dirty-fused scatter, eviction's dirty bits, the count, the
    compaction at every bucket, the dirty-row gather, the label-cache
    scatter and the packed stale scan: bitwise the CPU's."""
    from traffic_classifier_sdn_tpu_torch.serving.incremental import (
        dirty_buckets,
    )

    a, b, _ = _dirty_engines(cuda)
    assert torch.equal(a.dirty, b.dirty.cpu())
    assert torch.equal(a.features(), b.features().cpu())
    n = int(ft.dirty_count(b.dirty))
    assert n == int(ft.dirty_count(a.dirty)) > 0
    for bucket in dirty_buckets(4096):
        ia, ib = ft.compact_dirty(a.dirty, bucket), ft.compact_dirty(b.dirty, bucket)
        assert torch.equal(ia, ib.cpu()), bucket
        Xa, Xb = ft.features12_at(a.table, ia), ft.features12_at(b.table, ib)
        assert torch.equal(Xa.view(torch.int32), Xb.view(torch.int32).cpu())
        labels = torch.arange(bucket, dtype=torch.int32) % 6
        ca = ft.merge_labels(torch.zeros(4097, dtype=torch.int32), ia, labels)
        cb = ft.merge_labels(torch.zeros(4097, dtype=torch.int32, device=cuda),
                             ib, labels.to(cuda))
        assert torch.equal(ca[:-1], cb[:-1].cpu())
    slots = np.array([3, 70, 4095], np.int64)
    assert a.evict_slots(slots) == b.evict_slots(slots) == 3
    assert torch.equal(a.dirty, b.dirty.cpu()) and bool(b.dirty[70])
    for now, idle in ((4, 1), (9, 3)):
        assert torch.equal(ft.stale_bits(a.table, now, idle),
                           ft.stale_bits(b.table, now, idle).cpu())


def test_incremental_labels_on_card_equal_cpu(cuda):
    """The label cache on the card, through the forest kernel on dirty
    subsets, equals the CPU's plain-version cache and a full predict."""
    from traffic_classifier_sdn_tpu_torch.serving.incremental import (
        IncrementalLabels,
    )

    a, b, syn = _dirty_engines(cuda, churn_schedule=(1.0,))
    d = chip_smoke.random_forest(0, a.features().numpy()[:4000], n_trees=24)
    k = {"cpu": fk.compile_forest(d, n_features=12, device="cpu"),
         cuda: fk.compile_forest(d, n_features=12, device=cuda)}
    inc = {"cpu": IncrementalLabels(a, fk.predict, k["cpu"]),
           cuda: IncrementalLabels(b, fk.predict, k[cuda])}
    for churn in (0.0, 0.003, 0.05, 0.2, 1.0):
        labels = {}
        for dev, eng in (("cpu", a), (cuda, b)):
            syn[dev].churn = churn
            eng.ingest_bytes(syn[dev].tick_bytes())
            eng.step()
            launches = fk.forest_proba.launches
            plan = inc[dev].dispatch()
            labels[dev] = inc[dev].finish(plan)
        # the card's plan launches the kernel once, unless nothing is dirty
        assert fk.forest_proba.launches - launches == (plan.kind != "none")
        assert torch.equal(labels["cpu"], labels[cuda].cpu()), churn
        assert torch.equal(labels[cuda], fk.predict(k[cuda], b.features()))


def test_forest_kernel_every_dirty_bucket_bitwise(cuda):
    """The forest kernel on dirty-row gathers of every bucket of capacity
    65,536 (16 to 16,384 rows, padding rows included): bitwise its plain
    version, one launch each."""
    from traffic_classifier_sdn_tpu_torch.serving.incremental import (
        dirty_buckets,
    )

    table = chip_smoke.synthetic_table(65536, 3, cuda)
    X = ft.features12(table)
    sample = X[::16][:4096].cpu().numpy()
    k = fk.compile_forest(chip_smoke.random_forest(0, sample), n_features=12,
                          device=cuda)
    rng = np.random.RandomState(1)
    for bucket in dirty_buckets(65536):
        dirty = torch.zeros(65537, dtype=torch.bool)
        dirty[rng.choice(65536, bucket - bucket // 8, replace=False)] = True
        idx = ft.compact_dirty(dirty.to(cuda), bucket)
        Xd = ft.features12_at(table, idx)
        launches = fk.forest_proba.launches
        got = fk.forest_proba(k, Xd)
        assert fk.forest_proba.launches == launches + 1
        want = fk.forest_proba_plain(k, Xd)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), bucket


def test_label_plan_waits_for_the_device_once(cuda):
    """A subset plan (count, compaction, gather, the forest kernel, the
    cache merge) waits for the card once: the dirty count's fetch."""
    import warnings

    from traffic_classifier_sdn_tpu_torch.serving.incremental import (
        IncrementalLabels,
    )

    a, b, syn = _dirty_engines(cuda, churn_schedule=(1.0,))
    d = chip_smoke.random_forest(0, a.features().numpy()[:4000], n_trees=24)
    inc = IncrementalLabels(b, fk.predict,
                            fk.compile_forest(d, n_features=12, device=cuda))
    inc.labels()  # the first render predicts the whole table
    syn[cuda].churn = 0.01
    b.ingest_bytes(syn[cuda].tick_bytes())
    b.step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            plan = inc.dispatch()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert plan.kind == "subset" and plan.n_dirty == 40
    syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) == 1, syncs


def test_ladder_device_call_syncs_once(cuda):
    """The ladder's HEALTHY device call (the kernel and its labels' copy
    to the host) waits for the card once per render."""
    import warnings

    from traffic_classifier_sdn_tpu_torch.serving.degrade import DegradeLadder

    X = torch.from_numpy(_served()[:4096]).to(cuda)
    d = chip_smoke.random_forest(0, X.cpu().numpy(), n_trees=24)
    k = fk.compile_forest(d, n_features=12, device=cuda)
    # deadline 0: the call runs on this thread, where the warning is raised
    lad = DegradeLadder(fk.predict, None, deadline=0)
    try:
        want = fk.predict(k, X).cpu().numpy()
        lad(k, X)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                got = lad(k, X)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        np.testing.assert_array_equal(got, want)
        assert lad.state == "HEALTHY"
        syncs = [str(w.message) for w in caught
                 if "synchroniz" in str(w.message)]
        assert len(syncs) == 1, syncs
    finally:
        lad.close()


def test_ladder_on_card_raises_a_kernel_fault(cuda, monkeypatch):
    """On CUDA features a device error that is neither injected nor a
    missed deadline ends the ladder's call instead of demoting; an armed
    ``degrade.dispatch_error`` still demotes."""
    from traffic_classifier_sdn_tpu_torch.serving.degrade import DegradeLadder
    from traffic_classifier_sdn_tpu_torch.utils import faults

    X = torch.from_numpy(_served()[:512]).to(cuda)
    d = chip_smoke.random_forest(0, X.cpu().numpy(), n_trees=8)
    k = fk.compile_forest(d, n_features=12, device=cuda)

    def broken(g, Xq):
        raise RuntimeError("CUDA error: unspecified launch failure")

    lad = DegradeLadder(broken, None, deadline=5.0)
    try:
        with pytest.raises(RuntimeError, match="launch failure"):
            lad(k, X)
        assert lad.state == "HEALTHY" and lad.transitions == []
    finally:
        lad.close()
    lad = DegradeLadder(fk.predict, None, deadline=5.0)
    plan = faults.FaultPlan([faults.FaultRule("degrade.dispatch_error")])
    try:
        with faults.installed(plan):
            lad(k, X)
        assert lad.transitions[0] == ("HEALTHY", "DEGRADED",
                                      "error:FaultInjected")
    finally:
        lad.close()


@pytest.mark.parametrize("sub", ["Randomforest", "knearest", "svm"])
def test_pipelined_serve_on_card_prints_what_the_serial_serve_prints(
        cuda, tmp_path, capsys, monkeypatch, sub):
    """The no-flag serve on the card (pipelined, the ladder, host-mode
    labels), with a handoff deeper than its renders, prints what the
    serial bare-kernel serve on the card prints; the ladder stays
    HEALTHY and the kernel launches once per render that predicts."""
    table = chip_smoke.synthetic_table(300, 2, "cpu")
    X = ft.features12(table).numpy()
    family, carry, counter, size = {
        "Randomforest": ("forest", interop.forest_params_from_numpy,
                         fk.forest_proba, {"n_trees": 16}),
        "knearest": ("knn", interop.knn_params_from_numpy, kk.topk_sim_idx,
                     {"n_rows": 500}),
        "svm": ("svc", interop.svc_params_from_numpy, rk.partial_decision,
                {"n_sv": 200}),
    }[sub]
    make = {"forest": chip_smoke.random_forest, "knn": chip_smoke.random_knn,
            "svc": chip_smoke.random_svc}[family]
    checkpoint.save_model(str(tmp_path), family,
                          carry(make(0, X, **size), "cpu"),
                          classes=chip_smoke.CLASSES)
    monkeypatch.setattr(cli, "PIPELINE_DEPTH", 64)
    capture = str(tmp_path / "churn.capture")
    chip_smoke.churn_capture(capture, 300)
    argv = [sub, "--native-checkpoint", str(tmp_path), "--source", "replay",
            "--capture", capture, "--capacity", "300", "--print-every", "1",
            "--idle-timeout", "2"]
    cli.main(argv + ["--pipeline", "off", "--degrade", "off"])
    serial = capsys.readouterr().out
    launches = counter.launches
    summary = cli.main(argv)
    assert capsys.readouterr().out == serial
    assert summary.ticks_coalesced == 0
    assert summary.degrade["state"] == "HEALTHY"
    assert summary.degrade["fallback_calls"] == 0
    predicting = [p for p in summary.render_plans if p[0] != "none"]
    assert counter.launches - launches == len(predicting)


@pytest.mark.parametrize("row", [[1.0, np.nan, 3.0, np.nan],
                                 [np.nan, 5.0, np.nan, 1.0],
                                 [-np.inf] * 4, [2.0, 2.0, 1.0, 2.0],
                                 [-0.0, 0.0, -0.0, 0.0]],
                         ids=["nan-after-max", "nan-first", "all-neg-inf",
                              "ties", "signed-zeros"])
def test_argmax_on_card_picks_as_on_cpu(cuda, row):
    """The families' argmax (``models.base.argmax_labels``) on the card
    picks what it picks on the CPU, where it is held to ``jnp.argmax``: the
    first maximum, the first NaN counting as the maximum — also in a batch
    large enough for the card's multi-block reduction."""
    from traffic_classifier_sdn_tpu_torch.models.base import argmax_labels

    x = torch.tensor([row] * 70000, dtype=torch.float32)
    want = argmax_labels(x)
    got = argmax_labels(x.to(cuda))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("family", sorted(chip_smoke.FAMILY_SERVES))
def test_family_predict_on_card_equals_cpu(cuda, family):
    """logreg, gnb and kmeans on the card against the same module on the
    CPU, on served rows and on non-finite ones: scores within the rounding
    of a 12-term float32 sum (``chip_smoke.family_scores``), labels equal
    but on near-ties (``chip_smoke.near_ties``)."""
    X = _served()
    _, carry, build = chip_smoke.FAMILY_SERVES[family]
    model = build(0, X)
    cpu_m = getattr(interop, carry)(model, "cpu")
    card_m = getattr(interop, carry)(model, cuda)
    Xt = torch.from_numpy(X)
    for Xc in (Xt, chip_smoke.with_nonfinite(Xt, every=3)):
        want_l, want = cpu_m.predict_scores(Xc)
        got_l, got = card_m.predict_scores(Xc.to(cuda))
        got, got_l = got.cpu(), got_l.cpu()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        fin = torch.isfinite(want)
        assert torch.equal(got[~fin & ~torch.isnan(want)],
                           want[~fin & ~torch.isnan(want)])
        _, scale = chip_smoke.family_scores(family, model, Xc.numpy())
        err = (got[fin].double() - want[fin].double()).abs().numpy()
        assert (err <= 24 * 2.0 ** -24 * scale[fin.numpy()]).all()
        differ = np.flatnonzero((got_l != want_l).numpy())
        near = chip_smoke.near_ties(family, model, None, Xc, None, differ)
        assert near.all(), differ[~near]


TORCH_TIERS = ("argmax", "hier", "hier5", "hier512", "screened",
               "screened1", "screened64")


@pytest.mark.parametrize("name", ["ties-k5", "served-k1", "served-k5",
                                  "served-k20"])
def test_knn_tiers_on_card_equal_the_kernel(cuda, name):
    """Each torch tier of ``--knn-topk`` on the card: neighbor indices
    bitwise equal to the kernel's on finite rows without signed-zero
    similarities (the tiers' shared precondition), and to the same tier
    on the CPU."""
    d, X = _knn_cases()[name]
    g = kk.compile_knn(knn.KnnModel.from_numpy(d, device=cuda))
    g_cpu = kk.compile_knn(knn.KnnModel.from_numpy(d, device="cpu"))
    Xc = torch.from_numpy(X).to(cuda)
    want = kk.neighbor_idx(g, Xc)
    sim = knn.dot_expansion_sim(Xc, g.fit_X, g.half_sq)
    sim_cpu = knn.dot_expansion_sim(torch.from_numpy(X), g_cpu.fit_X,
                                    g_cpu.half_sq)
    for tier in TORCH_TIERS:
        if tier.startswith("hier") and int(tier[4:] or 128) < g.n_neighbors:
            continue
        got = knn.neighbor_idx(sim, g.n_neighbors, tier)
        assert torch.equal(got, want), tier
        assert torch.equal(got.cpu(), knn.neighbor_idx(
            sim_cpu, g.n_neighbors, tier)), tier


def test_ivf_torch_tier_on_card(cuda):
    """The IVF tier on the card: the quantizer fit there is the same on a
    second fit (seeded generator, deterministic matmuls), labels at nprobe
    = K equal the kernel's, and the tier's labels and votes on the card
    equal the CPU's on the same quantizer at every nprobe."""
    from traffic_classifier_sdn_tpu_torch.ops import knn_ivf

    X = _served()
    d = chip_smoke.random_knn(0, X, n_rows=1000)
    kp = knn.KnnModel.from_numpy(d, device=cuda)
    ivf = knn_ivf.build(kp)
    again = knn_ivf.build(kp)
    assert torch.equal(ivf.centers, again.centers)
    assert torch.equal(ivf.list_idx, again.list_idx)
    Xc = torch.from_numpy(X).to(cuda)
    K = ivf.n_lists
    assert K == 32
    assert torch.equal(knn_ivf.predict(ivf, Xc, K),
                       kk.predict(kk.compile_knn(kp), Xc))
    cpu_ivf = interop.ivf_params_from_numpy(
        knn.KnnModel.from_numpy(d, device="cpu"), ivf.centers.cpu(),
        ivf.list_idx.cpu(), ivf.nprobe)
    for nprobe in (1, 2, 4, K):
        assert torch.equal(
            knn_ivf.neighbor_votes_ivf(ivf, Xc, nprobe).cpu(),
            knn_ivf.neighbor_votes_ivf(cpu_ivf, torch.from_numpy(X), nprobe))


def test_svc_dot_form_on_card(cuda):
    """``TCSDN_SVC_KERNEL=dot`` on the card against the CPU's dot form:
    labels equal on every row outside ``chip_smoke.dot_rule_rows``, and
    decisions within the same bound."""
    X = _served()
    d = chip_smoke.random_svc(0, X, n_sv=300)
    card = interop.svc_params_from_numpy(d, cuda)
    cpu = interop.svc_params_from_numpy(d, "cpu")
    Xt = torch.from_numpy(X)
    got = card.predict_dot_chunked(Xt.to(cuda)).cpu()
    want = cpu.predict_dot_chunked(Xt)
    rule = chip_smoke.dot_rule_rows(card, Xt.to(cuda))
    differ = (got != want).numpy()
    assert rule[differ].all()
    assert rule.sum() < X.shape[0] // 10


@pytest.mark.parametrize("native", [False, True])
def test_serving_checkpoint_round_trip_card_and_cpu(cuda, tmp_path, native):
    """A serving checkpoint saved from a table on the card restores on the
    CPU, and the CPU's save on the card, every leaf bitwise; both then
    continue identically (``*_lo`` counters past 2^32 included)."""
    from traffic_classifier_sdn_tpu_torch.ingest.batcher import (
        FlowStateEngine,
    )
    from traffic_classifier_sdn_tpu_torch.io import serving_checkpoint as sc

    syn = SyntheticFlows(n_flows=300)
    ticks = [syn.tick_bytes() for _ in range(3)]
    eng = FlowStateEngine(512, device=cuda, native=native)
    for data in ticks[:2]:
        eng.mark_tick()
        eng.ingest_bytes(data)
        eng.step()
    card_path, cpu_path = str(tmp_path / "card.npz"), str(tmp_path / "cpu.npz")
    sc.save(eng, card_path)
    on_cpu = sc.restore(card_path, device="cpu")
    sc.save(on_cpu, cpu_path)
    back = sc.restore(cpu_path, device=cuda)
    assert back.table.in_use.is_cuda and not on_cpu.table.in_use.is_cuda
    for e in (eng, on_cpu, back):
        e.mark_tick()
        e.ingest_bytes(ticks[2])
        e.step()
    for name in sc._TABLE_LEAVES:
        a = sc._fetch_leaf(eng.table, name)
        assert np.array_equal(a, sc._fetch_leaf(on_cpu.table, name)), name
        assert np.array_equal(a, sc._fetch_leaf(back.table, name)), name
    assert back.slot_metadata(range(512)) == eng.slot_metadata(range(512))


def _train_window(n: int = 600, n_classes: int = 6, seed: int = 0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, n_classes, n)
    centers = rng.gamma(2.0, 300.0, (n_classes, 12))
    X = np.abs(centers[y] * (1 + 0.35 * rng.randn(n, 12)))
    flip = rng.rand(n) < 0.25  # noise: the trees grow deep
    y = np.where(flip, rng.randint(0, n_classes, n), y)
    return X.astype(np.float32), y.astype(np.int32)


def test_forest_fit_on_card_equals_cpu(cuda, monkeypatch):
    """The forest trainer on the card writes the CPU's node stacks bit for
    bit given the same draws: the scatter-add histograms (atomics) of
    integer-valued counts are exact in any order, and the split takes the
    first maximum on the card too."""
    from traffic_classifier_sdn_tpu_torch.train import forest as tforest

    X, y = _train_window()
    gen = torch.Generator().manual_seed(3)
    draws = [tforest.tree_draws(gen, t, X.shape[0], 12, 10, bootstrap=True,
                                max_features=3, device="cpu")
             for t in range(6)]

    def recorded(gen, tree, n_rows, n_features, max_depth, *, bootstrap,
                 max_features, device):
        w, scores = draws[tree]
        return w.to(device), [s.to(device) for s in scores]

    monkeypatch.setattr(tforest, "tree_draws", recorded)
    cpu = tforest.fit(X, y, 6, n_trees=6, device="cpu")
    card = tforest.fit(X, y, 6, n_trees=6, device=cuda)
    for name in ("left", "right", "feature", "threshold", "values"):
        a, b = getattr(cpu, name), getattr(card, name).cpu()
        assert torch.equal(a, b), name
    a = torch.tensor([[1.0, 3.0, 3.0], [-np.inf] * 3, [2.0, 2.0, 2.0]],
                     device=cuda)
    assert tforest._first_argmax(a).tolist() == [1, 0, 0]


def test_trained_depth10_forest_kernel_bitwise_equals_plain(cuda):
    """A retrained forest's perfect-layout stacks (depth 10) through the
    kernel at every launch shape, bitwise, and its labels equal the
    gather traversal's."""
    from traffic_classifier_sdn_tpu_torch.train import forest as tforest

    X, y = _train_window(2048)
    model = tforest.fit(X, y, 6, n_trees=20, device=cuda)
    k = fk.compile_forest(model.node_arrays(), n_features=12, device=cuda)
    Xs = ft.features12(chip_smoke.synthetic_table(3000, 3, cuda))
    for rows in (777, 3000):
        for r in fk.ROWS_PER_TILE:
            got = fk._launch(k, Xs[:rows], r, k.per_chunk[r])
            want = chip_smoke.plain_forest_proba(k, Xs[:rows])
            assert torch.equal(got, want), (rows, r)
    Xt = torch.from_numpy(X).to(cuda)
    assert torch.equal(fk.predict(k, Xt), model.predict(Xt))


@pytest.mark.parametrize("family", ["forest", "gnb", "knn", "svc", "logreg",
                                    "kmeans"])
def test_refit_on_card_serves_on_card(cuda, family):
    """``retrain.fit_family`` on the card: the module's buffers stay on the
    card and its serving pair (the family's kernel where it has one)
    labels the window there; gnb's moments equal the CPU fit's within
    1e-6 relative."""
    from traffic_classifier_sdn_tpu_torch.models import make_loaded_model
    from traffic_classifier_sdn_tpu_torch.models.base import ClassList
    from traffic_classifier_sdn_tpu_torch.serving import retrain

    X, y = _train_window(300)
    kw = {"n_trees": 8} if family == "forest" else {}
    params = retrain.fit_family(family, X, y, 6, device=cuda, **kw)
    assert all(b.is_cuda for b in params.buffers())
    fn, p = make_loaded_model(family, params,
                              ClassList(chip_smoke.CLASSES)).serving_path()
    labels = fn(p, torch.from_numpy(X).to(cuda))
    assert labels.is_cuda and labels.shape == (300,)
    if family == "gnb":
        cpu = retrain.fit_family(family, X, y, 6, device="cpu")
        for name in ("theta", "inv_var", "log_const"):
            np.testing.assert_allclose(getattr(params, name).cpu().numpy(),
                                       getattr(cpu, name).numpy(),
                                       rtol=1e-6)


def test_openset_card_labels_equal_float64_rule(cuda):
    """The gate's float32 torch relabel on the card against the float64
    rule (``openset_scores``), on every row further than 1e-5 relative
    from the threshold; the stats are uploaded once per epoch."""
    from traffic_classifier_sdn_tpu_torch.serving import openset as tos

    X, y = _train_window(2000)
    Xc = torch.from_numpy(X).to(cuda)
    gate = tos.OpenSetGate(lambda _p, Z: torch.from_numpy(y).to(cuda)
                           [: Z.shape[0]], n_classes=6,
                           calibration_rows=1000)
    gate(None, Xc[:1000])
    gate(None, Xc[:1000])
    assert gate.state == tos.ARMED
    Q = Xc.clone()
    Q[::7] *= 40.0  # far from every class
    out = gate(None, Q).cpu().numpy()
    ref = gate.reference_arrays()
    Qh = Q.cpu().numpy().astype(np.float64)
    s = tos.openset_scores(Qh, ref["openset_mean"], ref["openset_inv_std"])
    thr = float(ref["openset_threshold"])
    ties = np.abs(s - thr) <= 1e-5 * thr
    want = np.where(Qh.any(1) & (s > thr), 6, y)
    assert (out[~ties] == want[~ties]).all()
    assert (out == 6).sum() >= X.shape[0] // 7 - ties.sum()
    assert gate.device_stats(Q.device)[0].is_cuda
