"""Incremental labels in the port (``serving/incremental.py`` and the dirty
functions of ``core/flow_table.py``), against the JAX package.

- The dirty functions: dirty masks, ``compact_dirty`` indices,
  ``features12_at`` rows, the label-cache scatter and ``stale_bits`` are
  bitwise equal to JAX's on the same inputs (tables built from the same
  seeded telemetry).
- The label cache: ``IncrementalLabels`` serves labels equal to a full
  re-predict of the table at every churn level, through idle eviction,
  ``invalidate``, a label-epoch change and the absorbed fault sites, on
  both ingest spines.
- The CLI: on a churn capture (``chip_smoke.churn_capture``: full ticks,
  then 1 %, 0 %, 20 % and 100 % of the conversations reporting), the
  port's ``--incremental auto`` stdout, with native ingest on and off, is
  byte-identical to its ``--incremental off`` and to the JAX CLI's
  ``--native-ingest on --incremental auto --pipeline off --degrade off``,
  with and without idle eviction, for ``Randomforest``, ``knearest`` and
  ``svm`` (the models of tests/test_torch_serve.py, where a KNN or SVC
  label may differ only on an f32 near-tie; none occurs here).
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from traffic_classifier_sdn_tpu import cli as jcli
from traffic_classifier_sdn_tpu.core import flow_table as jft
from traffic_classifier_sdn_tpu.ingest.batcher import (
    FlowStateEngine as JaxEngine,
)
from traffic_classifier_sdn_tpu.io import checkpoint as jck
from traffic_classifier_sdn_tpu.models import forest as jforest
from traffic_classifier_sdn_tpu.models import knn as jknn
from traffic_classifier_sdn_tpu.models import svc as jsvc
from traffic_classifier_sdn_tpu.serving import incremental as jinc
from traffic_classifier_sdn_tpu_torch import cli as tcli
from traffic_classifier_sdn_tpu_torch import interop
from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
from traffic_classifier_sdn_tpu_torch.ingest.batcher import FlowStateEngine
from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows
from traffic_classifier_sdn_tpu_torch.io import checkpoint as tck
from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk
from traffic_classifier_sdn_tpu_torch.serving.incremental import (
    IncrementalLabels,
    dirty_buckets,
)
from traffic_classifier_sdn_tpu_torch.utils import faults
from torch_witnesses import _torch_syncguard_witness  # noqa: F401 — the sync witness rides this suite

CLASSES = chip_smoke.CLASSES


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


def _engines(capacity: int, churn: float, ticks: int, seed: int = 2):
    """A port engine and a JAX engine (Python spines, dirty tracking on)
    after the same ``SyntheticFlows`` ticks, their dirty masks cleared
    before the last one; the wires of that tick."""
    syn = [SyntheticFlows(n_flows=capacity - 3, seed=seed, churn=churn)
           for _ in range(2)]
    port = FlowStateEngine(capacity, device="cpu", track_dirty=True)
    jax_eng = JaxEngine(capacity, track_dirty=True)
    wires = []
    apply = port._apply_wire
    port._apply_wire = lambda w: (wires.append(w.copy()), apply(w))
    for t in range(ticks):
        if t == ticks - 1:
            port.dirty.zero_()
            jax_eng.dirty = jnp.zeros_like(jax_eng.dirty)
            wires.clear()
        for eng, s in zip((port, jax_eng), syn):
            eng.ingest(s.tick())
            eng.step()
    return port, jax_eng, wires


def _assert_table_equal(port, jax_eng):
    np.testing.assert_array_equal(
        port.features().numpy(), np.asarray(jft.features12(jax_eng.table)))
    np.testing.assert_array_equal(port.table.in_use.numpy(),
                                  np.asarray(jax_eng.table.in_use))


@pytest.mark.parametrize("churn", [0.05, 0.5, 1.0])
def test_dirty_scatter_matches_jax(churn):
    """``apply_wire_dirty`` marks exactly JAX's slots, the table stays
    bitwise equal, and ``mark_dirty_wire`` alone marks the same."""
    port, jax_eng, wires = _engines(200, churn, 4)
    _assert_table_equal(port, jax_eng)
    np.testing.assert_array_equal(port.dirty.numpy(),
                                  np.asarray(jax_eng.dirty))
    mask = torch.zeros(201, dtype=torch.bool)
    for w in wires:
        mask = ft.mark_dirty_wire(mask, ft.wire_tensor(w, "cpu"))
    assert torch.equal(mask[:-1], port.dirty[:-1])
    n = int(ft.dirty_count(port.dirty))
    assert n == int(jft.dirty_count(jax_eng.dirty)) > 0


@pytest.mark.parametrize("capacity", [7, 64, 300])
@pytest.mark.parametrize("density", [0.0, 0.02, 0.3, 1.0])
def test_compact_dirty_matches_jax(capacity, density):
    """Ascending dirty indices padded with ``capacity``, bitwise JAX's
    ``jnp.nonzero(size=, fill_value=)`` — also when more rows are dirty
    than the bucket holds (the first ``bucket`` are kept)."""
    rng = np.random.RandomState(capacity)
    d = rng.rand(capacity + 1) < density
    for bucket in (1, 16, 64, 256):
        want = np.asarray(jft.compact_dirty(jnp.asarray(d), bucket))
        got = ft.compact_dirty(torch.from_numpy(d), bucket).numpy()
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert int(ft.dirty_count(torch.from_numpy(d))) == int(d[:-1].sum())


def test_features12_at_merge_labels_match_jax():
    """``features12_at`` equals JAX's and ``features12(table)[idx]``
    bitwise, padding rows project to zeros, and ``merge_labels`` writes
    the real rows as JAX's ``mode="drop"`` scatter does."""
    port, jax_eng, _ = _engines(120, 0.3, 4)
    for bucket in dirty_buckets(120):
        idx = ft.compact_dirty(port.dirty, bucket)
        jidx = jft.compact_dirty(jax_eng.dirty, bucket)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        X = ft.features12_at(port.table, idx)
        np.testing.assert_array_equal(
            X.numpy(), np.asarray(jft.features12_at(jax_eng.table, jidx)))
        real = idx < 120
        assert torch.equal(X[real], port.features()[idx[real].long()])
        assert not X[~real].any()
        labels = torch.arange(bucket, dtype=torch.int32) % 6
        cache = torch.full((121,), -1, dtype=torch.int32)
        got = ft.merge_labels(cache, idx, labels)[:120]
        want = jft.merge_labels(jnp.full(120, -1, jnp.int32), jidx,
                                jnp.asarray(labels.numpy()))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_clear_and_mark_slots_and_stale_bits_match_jax():
    port, jax_eng, _ = _engines(100, 0.4, 5)
    slots = np.array([3, 50, 99, 100, 100], np.int32)  # padded with capacity
    table, dirty = ft.clear_slots_dirty(
        port.table, torch.zeros(101, dtype=torch.bool),
        torch.from_numpy(slots))
    jtable, jdirty = jft.clear_slots_dirty(
        jax_eng.table, jnp.zeros(101, bool), jnp.asarray(slots))
    np.testing.assert_array_equal(dirty.numpy(), np.asarray(jdirty))
    np.testing.assert_array_equal(ft.features12(table).numpy(),
                                  np.asarray(jft.features12(jtable)))
    marked = ft.mark_dirty_slots(torch.zeros(101, dtype=torch.bool),
                                 torch.from_numpy(slots))
    np.testing.assert_array_equal(marked.numpy(), np.asarray(jdirty))
    for now, idle in ((5, 1), (5, 3), (9, 2)):
        want = np.asarray(jft.stale_bits(jax_eng.table, np.int32(now),
                                         np.int32(idle)))
        got = ft.stale_bits(port.table, now, idle).numpy()
        assert got.dtype == np.uint8 and got.any()
        np.testing.assert_array_equal(got, want)


def test_dirty_buckets_match_jax():
    for capacity in (1, 16, 17, 200, 65536, 1 << 20):
        assert dirty_buckets(capacity) == jinc.dirty_buckets(capacity)
    assert dirty_buckets(65536) == (16, 64, 256, 1024, 4096, 16384)


def _forest(X_sample, n_trees=12):
    d = chip_smoke.random_forest(0, X_sample, n_trees=n_trees)
    return d, fk.compile_forest(d, n_features=12, device="cpu")


class _Epoch:
    """A predict callable with a ``label_epoch``, as a promotion or a
    degrade rung change would expose it."""

    def __init__(self):
        self.label_epoch = 0

    def __call__(self, k, X):
        return fk.predict(k, X)


@pytest.mark.parametrize("native", [False, True])
def test_label_cache_equals_full_predict(native):
    """Churn from 0 to 100 %, idle eviction, ``invalidate``, a label-epoch
    change: the cache always equals the full re-predict, and the plan is
    the cheapest one that keeps it so."""
    cap = 300
    syn = SyntheticFlows(n_flows=280, seed=4)
    warm = FlowStateEngine(cap, device="cpu")
    warm.ingest(syn.tick())
    warm.step()
    _, k = _forest(warm.features().numpy()[:280])
    predict = _Epoch()
    eng = FlowStateEngine(cap, device="cpu", native=native, track_dirty=True)
    inc = IncrementalLabels(eng, predict, k)
    syn = SyntheticFlows(n_flows=280, seed=4)
    schedule = [1.0, 1.0, 0.01, 0.0, 0.1, 0.5, 1.0, 0.02, 0.02, 0.0, 0.3]
    kinds = []
    for t, churn in enumerate(schedule):
        syn.churn = churn
        eng.mark_tick()
        eng.ingest(syn.tick())
        eng.step()
        if t == 8:  # an eviction: the cleared rows turn dirty
            assert eng.evict_slots(np.array([5, 17, 40, 41])) == 4
        if t == 9:
            inc.invalidate("test")
        if t == 10:
            predict.label_epoch += 1
        plan = inc.dispatch()
        labels = inc.finish(plan)
        kinds.append(plan.kind)
        want = fk.predict(k, eng.features())
        assert labels.dtype == torch.int32 and torch.equal(labels, want), t
    assert kinds == ["full", "full", "subset", "none", "subset", "subset",
                     "full", "subset", "subset", "full", "full"]
    assert inc.status()["invalidations"] == 2
    assert inc.status()["subset_predicts"] == 5


@pytest.mark.chaos
@pytest.mark.parametrize("site", ["serve.dirty_mask", "serve.label_cache"])
def test_faults_are_absorbed_with_fresh_labels(site):
    """A fire serves that tick from a direct full predict (never a stale
    label), leaving cache and mask for the next tick."""
    cap = 200
    syn = SyntheticFlows(n_flows=150, seed=8)
    eng = FlowStateEngine(cap, device="cpu", track_dirty=True)
    eng.ingest(syn.tick())
    eng.step()
    _, k = _forest(eng.features().numpy()[:150])
    inc = IncrementalLabels(eng, fk.predict, k)
    kinds = []
    for t in range(4):
        syn.churn = 0.05
        eng.ingest(syn.tick())
        eng.step()
        plan = None
        if t == 2:
            rule = faults.FaultRule(site, after=0, times=1)
            with faults.installed(faults.FaultPlan([rule])) as p:
                plan = inc.dispatch()
            assert p.fires == [(site, 1)]
        plan = plan or inc.dispatch()
        kinds.append(plan.kind)
        assert torch.equal(inc.finish(plan), fk.predict(k, eng.features()))
    after = "full" if site == "serve.dirty_mask" else "subset"
    assert kinds == ["full", "subset", "full-nocommit", after]


class _Observers:
    """Stand-ins for the degrade ladder, metrics, recorder and tracer."""

    def __init__(self):
        self.rung = "HEALTHY"
        self.events = []

    def status(self):
        return {"rung": self.rung}

    def inc(self, name, n=1):
        self.events.append(("inc", name, n))

    def set(self, name, value):
        self.events.append(("set", name, value))

    def record(self, event, **fields):
        self.events.append(("record", event, fields))

    def span(self, name):
        self.events.append(("span", name))
        return contextlib.nullcontext()


def test_degrade_rung_and_observers():
    """Off the ladder's healthy rung every render predicts the whole
    table; the optional observers see the plan's counts and events."""
    cap = 100
    syn = SyntheticFlows(n_flows=90, seed=1)
    eng = FlowStateEngine(cap, device="cpu", track_dirty=True)
    eng.ingest(syn.tick())
    eng.step()
    _, k = _forest(eng.features().numpy()[:90])
    obs = _Observers()
    inc = IncrementalLabels(eng, fk.predict, k, degrade=obs, metrics=obs,
                            recorder=obs, tracer=obs)
    kinds = []
    for rung in ("HEALTHY", "HEALTHY", "DEGRADED", "HEALTHY"):
        obs.rung = rung
        syn.churn = 0.05
        eng.ingest(syn.tick())
        eng.step()
        plan = inc.dispatch()
        kinds.append(plan.kind)
        assert torch.equal(inc.finish(plan), fk.predict(k, eng.features()))
    assert kinds == ["full", "subset", "full", "subset"]
    assert ("span", "compact") in obs.events
    assert ("inc", "predict_rows_saved", cap - 4) in obs.events
    assert ("set", "dirty_rows", 4) in obs.events
    inc.invalidate("test")
    assert ("record", "label_cache.invalidate", {"reason": "test"}) in obs.events
    assert ("inc", "label_cache_invalidations", 1) in obs.events
    assert inc.status() == {
        "mode": "device", "coverage": 0.96, "dirty_rows": 4,
        "invalidations": 1, "full_predicts": 2, "subset_predicts": 2,
    }


# ---------------------------------------------------------------------------
# the CLI on a churn capture
# ---------------------------------------------------------------------------

N_FLOWS = 48


def _capture_and_sample(tmp_path):
    cap = tmp_path / "churn.capture"
    reporting = chip_smoke.churn_capture(str(cap), N_FLOWS)
    assert reporting == [48, 48, 0, 0, 10, 48]
    syn = SyntheticFlows(n_flows=N_FLOWS)
    eng = FlowStateEngine(N_FLOWS, device="cpu")
    for _ in range(2):
        eng.ingest(syn.tick())
        eng.step()
    return str(cap), eng.features().numpy()


FAMILIES = {
    "Randomforest": ("forest", jforest, chip_smoke.random_forest,
                     interop.forest_params_from_numpy, {"n_trees": 16}),
    "knearest": ("knn", jknn, chip_smoke.random_knn,
                 interop.knn_params_from_numpy, {"n_rows": 400}),
    "svm": ("svc", jsvc, chip_smoke.random_svc,
            interop.svc_params_from_numpy, {"n_sv": 200}),
}


def _checkpoints(tmp_path, sub, X_sample):
    family, jmod, build, carry, size = FAMILIES[sub]
    d = build(0, X_sample, **size)
    jp = jmod.from_numpy(d)
    jdir, tdir = str(tmp_path / "jax_ckpt"), str(tmp_path / "port_ckpt")
    jck.save_model(jdir, family, jp, classes=CLASSES)
    params = carry(d if family == "forest" else jp, device="cpu")
    tck.save_model(tdir, family, params, classes=CLASSES)
    return jdir, tdir


def test_churn_capture_schedule(tmp_path):
    """1 % of 48 conversations rounds to none, so the tick holds the one
    dropped line, as the 0 % tick does; 20 % is 10 conversations."""
    cap, _ = _capture_and_sample(tmp_path)
    lines = open(cap, "rb").read().splitlines()
    times = [int(line.split(b"\t")[1]) for line in lines]
    assert [times.count(t) for t in range(1, 7)] == [96, 96, 1, 1, 20, 96]


@pytest.mark.parametrize("idle", ["60", "2"])
@pytest.mark.parametrize("sub", ["Randomforest", "knearest", "svm"])
def test_cli_incremental_stdout_identical(tmp_path, capsys, monkeypatch,
                                          sub, idle):
    monkeypatch.delenv("TCSDN_KNN_TOPK", raising=False)
    monkeypatch.delenv("TCSDN_SVC_KERNEL", raising=False)
    capture, X = _capture_and_sample(tmp_path)
    jdir, tdir = _checkpoints(tmp_path, sub, X)
    common = [sub, "--source", "replay", "--capture", capture,
              "--capacity", str(N_FLOWS), "--print-every", "1",
              "--idle-timeout", idle, "--table-rows", "16"]
    jcli.main(common + ["--native-checkpoint", jdir, "--native-ingest", "on",
                        "--incremental", "auto", "--pipeline", "off",
                        "--degrade", "off"])
    want = capsys.readouterr().out
    assert want.count("Flow ID") == 6
    runs = {}
    for native in ("on", "off"):
        for inc in ("auto", "off"):
            summary = tcli.main(common + [
                "--native-checkpoint", tdir, "--device", "cpu",
                "--native-ingest", native, "--incremental", inc,
                "--pipeline", "off", "--degrade", "off"])
            runs[native, inc] = capsys.readouterr().out
            assert summary.engine.native == (native == "on")
            if inc == "auto":
                plans = [kind for kind, _ in summary.render_plans]
                # with a 2 s idle horizon the fourth render evicts every
                # flow, and the evicted rows are dirty
                assert plans == ["full", "full", "none",
                                 "none" if idle == "60" else "full",
                                 "subset", "full"]
    for key, out in runs.items():
        assert out == want, key
