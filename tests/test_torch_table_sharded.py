"""The port's sharded flow table (``parallel/table_sharded.py``) against
the port's single-device spine and the JAX package's sharded table, case
for case with tests/test_table_sharded.py: the same records through each
must give the same table state (bitwise), render rows, read-side outputs
and eviction behavior — the partitioning over 8 shards (8 entries of the
one CPU device here, 8 virtual CPU devices on the JAX side) is invisible
to everything above it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traffic_classifier_sdn_tpu.core import flow_table as jft
from traffic_classifier_sdn_tpu.ingest.protocol import (
    TelemetryRecord as JRecord,
)
from traffic_classifier_sdn_tpu.parallel import mesh as jmesh
from traffic_classifier_sdn_tpu.parallel import table_sharded as jts
from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
from traffic_classifier_sdn_tpu_torch.ingest.batcher import FlowStateEngine
from traffic_classifier_sdn_tpu_torch.ingest.protocol import TelemetryRecord
from traffic_classifier_sdn_tpu_torch.native import engine as native_engine
from traffic_classifier_sdn_tpu_torch.parallel import mesh as meshlib
from traffic_classifier_sdn_tpu_torch.parallel import table_sharded as ts

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8,
    reason="the JAX side needs the conftest's 8-device CPU mesh",
)
NATIVE = [False, pytest.param(True, marks=pytest.mark.skipif(
    not native_engine.available(), reason="the C++ engine does not build"))]


def _rec(time, src, dst, pkts, bts, dp="1", cls=TelemetryRecord):
    return cls(time=time, datapath=dp, in_port=1, eth_src=src, eth_dst=dst,
               out_port=2, packets=pkts, bytes=bts)


def _label_fn(_params, X):
    """Deterministic per-row pseudo-labels from one exact column (Δbytes
    fwd), so they agree bitwise with ``_jlabel_fn``."""
    return (X[:, 1].to(torch.int64) % 6).to(torch.int32)


def _jlabel_fn(_params, X):
    return (X[:, 1].astype(jnp.int64) % 6).astype(jnp.int32)


def _workload(n_flows, ticks, seed=0, cls=TelemetryRecord):
    rng = np.random.RandomState(seed)
    out = []
    for t in range(1, ticks + 1):
        recs = []
        for i in range(n_flows):
            growth = int(rng.randint(0, 1 << 16))
            recs.append(_rec(t, f"s{i:02x}", f"d{i:02x}", 10 * t,
                             1000 * t + growth, cls=cls))
            if i % 3 == 0:  # reverse-direction telemetry for some flows
                recs.append(_rec(t, f"d{i:02x}", f"s{i:02x}", 5 * t,
                                 300 * t, cls=cls))
        out.append(recs)
    return out


@pytest.fixture(scope="module")
def mesh():
    return meshlib.make_mesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh8():
    return jmesh.make_mesh()


def _sharded(mesh, cap, **kw):
    kw.setdefault("predict_fn", _label_fn)
    kw.setdefault("table_rows", 8)
    return ts.ShardedFlowEngine(mesh, cap, params=None, **kw)


def _global_features(eng) -> np.ndarray:
    """Interleave per-shard rows back to global slot order (global slot g
    lives on shard g % n at local row g // n)."""
    X = np.stack([ft.features12(t).numpy() for t in eng.tables])
    return X.transpose(1, 0, 2).reshape(-1, 12)


def _drive(engines, ticks):
    for recs in ticks:
        for eng in engines:
            eng.mark_tick()
            eng.ingest(recs)
            eng.step()


def test_sharded_state_matches_single_device_and_jax(mesh, jmesh8):
    cap = 128  # 16 slots per shard
    single = FlowStateEngine(cap, device="cpu")
    sharded = _sharded(mesh, cap)
    _drive([single, sharded], _workload(40, 3))
    want = ft.features12(single.table).numpy()
    np.testing.assert_array_equal(_global_features(sharded), want)
    assert sharded.num_flows() == single.num_flows() == 40
    jeng = jts.ShardedFlowEngine(jmesh8, cap, predict_fn=_jlabel_fn,
                                 params=None, table_rows=8)
    _drive([jeng], _workload(40, 3, cls=JRecord))
    jX = np.stack([
        np.asarray(jft.features12(jax.tree.map(lambda a: a[s], jeng.tables)))
        for s in range(8)
    ]).transpose(1, 0, 2).reshape(-1, 12)
    np.testing.assert_array_equal(_global_features(sharded), jX)


@pytest.mark.parametrize("native", NATIVE)
def test_sharded_multi_update_tick_matches_single_device(mesh, native):
    """Three+ same-direction records for one flow in ONE tick: the
    coalesced sharded step cuts its apply groups at the conflict boundary,
    so the state matches the single-device spine's per-flush applies."""
    cap = 64
    single = FlowStateEngine(cap, device="cpu", native=native)
    sharded = _sharded(mesh, cap, native=native)
    recs = [
        _rec(1, "aa", "bb", 1, 100), _rec(1, "cc", "dd", 1, 50),
        _rec(1, "aa", "bb", 5, 500), _rec(1, "aa", "bb", 9, 800),
        _rec(1, "aa", "bb", 11, 1100), _rec(1, "cc", "dd", 3, 70),
    ]
    recs2 = [_rec(3, "aa", "bb", 20, 2000), _rec(3, "cc", "dd", 6, 90)]
    _drive([single, sharded], [recs, recs2])
    np.testing.assert_array_equal(_global_features(sharded),
                                  ft.features12(single.table).numpy())


@pytest.mark.parametrize("native", NATIVE)
def test_sharded_mixed_width_wire_matches_single_device(mesh, native):
    """A >2^31-packet flow forces the full wire among compact rows: the
    router widens before concatenating, and the state still matches."""
    cap = 64
    single = FlowStateEngine(cap, device="cpu", native=native)
    sharded = _sharded(mesh, cap, native=native)
    big = (1 << 33) + 7
    recs1 = [
        _rec(1, "aa", "bb", big, big * 100),
        _rec(1, "cc", "dd", 3, 300),
        _rec(1, "ee", "ff", 5, 500),
        _rec(1, "aa", "bb", big + 9, (big + 9) * 100),
        _rec(1, "aa", "bb", big + 11, (big + 11) * 100),
    ]
    recs2 = [_rec(4, "aa", "bb", big + 20, (big + 20) * 100),
             _rec(4, "cc", "dd", 9, 900)]
    _drive([single, sharded], [recs1, recs2])
    np.testing.assert_array_equal(_global_features(sharded),
                                  ft.features12(single.table).numpy())


@pytest.mark.parametrize("incremental", [False, True])
def test_sharded_render_matches_single_device(mesh, incremental):
    cap = 128
    single = FlowStateEngine(cap, device="cpu")
    sharded = _sharded(mesh, cap, incremental=incremental)
    _drive([single, sharded], _workload(40, 2, seed=7))
    labels = _label_fn(None, ft.features12(single.table))
    want = single.render_sample(labels, 8)
    got, evicted = sharded.tick_render(now=sharded.last_time,
                                       idle_seconds=3600)
    assert evicted == 0
    assert got == want
    meta = sharded.slot_metadata([s for s, *_ in got])
    assert len(meta) == len(got)


def test_sharded_eviction_matches_single_device(mesh):
    cap = 64
    single = FlowStateEngine(cap, device="cpu")
    sharded = _sharded(mesh, cap, table_rows=4)
    _drive([single, sharded], [_workload(24, 1)[0]])
    fresh = [_rec(5000, f"s{i:02x}", f"d{i:02x}", 100, 10000)
             for i in range(0, 24, 3)]
    _drive([single, sharded], [fresh])
    want_evicted = single.evict_idle(now=5000, idle_seconds=1000)
    _rows, got_evicted = sharded.tick_render(now=5000, idle_seconds=1000)
    assert got_evicted == want_evicted == 16
    assert sharded.num_flows() == single.num_flows() == 8
    for t in sharded.tables:  # evicted state is zeroed on every shard
        in_use = t.in_use[:-1].numpy()
        assert not ft.features12(t).numpy()[~in_use].any()
    more = [_rec(6000, f"n{i}", f"m{i}", 1, 10) for i in range(16)]
    _drive([sharded], [more])
    assert sharded.num_flows() == 24


@pytest.mark.parametrize("incremental", [False, True])
def test_tick_outputs_equal_jax_tick_outputs(mesh, jmesh8, incremental):
    """The gathered read-side outputs — per-shard ranked slots, valid
    flags, scores, labels, active flags and stale bits — equal the JAX
    engine's all-gathered ones, shard for shard, on a table with unused
    (−inf) rows that tie."""
    cap = 64
    eng = _sharded(mesh, cap, table_rows=4, incremental=incremental)
    jeng = jts.ShardedFlowEngine(jmesh8, cap, predict_fn=_jlabel_fn,
                                 params=None, table_rows=4,
                                 incremental=incremental)
    _drive([eng], _workload(24, 2, seed=3)[:1])
    _drive([jeng], _workload(24, 2, seed=3, cls=JRecord)[:1])
    got = eng.tick_read_dispatch(now=2, idle_seconds=1).host()
    want = [np.asarray(o) for o in jeng.tick_read_dispatch(
        now=2, idle_seconds=1)]
    assert len(got) == len(want) == 7
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=str(k))


def test_top_active_scored_equals_jax_on_ties():
    """Stable descending order: equal scores (stale rows at 0, unused rows
    at −inf) keep ascending slot order, as ``lax.top_k`` does."""
    eng = FlowStateEngine(32, device="cpu")
    _drive([eng], _workload(10, 2, seed=1))
    eng.mark_tick()
    eng.ingest([_rec(3, "s01", "d01", 40, 99999)])
    eng.step()
    floor = 2
    labels = _label_fn(None, ft.features12(eng.table))
    got = [t.numpy() for t in ft.top_active_scored(eng.table, labels, 32,
                                                   floor)]
    from traffic_classifier_sdn_tpu_torch.io import serving_checkpoint as sc

    jtable = jft.FlowTable(
        time_start=jnp.asarray(sc._fetch_leaf(eng.table, "time_start")),
        in_use=jnp.asarray(sc._fetch_leaf(eng.table, "in_use")),
        fwd=jft.DirState(**{f: jnp.asarray(sc._fetch_leaf(eng.table,
                                                          f"fwd.{f}"))
                            for f in sc._DIR_FIELDS}),
        rev=jft.DirState(**{f: jnp.asarray(sc._fetch_leaf(eng.table,
                                                          f"rev.{f}"))
                            for f in sc._DIR_FIELDS}),
    )
    want = [np.asarray(o) for o in jft.top_active_scored(
        jtable, jnp.asarray(labels.numpy()), 32, floor)]
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=str(k))
    assert np.isneginf(got[2]).sum() == 32 - 10  # the unused rows tie


def test_feature_sample_and_dirty_counts(mesh):
    cap = 64
    single = FlowStateEngine(cap, device="cpu")
    eng = _sharded(mesh, cap, incremental=True)
    _drive([single, eng], _workload(20, 2, seed=5))
    slots = [19, 0, 7, 8, 63]
    X = eng.feature_sample(slots)
    want = ft.features12(single.table).numpy()[slots]
    np.testing.assert_array_equal(X, want)
    counts = eng._dirty_counts(eng.dirty)
    assert counts.shape == (8,) and int(counts.sum()) == 64  # all dirty
    eng.tick_render(now=eng.last_time, idle_seconds=None)
    assert int(eng._dirty_counts(eng.dirty).sum()) == 0


@pytest.mark.parametrize("native", NATIVE)
def test_sharded_churn_recycles_slots_without_drops(mesh, native):
    """Sustained churn: tick_render's folded eviction recycles slots
    across ALL shards fast enough that the global table never fills."""
    cap = 512
    stable_n, churn_n = cap // 2, cap // 8
    eng = _sharded(mesh, cap, native=native)
    generation = 0
    evicted_total = 0
    for tick in range(1, 13):
        if tick % 2 == 0:
            generation += 1
        recs = [
            _rec(tick, f"st-{i:04x}", "gw", tick * 3, tick * 100)
            for i in range(stable_n)
        ] + [
            _rec(tick, f"ch{generation}-{i:04x}", "gw", tick * 3, tick * 100)
            for i in range(churn_n)
        ]
        eng.mark_tick()
        eng.ingest(recs)
        eng.step()
        rows, evicted = eng.tick_render(now=tick, idle_seconds=2)
        evicted_total += evicted
        assert len(rows) == 8
        assert eng.dropped == 0, f"tick {tick}: dropped flows"
        assert eng.num_flows() <= stable_n + 2 * churn_n
    assert evicted_total >= 4 * churn_n


def test_capacity_must_divide(mesh):
    with pytest.raises(ValueError, match="divide evenly"):
        _sharded(mesh, 60)
    with pytest.raises(ValueError, match="without a predict_fn"):
        ts.ShardedFlowEngine(mesh, 64).tick_render(now=0, idle_seconds=None)
