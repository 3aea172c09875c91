"""The port's region serve — fan-in × sharded table × incremental labels ×
native ingest × checkpoints × drift, fused (``--shards``) — against the
port's single-spine serves and the JAX package's ``--shards`` serve, case
for case with tests/test_region.py. The port's 8 shards sit on the one
CPU device: the tests replace ``parallel.mesh.visible_devices`` (what the
CLI asks for its devices) with 8 entries of it, as the JAX tests give the
JAX CLI 8 virtual CPU devices.

Pinned here:

- the port's ``--shards 8`` serve prints exactly what its un-sharded serve
  and the JAX ``--shards 8`` serve print, serial and pipelined;
- the same records through one direct source, or split over two fan-in
  sources on the sharded spine, give the same per-flow labels;
- ``--shards 1`` builds the sharded engine (an explicit one-shard mesh);
- serving checkpoints on the sharded spine: written mid-serve by either
  package, restored sharded→sharded, sharded→single, single→sharded and
  across packages with the table leaves and the index bitwise equal;
- kill-one-of-three evicts exactly one namespace across shard borders;
- a drift promotion installs through ``ShardedDriftGate``;
- the JAX CLI's refusals, with its text, and no fallback: a predict that
  fails ends the sharded serve.
"""

import contextlib
import io
import time

import jax
import numpy as np
import pytest
import torch

from traffic_classifier_sdn_tpu import cli as jcli
from traffic_classifier_sdn_tpu.io import checkpoint as jck
from traffic_classifier_sdn_tpu.io import serving_checkpoint as jsc
from traffic_classifier_sdn_tpu.models import gnb as jgnb
from traffic_classifier_sdn_tpu.parallel import mesh as jmeshlib
from traffic_classifier_sdn_tpu_torch import cli, interop
from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
from traffic_classifier_sdn_tpu_torch.ingest.batcher import FlowStateEngine
from traffic_classifier_sdn_tpu_torch.ingest import fanin
from traffic_classifier_sdn_tpu_torch.ingest.protocol import (
    TelemetryRecord,
    format_line,
)
from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows
from traffic_classifier_sdn_tpu_torch.io import checkpoint as tck
from traffic_classifier_sdn_tpu_torch.io import serving_checkpoint as sc
from traffic_classifier_sdn_tpu_torch.native import engine as native_engine
from traffic_classifier_sdn_tpu_torch.parallel import mesh as meshlib
from traffic_classifier_sdn_tpu_torch.parallel import table_sharded as ts
from traffic_classifier_sdn_tpu_torch.serving import retrain
from traffic_classifier_sdn_tpu_torch.serving.drift import (
    PROMOTED,
    RETRAINING,
    DriftController,
    ShardedDriftGate,
    default_build_serving,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8,
    reason="the JAX side needs the conftest's 8-device CPU mesh",
)
NATIVE = [False, pytest.param(True, marks=pytest.mark.skipif(
    not native_engine.available(), reason="the C++ engine does not build"))]


def _label_fn(_params, X):
    return (X[:, 1].to(torch.int64) % 6).to(torch.int32)


@pytest.fixture
def eight_shards(monkeypatch):
    """The CLI's mesh sees 8 entries of the CPU device; renders never
    coalesce, so pipelined stdout is every frame."""
    monkeypatch.setattr(meshlib, "visible_devices",
                        lambda device=None: [torch.device("cpu")] * 8)
    monkeypatch.setattr(cli, "PIPELINE_DEPTH", 64)


@pytest.fixture(scope="module")
def gnb_checkpoints(tmp_path_factory):
    """The JAX region tests' seeded two-class GNB, saved by both
    packages."""
    rng = np.random.RandomState(0)
    jp = jgnb.from_numpy({
        "theta": rng.gamma(2.0, 100.0, (2, 12)),
        "var": rng.gamma(2.0, 50.0, (2, 12)) + 1.0,
        "class_prior": np.full(2, 0.5),
    })
    root = tmp_path_factory.mktemp("region_ckpt")
    jdir, tdir = str(root / "jax"), str(root / "port")
    jck.save_model(jdir, "gnb", jp, classes=("ping", "voice"))
    tck.save_model(tdir, "gnb", interop.gnb_params_from_numpy(jp, "cpu"),
                   classes=("ping", "voice"))
    return jdir, tdir


def _serve(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        summary = main(argv)
    return out.getvalue(), err.getvalue(), summary


def _composed_args(ckpt):
    """The region serve minus --shards: two lockstep fan-in sources,
    incremental labels, native ingest where it builds."""
    return [
        "gaussiannb", "--native-checkpoint", ckpt,
        "--source", "synthetic", "--synthetic-flows", "16",
        "--capacity", "64", "--print-every", "2", "--max-ticks", "6",
        "--idle-timeout", "0", "--table-rows", "8",
        "--sources", "2", "--source-lockstep",
        "--incremental", "auto", "--native-ingest", "auto",
    ]


def _port_args(tdir):
    return _composed_args(tdir) + ["--device", "cpu"]


@pytest.fixture(scope="module")
def jax_region_stdout(gnb_checkpoints):
    """The JAX ``--shards 8`` region serve's stdout (serial: a pipelined
    port serve that coalesces nothing prints the same frames)."""
    out, _, _ = _serve(jcli.main, _composed_args(gnb_checkpoints[0]) + [
        "--shards", "8", "--pipeline", "off"])
    return out


@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_composed_region_byte_identical_to_unsharded_and_jax(
        gnb_checkpoints, jax_region_stdout, eight_shards, pipeline):
    """fan-in × sharded × incremental × native prints what the un-sharded
    serve prints, and what the JAX ``--shards 8`` serve prints."""
    tdir = gnb_checkpoints[1]
    common = _port_args(tdir) + ["--pipeline", pipeline]
    unsharded, _, _ = _serve(cli.main, common)
    composed, _, summary = _serve(cli.main, common + ["--shards", "8"])
    assert "Flow ID" in unsharded
    assert composed == unsharded
    assert isinstance(summary.engine, ts.ShardedFlowEngine)
    assert summary.engine.n_shards == 8 and summary.engine.incremental
    assert composed == jax_region_stdout


def _parse_tables(out):
    """Rendered tables keyed (src, dst): the namespace-stripped view."""
    tables, current = [], None
    for line in out.splitlines():
        if line.startswith("| Flow ID"):
            current = {}
            tables.append(current)
            continue
        if current is None or not line.startswith("|"):
            continue
        cells = [c.strip() for c in line.strip("|").split("|")]
        if len(cells) == 6 and cells[0] != "Flow ID":
            _slot, src, dst, label, fwd, rev = cells
            current[(src, dst)] = (label, fwd, rev)
    return tables


def test_composed_region_matches_direct_path_on_same_capture(
        gnb_checkpoints, eight_shards, tmp_path):
    """One direct un-sharded source vs the same records split over two
    fan-in sources on the sharded spine: the same per-flow labels at
    every render, namespaces stripped."""
    syn = SyntheticFlows(n_flows=8, seed=7)
    ticks = [syn.tick() for _ in range(6)]
    whole, part_a, part_b = (tmp_path / n for n in ("w.tsv", "a.tsv",
                                                    "b.tsv"))
    macs_a = {syn._mac(i, 0) for i in range(4)}
    with open(whole, "wb") as fw, open(part_a, "wb") as fa, \
            open(part_b, "wb") as fb:
        for tick in ticks:
            for r in tick:
                fw.write(format_line(r))
                in_a = r.eth_src in macs_a or r.eth_dst in macs_a
                (fa if in_a else fb).write(format_line(r))
    base = [
        "gaussiannb", "--native-checkpoint", gnb_checkpoints[1],
        "--capacity", "64", "--print-every", "2", "--max-ticks", "6",
        "--table-rows", "8", "--incremental", "auto",
        "--native-ingest", "auto", "--source-lockstep", "--device", "cpu",
    ]
    direct, _, _ = _serve(cli.main, base + ["--source-spec",
                                            f"capture:{whole}"])
    composed, _, _ = _serve(cli.main, base + [
        "--shards", "8",
        "--source-spec", f"capture:{part_a}",
        "--source-spec", f"capture:{part_b}",
    ])
    t_one, t_two = _parse_tables(direct), _parse_tables(composed)
    assert t_one and len(t_one) == len(t_two)
    for i, (a, b) in enumerate(zip(t_one, t_two)):
        assert a == b, f"render {i} diverged direct vs composed region"
    assert len(t_one[-1]) == 8


def test_shards_one_is_explicit_single_shard_mesh(gnb_checkpoints,
                                                  monkeypatch):
    """--shards 1 builds the SHARDED engine on a one-shard mesh (the real
    visible devices: the CPU's one) and prints what the un-sharded serve
    prints; --shards 0 builds none."""
    built = []
    orig = ts.ShardedFlowEngine

    class Spy(orig):
        def __init__(self, mesh, *a, **kw):
            built.append(mesh)
            super().__init__(mesh, *a, **kw)

    monkeypatch.setattr(ts, "ShardedFlowEngine", Spy)
    common = _port_args(gnb_checkpoints[1]) + ["--pipeline", "off"]
    single, _, _ = _serve(cli.main, common)
    assert not built
    one_shard, _, _ = _serve(cli.main, common + ["--shards", "1"])
    assert len(built) == 1
    assert built[0].shape[meshlib.DATA_AXIS] == 1
    assert one_shard == single


def _archive(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_archive(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_sharded_serve_checkpoints_write_and_restore(
        gnb_checkpoints, eight_shards, tmp_path):
    """Snapshots of the sharded serve never perturb its render; the
    rotation restores sharded→sharded and sharded→single through the CLI,
    and a single-device checkpoint restores into the sharded serve."""
    tdir = gnb_checkpoints[1]
    rot = str(tmp_path / "rotation")
    common = _port_args(tdir) + ["--shards", "8", "--pipeline", "off"]
    baseline, _, _ = _serve(cli.main, common)
    saved, _, _ = _serve(cli.main, common + [
        "--serve-checkpoint-every", "3", "--serve-checkpoint-dir", rot,
        "--serve-checkpoint-budget", "0"])
    assert saved == baseline
    assert sc.list_checkpoints(rot)
    restored, err, summary = _serve(cli.main, common + [
        "--restore-serve-state", rot])
    assert "Flow ID" in restored
    assert "restored 16 tracked flows" in err
    assert isinstance(summary.engine, ts.ShardedFlowEngine)
    crossed, err, summary = _serve(cli.main, _port_args(tdir) + [
        "--pipeline", "off", "--restore-serve-state", rot])
    assert "Flow ID" in crossed and "restored 16 tracked flows" in err
    assert not isinstance(summary.engine, ts.ShardedFlowEngine)
    single_rot = str(tmp_path / "single")
    _serve(cli.main, _port_args(tdir) + [
        "--pipeline", "off", "--serve-checkpoint-every", "3",
        "--serve-checkpoint-dir", single_rot,
        "--serve-checkpoint-budget", "0"])
    _, err, summary = _serve(cli.main, common + [
        "--restore-serve-state", single_rot])
    assert "restored 16 tracked flows" in err
    assert summary.engine.n_shards == 8


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sharded_checkpoint_restores_across_packages(
        gnb_checkpoints, eight_shards, tmp_path, writer):
    """A checkpoint written by a sharded serve of either package restores
    into the port's sharded engine and its single-device engine, and into
    the JAX package's sharded engine; each re-saves the file's content key
    for key: the table leaves and the index are bitwise equal."""
    jdir, tdir = gnb_checkpoints
    path = str(tmp_path / "sharded.npz")
    if writer == "jax":
        _serve(jcli.main, _composed_args(jdir) + [
            "--shards", "8", "--pipeline", "off",
            "--save-serve-state", path])
    else:
        _serve(cli.main, _port_args(tdir) + [
            "--shards", "8", "--pipeline", "off",
            "--save-serve-state", path])
    want = _archive(path)
    assert int(want["index/slots"].size) == 16
    mesh = meshlib.make_mesh(devices=["cpu"] * 8)
    sharded = sc.restore_sharded(path, mesh, predict_fn=_label_fn,
                                 table_rows=8, incremental=True)
    single = sc.restore(path, device="cpu")
    jeng = jsc.restore_sharded(path, jmeshlib.make_mesh(), table_rows=8)
    for name, save in (("sharded", sc.save), ("single", sc.save),
                       ("jax", jsc.save)):
        eng = {"sharded": sharded, "single": single, "jax": jeng}[name]
        out = str(tmp_path / f"{name}.npz")
        save(eng, out)
        _same_archive(_archive(out), want)
    # the restored shards hold the global rows at their interleaved homes
    g = np.asarray(want["table/fwd.delta_bytes"])[:64]
    for s, t in enumerate(sharded.tables):
        np.testing.assert_array_equal(
            t.fwd.delta_bytes[:-1].numpy(), g[s::8].astype(np.int32))
    rows, _ = sharded.tick_render(now=sharded.last_time, idle_seconds=None)
    assert len(rows) == 8


def _drive_tier(tier, eng, gen, ticks):
    evicted = {}
    for _ in range(ticks):
        batch = next(gen, None)
        if batch is None:
            break
        eng.mark_tick()
        if isinstance(batch, fanin.RawTick):
            for sid, data in batch:
                eng.ingest_bytes(data, sid)
        else:
            eng.ingest(batch)
        eng.step()
        for sid in tier.take_evictions():
            evicted[sid] = eng.evict_source(sid)
    return evicted


@pytest.mark.parametrize("native", NATIVE)
def test_kill_one_of_three_sharded_evicts_only_its_namespace(native):
    """A dead source's quarantine evicts exactly its own namespace from
    the sharded table, whose global slots interleave over all 8 shards;
    the survivors' slots and rows are untouched."""
    mesh = meshlib.make_mesh(devices=["cpu"] * 8)
    specs = [
        fanin.SourceSpec(kind="synthetic", sid=i, n_flows=4, seed=i,
                         mac_base=i * 4, lockstep=True)
        for i in range(3)
    ]
    tier = fanin.FanInIngest(specs, quarantine_s=0.1, raw=native)
    eng = ts.ShardedFlowEngine(mesh, 64, predict_fn=_label_fn, params=None,
                               table_rows=8, native=native)
    gen = tier.ticks(tick_timeout=5.0)
    try:
        _drive_tier(tier, eng, gen, 3)
        assert eng.num_flows() == 12
        before = {sid: sorted(eng.slots_for_source(sid).tolist())
                  for sid in range(3)}
        assert all(len(s) == 4 for s in before.values())
        assert len({g % 8 for s in before.values() for g in s}) > 1
        tier.kill_source(1)
        evicted = {}
        deadline = time.monotonic() + 20.0
        while not evicted and time.monotonic() < deadline:
            evicted.update(_drive_tier(tier, eng, gen, 1))
        assert evicted == {1: 4}
        assert eng.slots_for_source(1).tolist() == []
        assert sorted(eng.slots_for_source(0).tolist()) == before[0]
        assert sorted(eng.slots_for_source(2).tolist()) == before[2]
        assert eng.num_flows() == 8
        rows, _ = eng.tick_render(now=eng.last_time, idle_seconds=None)
        assert {s for s, *_ in rows} == set(before[0] + before[2])
    finally:
        gen.close()


def _teacher(X):
    return (np.asarray(X)[:, 0] > 500.0).astype(np.int32)


def _batch(lo, hi, n=16, seed=0):
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 12), np.float32)
    X[: n // 2, 0] = lo * (1 + 0.01 * rng.rand(n // 2))
    X[n // 2:, 0] = hi * (1 + 0.01 * rng.rand(n - n // 2))
    X[:, 1] = 1.0
    return X


def test_sharded_drift_promotion_installs_through_engine(tmp_path):
    """Shifted captures trip the monitor, the retrained candidate passes
    its parity probes and installs through ShardedDriftGate →
    engine.install_predict, and the engine's REBUILT read steps serve the
    promoted model's labels on the next render."""
    boot = interop.gnb_params_from_numpy({
        "theta": np.asarray([[10.0] * 12, [1000.0] * 12]),
        "var": np.ones((2, 12)), "class_prior": np.full(2, 0.5),
    }, "cpu")
    boot_fn, boot_p = default_build_serving("gnb", ("ping", "voice"))(boot)
    mesh = meshlib.make_mesh(devices=["cpu"] * 8)
    eng = ts.ShardedFlowEngine(mesh, 64, predict_fn=boot_fn, params=boot_p,
                               table_rows=8, incremental=True)
    gate = ShardedDriftGate(eng)
    ctl = DriftController(
        gate, family="gnb", classes=("ping", "voice"),
        directory=str(tmp_path / "drift"),
        window=3, threshold=3.0, trips=2, calibration_windows=2,
        probe_successes=2, min_retrain_rows=16, boot_params=boot,
        device="cpu",
    )
    try:
        i = 0
        while ctl.state != PROMOTED and i < 200:
            i += 1
            lo, hi = (100.0, 10000.0) if i > 12 else (10.0, 1000.0)
            X = _batch(lo, hi, seed=i)
            gate.feed_capture(X, _teacher(X))
            ctl.poll()
            if ctl.state == RETRAINING:
                deadline = time.monotonic() + 90.0
                while ctl._retrainer.poll() == retrain.RUNNING:
                    assert time.monotonic() < deadline
                    time.sleep(0.05)
        assert ctl.state == PROMOTED
        assert gate.swapped
        assert eng.params is not boot_p  # the candidate really installed
        assert all(p is eng.params for p in eng._shard_params)
        assert all(d.all() for d in eng.dirty)  # caches reset all-dirty
        for t in (1, 2):
            eng.mark_tick()
            eng.ingest([
                TelemetryRecord(
                    time=t, datapath="1", in_port=1,
                    eth_src=f"s{i:02x}", eth_dst=f"d{i:02x}",
                    out_port=2, packets=10 * t, bytes=1000 * t + i,
                )
                for i in range(12)
            ])
            eng.step()
        rows, _ = eng.tick_render(now=eng.last_time, idle_seconds=None)
        assert rows
        X = eng.feature_sample([s for s, *_ in rows])
        want = eng._predict_fn(eng.params, torch.from_numpy(X)).numpy()
        np.testing.assert_array_equal(
            np.asarray([c for _, c, *_ in rows]), want)
    finally:
        ctl.close()


def test_sharded_cli_drift_rides_the_sharded_gate(gnb_checkpoints,
                                                  eight_shards, tmp_path):
    """``--drift auto`` on a sharded serve builds its ShardedDriftGate,
    observes every render, and without drift prints what ``--drift off``
    prints."""
    common = _port_args(gnb_checkpoints[1]) + ["--shards", "8",
                                               "--pipeline", "on"]
    off, _, _ = _serve(cli.main, common)
    on, _, summary = _serve(cli.main, common + [
        "--drift", "auto", "--drift-dir", str(tmp_path / "d")])
    assert on == off
    assert summary.drift is not None and not summary.drift["swapped"]
    assert summary.drift["windows"] >= 0


def test_sharded_scatter_warm_covers_varied_wire_buckets():
    """``warmup_serving`` on the sharded spine runs the scatter at every
    plausible wire bucket and the incremental read step at every dirty
    bucket, on scratch state: the engine's own tables stay empty."""
    from traffic_classifier_sdn_tpu_torch.serving.warmup import (
        warmup_serving,
    )

    mesh = meshlib.make_mesh(devices=["cpu"] * 8)
    eng = ts.ShardedFlowEngine(mesh, 4096, predict_fn=_label_fn,
                               params=None, table_rows=16, incremental=True)
    stats = warmup_serving(eng, _label_fn, None, table_rows=16,
                           incremental=True)
    w = stats["warmed"]
    assert w[0] == "sharded.tick_read"
    assert [x for x in w if x.startswith("sharded.apply_dirty[")] == [
        "sharded.apply_dirty[256]", "sharded.apply_dirty[1024]"]
    assert [x for x in w if x.startswith("sharded.dirty[")] == [
        f"sharded.dirty[{b}]" for b in (16, 64, 256, 512)]
    assert eng.num_flows() == 0
    assert not any(bool(t.in_use.any()) for t in eng.tables)
    single = FlowStateEngine(4096, device="cpu")
    for churn in (0.01, 0.3, 1.0, 0.05):
        for e in (eng, single):
            e.mark_tick()
            e.ingest(SyntheticFlows(1500, seed=3, churn=churn).tick())
            e.step()
        rows, _ = eng.tick_render(now=eng.last_time, idle_seconds=3600)
        assert rows == single.render_sample(
            _label_fn(None, ft.features12(single.table)), 16)


@pytest.mark.parametrize("flags,message", [
    (["--shards", "2"], "--shards 2 needs 2 visible devices (have 1)"),
    (["--shards", "2", "--latency-provenance", "on"],
     "--latency-provenance on is single-device"),
    (["--shards", "2", "--actuation", "dry-run", "--policy", "ping=drop"],
     "--actuation is single-device"),
    (["--shards", "1", "--table-rows", "0"],
     "--shards requires a bounded --table-rows"),
])
def test_sharded_refusals_carry_the_jax_text(gnb_checkpoints, flags,
                                             message):
    """JAX's refusals, with its text, before any serve starts; --shards 2
    on the CPU's one visible device is refused, never served another
    way."""
    with pytest.raises(SystemExit) as ei:
        _serve(cli.main, _port_args(gnb_checkpoints[1]) + flags)
    assert str(ei.value.code).startswith(message)


def test_sharded_refuses_host_native_kernels(tmp_path, monkeypatch):
    import chip_smoke

    X = np.abs(np.random.RandomState(0).gamma(1, 100, (200, 12)))
    d = chip_smoke.random_forest(0, X.astype(np.float32), n_trees=2)
    tck.save_model(str(tmp_path / "f"), "forest",
                   interop.forest_params_from_numpy(d, device="cpu"),
                   classes=("a", "b", "c", "d", "e", "f"))
    monkeypatch.setenv("TCSDN_FOREST_KERNEL", "native")
    if not __import__(
            "traffic_classifier_sdn_tpu_torch.native.forest",
            fromlist=["available"]).available():
        pytest.skip("the C++ forest does not build")
    with pytest.raises(SystemExit) as ei:
        _serve(cli.main, ["Randomforest", "--native-checkpoint",
                          str(tmp_path / "f"), "--source", "synthetic",
                          "--device", "cpu", "--shards", "1"])
    assert "host-native kernels" in str(ei.value.code)


def test_sharded_serve_has_no_fallback(gnb_checkpoints, eight_shards,
                                       monkeypatch):
    """A predict that fails inside a shard's read step ends the serve
    with its error: the sharded spine has no degrade ladder and no other
    path to serve on."""
    from traffic_classifier_sdn_tpu_torch import models

    def broken(_params, X):
        raise RuntimeError("kernel fault in shard")

    monkeypatch.setattr(models, "module_predict", broken)
    for pipeline in ("off", "on"):
        with pytest.raises(RuntimeError, match="kernel fault in shard"):
            _serve(cli.main, _port_args(gnb_checkpoints[1]) + [
                "--shards", "8", "--pipeline", pipeline])
