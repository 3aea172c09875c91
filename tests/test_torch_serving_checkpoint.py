"""Serving-state checkpoints of the port (io/serving_checkpoint.py) held
against the JAX package's.

- **One format.** The same telemetry through the port's engine and the
  JAX engine saves to archives whose entries are equal key for key, dtype
  for dtype and bit for bit, for the Python index (BLAKE2b keys) and the
  native index (the C++ engine's fingerprints). A JAX checkpoint restores
  in the port and a port checkpoint in JAX, leaves and index bitwise, and
  both engines then continue identically; a v3 ``feature_reference/``
  block survives a port restore and save.
- **Continuation through both CLIs.** A JAX serve checkpointed at tick 2
  and restored in the port prints, for the rest of the capture, JAX's
  uninterrupted stdout byte for byte; so does the reverse.
- **The durability layer**, mirroring ``tests/test_serving_checkpoint.py``
  on the port: bitwise continuation, freed slots and the LIFO free stack
  across a restore, atomic saves, CRC and truncation errors naming the
  file, rotation with keep-N, ``resolve_latest`` rollback past a torn or
  bit-flipped newest member, missing entries, orphaned temps, the
  interleaved rotation lock, v2 loads and v1 refused as old-format.
"""

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

from test_torch_incremental import N_FLOWS, _capture_and_sample, _checkpoints
from traffic_classifier_sdn_tpu import cli as jcli
from traffic_classifier_sdn_tpu.ingest.batcher import FlowStateEngine as JEngine
from traffic_classifier_sdn_tpu.ingest.protocol import TelemetryRecord as JRecord
from traffic_classifier_sdn_tpu.io import serving_checkpoint as jsc
from traffic_classifier_sdn_tpu_torch import cli as tcli
from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
from traffic_classifier_sdn_tpu_torch.ingest.batcher import FlowStateEngine
from traffic_classifier_sdn_tpu_torch.ingest.protocol import TelemetryRecord
from traffic_classifier_sdn_tpu_torch.io import serving_checkpoint as sc
from traffic_classifier_sdn_tpu_torch.native import engine as native_engine

NATIVE = [False, pytest.param(True, marks=pytest.mark.skipif(
    not native_engine.available(), reason="g++ cannot build the engine"))]


@pytest.fixture(autouse=True, scope="module")
def _default_serving_menus():
    with pytest.MonkeyPatch.context() as mp:
        for var in ("TCSDN_KNN_TOPK", "TCSDN_SVC_KERNEL",
                    "TCSDN_FOREST_KERNEL"):
            mp.delenv(var, raising=False)
        yield


def _recs(R, t, n, base=0, prefix="f"):
    # cumulative counters, like a monitor's 1 Hz poll; every fifth flow's
    # byte counter sits above 2^32, so the *_lo leaves wrap
    return [
        R(time=t, datapath="1", in_port=1, eth_src=f"{prefix}{i:03d}",
          eth_dst="gw", out_port=2, packets=base + 7 * t + i,
          bytes=base + 1000 * t + 13 * i + (1 << 33 if i % 5 == 0 else 0))
        for i in range(n)
    ]


def _tick(eng, t, n, base=0, prefix="f"):
    R = JRecord if isinstance(eng, JEngine) else TelemetryRecord
    eng.mark_tick()
    eng.ingest(_recs(R, t, n, base, prefix))
    eng.step()


def _engine(capacity, native=False):
    return FlowStateEngine(capacity, device="cpu", native=native)


def _leaves(eng) -> dict:
    """Every table leaf of either package as the file's host array."""
    if isinstance(eng, JEngine):
        return {n: np.asarray(jsc._get_leaf(eng.table, n))
                for n in jsc._TABLE_LEAVES}
    return {n: sc._fetch_leaf(eng.table, n) for n in sc._TABLE_LEAVES}


def _assert_same_table(a, b) -> None:
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for name in la:
        assert la[name].dtype == lb[name].dtype, name
        np.testing.assert_array_equal(la[name], lb[name], err_msg=name)


def _archive(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_same_archive(a: dict, b: dict) -> None:
    assert a.keys() == b.keys(), set(a) ^ set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def _drive_both(capacity, native, ticks):
    j = JEngine(capacity, native=native)
    t = _engine(capacity, native)
    for tk, n in ticks:
        _tick(j, tk, n)
        _tick(t, tk, n)
    return j, t


# ---------------------------------------------------------------- one format


@pytest.mark.parametrize("native", NATIVE)
def test_port_save_equals_jax_save(tmp_path, native):
    """The same three ticks (wrapping counters, an eviction round) through
    both packages save to equal archives, entry for entry, bit for bit."""
    j, t = _drive_both(64, native, [(1, 20), (2, 24)])
    for eng in (j, t):
        eng.mark_tick()
        R = JRecord if eng is j else TelemetryRecord
        eng.ingest(_recs(R, 60, 10))
        eng.step()
        assert eng.evict_idle(now=60, idle_seconds=30) == 14
    jsc.save(j, str(tmp_path / "jax.npz"))
    sc.save(t, str(tmp_path / "port.npz"))
    a, b = _archive(tmp_path / "jax.npz"), _archive(tmp_path / "port.npz")
    _assert_same_archive(a, b)
    assert a["format_version"] == sc.FORMAT_VERSION == jsc.FORMAT_VERSION
    assert a["table/fwd.bytes_lo"].dtype == np.uint32
    assert int(a["native"]) == native and a["index/free"].size == 14


@pytest.mark.parametrize("native", NATIVE)
def test_jax_checkpoint_restores_in_port(tmp_path, native):
    """A JAX checkpoint restores in the port with every leaf and the whole
    index bitwise (re-saved, the archive is JAX's), and both engines then
    continue identically: existing flows keep their slots, new ones take
    the same free slots."""
    j, _ = _drive_both(64, native, [(1, 20), (2, 20)])
    path = str(tmp_path / "jax.npz")
    jsc.save(j, path)
    r = sc.restore(path, device="cpu")
    assert r.native == native and r.device.type == "cpu"
    _assert_same_table(r, j)
    assert r.num_flows() == j.num_flows() == 20
    assert r.last_time == j.last_time and r.tick_floor == j._tick_floor
    sc.save(r, str(tmp_path / "again.npz"))
    _assert_same_archive(_archive(path), _archive(tmp_path / "again.npz"))
    for eng in (j, r):
        _tick(eng, 3, 24)
        assert eng.evict_idle(now=100, idle_seconds=50) == 24
        _tick(eng, 101, 5, prefix="n")
    _assert_same_table(r, j)
    assert r.slot_metadata(slots=range(64)) == j.slot_metadata(
        slots=range(64))


@pytest.mark.parametrize("native", NATIVE)
def test_port_checkpoint_restores_in_jax(tmp_path, native):
    """The reverse: the port's checkpoint restores in the JAX package and
    the two continue identically."""
    _, t = _drive_both(64, native, [(1, 20), (2, 20)])
    path = str(tmp_path / "port.npz")
    sc.save(t, path)
    r = jsc.restore(path)
    assert r.native == native
    _assert_same_table(r, t)
    assert r.num_flows() == t.num_flows() == 20
    for eng in (t, r):
        _tick(eng, 3, 24)
    _assert_same_table(r, t)
    assert r.slot_metadata(slots=range(64)) == t.slot_metadata(
        slots=range(64))


def test_feature_reference_block_survives_port_restore_and_save(tmp_path):
    """A JAX v3 checkpoint with a ``feature_reference/`` block: the port
    hands the block back on the engine, writes it again on its next save
    (CRC-covered), and JAX reads it back from the port's file."""
    j, _ = _drive_both(32, False, [(1, 8)])
    ref = {"mean": np.arange(12, dtype=np.float64),
           "class_counts": np.array([3, 0, 5], np.int64)}
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jsc.save(j, jpath, feature_reference=ref)
    r = sc.restore(jpath, device="cpu")
    assert r.feature_reference.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_array_equal(r.feature_reference[k], v)
    sc.save(r, tpath, feature_reference=r.feature_reference)
    _assert_same_archive(_archive(jpath), _archive(tpath))
    back = jsc.restore(tpath)
    for k, v in ref.items():
        np.testing.assert_array_equal(back.feature_reference[k], v)


def test_v2_checkpoint_loads_without_reference(tmp_path):
    """A v2 file (no block; its CRC recomputed) restores, reporting no
    reference."""
    eng = _engine(16)
    _tick(eng, 1, 4)
    path = str(tmp_path / "s.npz")
    sc.save(eng, path)
    z = _archive(path)
    z["format_version"] = np.int64(2)
    z["crc32"] = np.uint32(sc._content_crc(z))
    np.savez_compressed(path, **z)
    r = sc.restore(path, device="cpu")
    assert r.num_flows() == 4 and r.feature_reference is None
    _assert_same_table(r, eng)


# ---------------------------------------------------------------- continuation


def _split_capture(capture: str, tmp_path, upto: int) -> tuple[str, str]:
    """The capture's ticks ``<= upto`` and the rest, as two files."""
    head, tail = tmp_path / "head.capture", tmp_path / "tail.capture"
    lines = open(capture, "rb").read().splitlines(True)
    t = [int(line.split(b"\t")[1]) for line in lines]
    head.write_bytes(b"".join(ln for ln, k in zip(lines, t) if k <= upto))
    tail.write_bytes(b"".join(ln for ln, k in zip(lines, t) if k > upto))
    return str(head), str(tail)


def _out(capsys, main, argv) -> str:
    main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("native", ["on", "off"])
@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_restored_serve_prints_the_uninterrupted_stdout(tmp_path, capsys,
                                                        direction, native):
    """A serve checkpointed at tick 2 (JAX through ``--serve-checkpoint-every
    2``, the port through ``--save-serve-state``, or the reverse) and
    restored in the other package prints ticks 3-6 of the churn capture
    (full, subset and no-dirty renders, an eviction at ``--idle-timeout
    2``) exactly as the uninterrupted JAX serve prints them."""
    if native == "on" and not native_engine.available():
        pytest.skip("g++ cannot build the engine")
    capture, X = _capture_and_sample(tmp_path)
    jdir, tdir = _checkpoints(tmp_path, "Randomforest", X)
    head, tail = _split_capture(capture, tmp_path, 2)
    common = ["Randomforest", "--capacity", str(N_FLOWS), "--print-every",
              "1", "--idle-timeout", "2", "--table-rows", "16",
              "--native-ingest", native, "--pipeline", "off"]
    jax_args = ["--native-checkpoint", jdir]
    port_args = ["--native-checkpoint", tdir, "--device", "cpu"]
    full = _out(capsys, jcli.main, common + jax_args + [
        "--source", "replay", "--capture", capture])
    assert full.count("Flow ID") == 6
    rot = str(tmp_path / "rotation")
    state = str(tmp_path / "state.npz")
    jax_side, port_side = (jcli.main, jax_args), (tcli.main, port_args)
    (save_main, save_args), (restore_main, restore_args) = (
        (jax_side, port_side) if direction == "jax-to-port"
        else (port_side, jax_side))
    save = (["--serve-checkpoint-every", "2", "--serve-checkpoint-dir", rot]
            if direction == "jax-to-port" else ["--save-serve-state", state])
    head_out = _out(capsys, save_main, common + save_args + save + [
        "--source", "replay", "--capture", head])
    restore_from = rot if direction == "jax-to-port" else state
    tail_out = _out(capsys, restore_main, common + restore_args + [
        "--restore-serve-state", restore_from,
        "--source", "replay", "--capture", tail])
    assert head_out.count("Flow ID") == 2
    assert head_out + tail_out == full


def test_port_restore_continues_a_port_rotation_pipelined(tmp_path, capsys):
    """The port's no-flag serve (pipelined, the ladder) checkpoints its own
    rotation every tick; a restart from it prints the rest of the capture
    as the uninterrupted serial serve does (subsequence rule: renders may
    coalesce) and numbers its members above the rotation's."""
    from test_torch_pipeline import assert_subsequence

    capture, X = _capture_and_sample(tmp_path)
    _, tdir = _checkpoints(tmp_path, "Randomforest", X)
    head, tail = _split_capture(capture, tmp_path, 2)
    common = ["Randomforest", "--capacity", str(N_FLOWS), "--print-every",
              "1", "--table-rows", "16", "--native-checkpoint", tdir,
              "--device", "cpu"]
    full = _out(capsys, tcli.main, common + [
        "--pipeline", "off", "--source", "replay", "--capture", capture])
    head_serial = _out(capsys, tcli.main, common + [
        "--pipeline", "off", "--source", "replay", "--capture", head])
    assert full.startswith(head_serial) and head_serial.count("Flow ID") == 2
    rot = str(tmp_path / "rotation")
    # budget 0: a tick here is shorter than a save, so the default guard
    # (0.2 of the loop's time) would skip every save after the first
    every = ["--serve-checkpoint-every", "1", "--serve-checkpoint-dir", rot,
             "--serve-checkpoint-budget", "0"]
    _out(capsys, tcli.main, common + every + [
        "--source", "replay", "--capture", head])
    assert [t for t, _ in sc.list_checkpoints(rot)] == [2, 1]
    summary = tcli.main(common + every + [
        "--restore-serve-state", rot, "--source", "replay",
        "--capture", tail])
    got = capsys.readouterr()
    assert f"restored {N_FLOWS} tracked flows from {rot}" in got.err
    assert_subsequence(got.out, full[len(head_serial):],
                       summary.ticks_coalesced)
    assert [t for t, _ in sc.list_checkpoints(rot)] == [6, 5, 4]


# ---------------------------------------------------------------- durability


@pytest.mark.parametrize("native", NATIVE)
def test_save_restore_continues_bitwise(tmp_path, native):
    path = str(tmp_path / "serve_state.npz")
    a, b = _engine(64, native), _engine(64, native)
    for eng in (a, b):
        _tick(eng, 1, 20)
        _tick(eng, 2, 20)
    sc.save(a, path)
    r = sc.restore(path, device="cpu")
    assert r.native == native
    _assert_same_table(r, a)
    assert r.num_flows() == a.num_flows() == 20
    assert r.last_time == a.last_time
    for eng in (r, b):
        _tick(eng, 3, 24)
    _assert_same_table(r, b)
    assert r.num_flows() == b.num_flows() == 24
    # eviction continuity: the restored clock ages flows identically, and
    # freed slots are reusable
    for eng in (r, b):
        assert eng.evict_idle(now=100, idle_seconds=50) == 24
        _tick(eng, 101, 5, prefix="n")
    _assert_same_table(r, b)
    assert r.num_flows() == 5 and r.dropped == 0


def test_restore_after_partial_eviction_reuses_freed_slots(tmp_path):
    path = str(tmp_path / "s.npz")
    eng = _engine(16)
    _tick(eng, 1, 12)
    eng.mark_tick()
    eng.ingest([
        TelemetryRecord(time=60, datapath="1", in_port=1,
                        eth_src=f"f{i:03d}", eth_dst="gw", out_port=2,
                        packets=1000 + i, bytes=100000 + i)
        for i in range(0, 12, 2)
    ])
    eng.step()
    assert eng.evict_idle(now=60, idle_seconds=30) == 6
    sc.save(eng, path)
    r = sc.restore(path, device="cpu")
    assert r.num_flows() == 6
    _tick(r, 61, 6, prefix="x")  # six new flows must fit in freed slots
    assert r.num_flows() == 12 and r.dropped == 0
    in_use = np.nonzero(r.table.in_use[:-1].numpy())[0]
    assert in_use.max() < 12


@pytest.mark.parametrize("native", NATIVE)
def test_restore_preserves_lifo_free_order(tmp_path, native):
    path = str(tmp_path / "s.npz")
    a, b = _engine(16, native), _engine(16, native)

    def drive(eng):
        _tick(eng, 1, 12)
        for now, keep in ((60, (*range(4), *range(8, 12))),
                          (120, tuple(range(8, 12)))):
            eng.mark_tick()
            eng.ingest([
                TelemetryRecord(time=now, datapath="1", in_port=1,
                                eth_src=f"f{i:03d}", eth_dst="gw",
                                out_port=2, packets=5 * now + i,
                                bytes=500 * now + i)
                for i in keep
            ])
            eng.step()
            assert eng.evict_idle(now=now, idle_seconds=30) == 4

    drive(a)
    drive(b)
    sc.save(a, path)
    r = sc.restore(path, device="cpu")
    for eng in (r, b):
        _tick(eng, 121, 4, prefix="z")
    _assert_same_table(r, b)
    assert r.slot_metadata(slots=range(16)) == b.slot_metadata(
        slots=range(16))


def test_restore_rejects_wrong_format(tmp_path):
    path = str(tmp_path / "s.npz")
    eng = _engine(8)
    _tick(eng, 1, 3)
    sc.save(eng, path)
    z = _archive(path)
    z["format_version"] = np.int64(99)
    np.savez_compressed(path, **z)
    with pytest.raises(ValueError, match="format"):
        sc.restore(path, device="cpu")


def test_save_is_atomic_and_leaves_no_temp(tmp_path):
    path = str(tmp_path / "s.npz")
    eng = _engine(8)
    _tick(eng, 1, 3)
    nbytes = sc.save(eng, path)
    assert nbytes == os.path.getsize(path)
    assert os.listdir(tmp_path) == ["s.npz"]
    sc.validate(path)


def test_restore_rejects_bit_flip_with_clear_error(tmp_path):
    path = str(tmp_path / "s.npz")
    eng = _engine(8)
    _tick(eng, 1, 3)
    sc.save(eng, path)
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0x40
    with open(path, "wb") as f:
        f.write(blob)
    with pytest.raises(sc.CorruptCheckpointError, match="s.npz"):
        sc.restore(path, device="cpu")


def test_content_crc_catches_tampered_member_with_stale_checksum(tmp_path):
    path = str(tmp_path / "s.npz")
    eng = _engine(8)
    _tick(eng, 1, 3)
    sc.save(eng, path)
    z = _archive(path)
    z["last_time"] = np.int64(int(z["last_time"]) + 1)  # stale crc32 kept
    np.savez_compressed(path, **z)
    with pytest.raises(sc.CorruptCheckpointError, match="CRC32"):
        sc.restore(path, device="cpu")


def test_restore_names_file_on_truncated_archive(tmp_path):
    path = str(tmp_path / "s.npz")
    eng = _engine(8)
    _tick(eng, 1, 3)
    sc.save(eng, path)
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])
    with pytest.raises(sc.CorruptCheckpointError, match="s.npz"):
        sc.restore(path, device="cpu")


def test_rotation_keep_n_and_resolve_latest(tmp_path):
    d = str(tmp_path / "rot")
    eng = _engine(16)
    for t in (1, 2, 3, 4, 5):
        _tick(eng, t, 4)
        sc.save_rotating(eng, d, tick=t, keep=2)
    assert sorted(os.listdir(d)) == ["ckpt-000000004.npz",
                                     "ckpt-000000005.npz"]
    assert sc.resolve_latest(d) == sc.checkpoint_path(d, 5)


@pytest.mark.parametrize("damage", ["truncate", "bit-flip"])
def test_resolve_latest_rolls_back_past_corrupt_newest(tmp_path, damage):
    """A torn or bit-flipped newest member rolls back to its predecessor,
    and the directory restore records the rollback."""
    from traffic_classifier_sdn_tpu_torch.obs import FlightRecorder

    d = str(tmp_path / "rot")
    eng = _engine(16)
    _tick(eng, 1, 4)
    sc.save_rotating(eng, d, tick=1, keep=3)
    _tick(eng, 2, 6)
    newest, _ = sc.save_rotating(eng, d, tick=2, keep=3)
    blob = bytearray(open(newest, "rb").read())
    if damage == "truncate":
        blob = blob[: len(blob) // 3]
    else:
        blob[len(blob) // 2] ^= 0x01
    with open(newest, "wb") as f:
        f.write(blob)
    assert sc.resolve_latest(d) == sc.checkpoint_path(d, 1)
    rec = FlightRecorder()
    r = sc.restore(d, device="cpu", recorder=rec)
    assert r.num_flows() == 4
    (rollback,) = [e for e in rec.tail() if e["kind"] == "checkpoint.rollback"]
    assert rollback["rejected"] == newest
    assert rec.tail()[-1]["kind"] == "checkpoint.restore"


def test_restore_missing_entries_clear_error(tmp_path):
    path = str(tmp_path / "s.npz")
    data = {"format_version": np.int64(sc.FORMAT_VERSION)}
    data["crc32"] = np.uint32(sc._content_crc(data))
    np.savez_compressed(path, **data)
    with pytest.raises(sc.CorruptCheckpointError, match="missing"):
        sc.restore(path, device="cpu")


def test_save_rotating_sweeps_orphaned_temps(tmp_path):
    d = tmp_path / "rot"
    d.mkdir()
    (d / ".ckpt-000000001.npz.tmp.12345").write_bytes(b"torn by a kill")
    eng = _engine(8)
    _tick(eng, 1, 3)
    sc.save_rotating(eng, str(d), tick=2, keep=2)
    assert sorted(os.listdir(d)) == ["ckpt-000000002.npz"]


def test_rotation_serializes_concurrent_save_and_prune(tmp_path, monkeypatch):
    """While writer A is mid-save, writer B's whole rotation pass blocks on
    the directory lock; both members commit."""
    d = str(tmp_path / "rot")
    eng_a, eng_b = _engine(16), _engine(16)
    _tick(eng_a, 1, 4)
    _tick(eng_b, 1, 4)
    in_save, release, done_b = (threading.Event(), threading.Event(),
                                threading.Event())
    real_save = sc.save

    def slow_save(engine, path, feature_reference=None):
        if path.endswith("ckpt-000000005.npz"):
            in_save.set()
            assert release.wait(timeout=30)
        return real_save(engine, path, feature_reference)

    monkeypatch.setattr(sc, "save", slow_save)
    results = {}

    def writer_a():
        results["a"] = sc.save_rotating(eng_a, d, tick=5, keep=2)

    def writer_b():
        results["b"] = sc.save_rotating(eng_b, d, tick=6, keep=2)
        done_b.set()

    ta = threading.Thread(target=writer_a, daemon=True)
    ta.start()
    try:
        assert in_save.wait(timeout=30)
        tb = threading.Thread(target=writer_b, daemon=True)
        tb.start()
        assert not done_b.wait(timeout=0.3)
    finally:
        release.set()
    ta.join(timeout=30)
    assert done_b.wait(timeout=30)
    tb.join(timeout=30)
    assert sorted(os.listdir(d)) == ["ckpt-000000005.npz",
                                     "ckpt-000000006.npz"]
    assert sc.resolve_latest(d) == sc.checkpoint_path(d, 6)
    sc.validate(results["a"][0])
    sc.validate(results["b"][0])


def test_v1_checkpoint_reports_old_format_not_corruption(tmp_path):
    path = str(tmp_path / "v1.npz")
    np.savez_compressed(path, format_version=np.int64(1),
                        capacity=np.int64(8))
    with pytest.raises(ValueError, match="format 1") as e:
        sc.validate(path)
    assert not isinstance(e.value, sc.CorruptCheckpointError)
    with pytest.raises(ValueError, match="format 1"):
        sc.restore(path, device="cpu")


def test_resolve_latest_empty_or_missing_dir(tmp_path):
    assert sc.resolve_latest(str(tmp_path)) is None
    assert sc.resolve_latest(str(tmp_path / "nope")) is None
    with pytest.raises(sc.CorruptCheckpointError, match="no valid"):
        sc.restore(str(tmp_path), device="cpu")


def test_restore_rebuilds_the_engine_not_its_staging(tmp_path):
    """What the file does not carry is rebuilt: a restored native engine
    has a fresh wire stage and no flush in flight, the table leaves are
    new tensors of the JAX dtypes' bit patterns (int32 ``*_lo``), and the
    label cache's dirty mask starts all-dirty when asked for."""
    if not native_engine.available():
        pytest.skip("g++ cannot build the engine")
    eng = _engine(32, native=True)
    _tick(eng, 1, 9)
    path = str(tmp_path / "s.npz")
    sc.save(eng, path)
    r = sc.restore(path, device="cpu")
    assert r._staged_flushes == 0 and r.batcher is not eng.batcher
    assert r.table.fwd.bytes_lo.dtype == torch.int32
    for f in dataclasses.fields(ft.DirState):
        assert getattr(r.table.fwd, f.name).dtype == getattr(
            eng.table.fwd, f.name).dtype
    assert r.dirty is None
    r.enable_dirty_tracking()
    assert bool(r.dirty.all())
